/* The fiber runtime of the host emulations of the port's CUDA kernels
   (tests/enum_chunk_host/emulate.cpp, tests/pruner_grad_host/emulate.cpp).

   One fiber per CUDA thread; every block of the grid is resident at once,
   and the fibers run round-robin on one OS thread. A fiber gives up the
   CPU only inside __syncthreads (a barrier of its block), __shfl_sync (a
   barrier of its shuffle segment, with warp-synchronous semantics: each
   thread of the segment deposits its value, then each reads its
   source's) and spin_pause / idle_pause. A waiting fiber counts as no
   progress; an atomic that changes memory counts as progress (see
   cuda_runtime.h). Control flow that is not uniform within a segment is
   reported, not run: a shuffle whose partners called it from different
   source lines, and a thread that leaves while the rest of its segment
   waits in a shuffle (a deadlock). x86-64 only (a small hand-written
   context switch). Include it once, in the emulation's one translation
   unit, after the kernel's source. Test support only. */
#pragma once

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "cuda_runtime.h"

dim3 threadIdx, blockIdx, blockDim;

/* save the callee-saved registers and the stack pointer into *save_sp,
   then resume the context whose stack pointer is load_sp */
extern "C" void emu_switch(void **save_sp, void *load_sp);
asm(R"(
    .text
    .globl emu_switch
    .hidden emu_switch
    .type emu_switch, @function
emu_switch:
    pushq %rbp
    pushq %rbx
    pushq %r12
    pushq %r13
    pushq %r14
    pushq %r15
    movq %rsp, (%rdi)
    movq %rsi, %rsp
    popq %r15
    popq %r14
    popq %r13
    popq %r12
    popq %rbx
    popq %rbp
    ret
    .size emu_switch, .-emu_switch
)");

namespace emu {

constexpr size_t kStack = 128 * 1024;

/* return codes of run() */
enum { kOk = 0, kBadLaunch = 1, kDeadlock = 2, kBadShuffle = 3,
       kDivergent = 4 };

struct Barrier {
  int count = 0;
  unsigned gen = 0;
};

struct Segment : Barrier {
  uint64_t val[32];
  int line[32];
};

struct Fiber {
  void *sp = nullptr;
  char *stack = nullptr;
  unsigned tid = 0, block = 0;
  bool done = false;
};

struct Launch {
  void (*body)(void *) = nullptr;
  void *arg = nullptr;
  int width = 32;  /* threads of a shuffle segment */
  std::vector<Fiber> fibers;
  std::vector<Barrier> blocks;
  std::vector<Segment> segments;
  std::vector<std::vector<double>> smem;
  void *sched_sp = nullptr;
  Fiber *cur = nullptr;
  bool progress = false;
  int error = kOk;
};

inline Launch *L = nullptr;

inline void yield() { emu_switch(&L->cur->sp, L->sched_sp); }

[[noreturn]] inline void fail(int code) {
  L->error = code;
  for (;;) yield();  /* the scheduler stops and never resumes this fiber */
}

inline void wait(Barrier &b, int n) {
  L->progress = true;
  const unsigned gen = b.gen;
  if (++b.count == n) {
    b.count = 0;
    b.gen++;
    return;
  }
  while (b.gen == gen) yield();
}

[[noreturn]] inline void fiber_main() {
  L->body(L->arg);
  L->cur->done = true;
  L->progress = true;
  for (;;) yield();
}

template <typename T>
T shuffle(unsigned mask, T v, int src, int w, int line) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "32- or 64-bit shuffles");
  const unsigned tid = threadIdx.x, block = blockIdx.x;
  const int width = L->width;
  if (w != width) fail(kBadShuffle);
  const unsigned base = tid & 31 & ~unsigned(width - 1);
  const unsigned want =
      width == 32 ? 0xffffffffu : ((1u << width) - 1u) << base;
  if (mask != want) fail(kBadShuffle);
  Segment &s = L->segments[block * (blockDim.x / width) + tid / width];
  std::memcpy(&s.val[tid % width], &v, sizeof(T));
  s.line[tid % width] = line;
  wait(s, width);
  for (int i = 0; i < width; i++)
    if (s.line[i] != line) fail(kDivergent);
  T r;
  std::memcpy(&r, &s.val[src & (width - 1)], sizeof(T));
  wait(s, width);  /* nobody deposits the next value before all have read */
  return r;
}

/* One emulated launch of body(arg) over `grid` blocks of `threads`
   threads, shuffle segments of `width` threads, `smem_bytes` of dynamic
   shared memory per block. Returns kOk or one of the codes above. */
inline int run(int grid, int threads, int width, size_t smem_bytes,
               void (*body)(void *), void *arg) {
  if (grid < 1 || threads < width || threads % 32 || threads > 1024)
    return kBadLaunch;
  Launch l;
  l.body = body;
  l.arg = arg;
  l.width = width;
  blockDim.x = threads;
  l.blocks.resize(grid);
  l.segments.resize((size_t)grid * (threads / width));
  l.smem.assign(grid, std::vector<double>(smem_bytes / 8 + 1));
  l.fibers.resize((size_t)grid * threads);
  for (int b = 0; b < grid; b++)
    for (int t = 0; t < threads; t++) {
      Fiber &f = l.fibers[(size_t)b * threads + t];
      f.block = b;
      f.tid = t;
      f.stack = static_cast<char *>(std::malloc(kStack));
      void **sp = reinterpret_cast<void **>(
          reinterpret_cast<uintptr_t>(f.stack + kStack) & ~uintptr_t(15));
      *--sp = nullptr;                       /* fiber_main never returns */
      *--sp = reinterpret_cast<void *>(&fiber_main);
      for (int r = 0; r < 6; r++) *--sp = nullptr;  /* rbp rbx r12-r15 */
      f.sp = sp;
    }
  L = &l;
  for (;;) {
    bool live = false;
    l.progress = false;
    for (Fiber &f : l.fibers) {
      if (f.done) continue;
      live = true;
      l.cur = &f;
      threadIdx.x = f.tid;
      blockIdx.x = f.block;
      emu_switch(&l.sched_sp, f.sp);
      if (l.error != kOk) break;
    }
    if (l.error != kOk || !live) break;
    if (!l.progress) {
      l.error = kDeadlock;
      break;
    }
  }
  L = nullptr;
  for (Fiber &f : l.fibers) std::free(f.stack);
  return l.error;
}

}  // namespace emu

void *dynamic_smem() { return emu::L->smem[blockIdx.x].data(); }
void spin_pause() { emu::yield(); }
void idle_pause(unsigned &) { emu::yield(); }
void emu_progress() { emu::L->progress = true; }
void __syncthreads() {
  emu::wait(emu::L->blocks[blockIdx.x], (int)blockDim.x);
}
float emu_shfl(unsigned mask, float v, int src, int width, int line) {
  return emu::shuffle(mask, v, src, width, line);
}
int emu_shfl(unsigned mask, int v, int src, int width, int line) {
  return emu::shuffle(mask, v, src, width, line);
}
double emu_shfl(unsigned mask, double v, int src, int width, int line) {
  return emu::shuffle(mask, v, src, width, line);
}
