/* Host stand-in for the CUDA runtime header: just enough of the device
   language (qualifiers, thread indices, atomics, warp shuffles,
   round-to-nearest intrinsics) for a host C++ compiler to build the
   device code of fplll_tpu_torch/csrc/enum_chunk.cu. emulate.cpp runs it
   with one cooperative fiber per CUDA thread. Test support only. */
#pragma once

#include <cmath>
#include <cstring>

struct dim3 {
  unsigned x = 0, y = 0, z = 0;
};
extern dim3 threadIdx, blockIdx, blockDim;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

void __syncthreads();

/* warp-synchronous exchange among the `width` threads of the caller's
   segment; every thread named in `mask` must reach the same call, which
   the emulation checks by the call's source line */
float emu_shfl(unsigned mask, float v, int src, int width, int line);
int emu_shfl(unsigned mask, int v, int src, int width, int line);
double emu_shfl(unsigned mask, double v, int src, int width, int line);
#define __shfl_sync(mask, v, src, width) \
  emu_shfl(mask, v, src, width, __LINE__)

inline int min(int a, int b) { return a < b ? a : b; }

/* compiled with -ffp-contract=off: every operation rounds on its own */
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline double __dsqrt_rn(double a) { return std::sqrt(a); }

inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
}
inline int __float_as_int(float f) {
  int i;
  std::memcpy(&i, &f, sizeof i);
  return i;
}
inline double __longlong_as_double(long long i) {
  double f;
  std::memcpy(&f, &i, sizeof f);
  return f;
}
inline long long __double_as_longlong(double f) {
  long long i;
  std::memcpy(&i, &f, sizeof i);
  return i;
}

/* all fibers of a launch share one OS thread, and switch only inside
   __syncthreads, __shfl_sync and spin_pause: a read-modify-write cannot
   interleave. One that changes memory counts as progress for the
   emulation's deadlock check (a walker that publishes work and then
   waits has moved the launch on) */
void emu_progress();
template <typename T> inline T emu_store(T *p, T old, T v) {
  if (v != old) {
    *p = v;
    emu_progress();
  }
  return old;
}
template <typename T> inline T atomicAdd(T *p, T v) {
  return emu_store(p, *p, *p + v);
}
template <typename T> inline T atomicMax(T *p, T v) {
  return emu_store(p, *p, *p < v ? v : *p);
}
template <typename T> inline T atomicMin(T *p, T v) {
  return emu_store(p, *p, v < *p ? v : *p);
}
inline int atomicExch(int *p, int v) { return emu_store(p, *p, v); }
template <typename T> inline T atomicCAS(T *p, T cmp, T v) {
  return emu_store(p, *p, *p == cmp ? v : *p);
}
/* one OS thread: every store is visible to the next fiber that runs */
inline void __threadfence() {}
