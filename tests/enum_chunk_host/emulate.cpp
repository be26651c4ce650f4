/* Runs the device code of fplll_tpu_torch/csrc/enum_chunk.cu on the host,
   on the fiber runtime of fibers.h.

   One fiber per CUDA thread; every block of the grid is resident at once,
   and the fibers run round-robin on one OS thread. A fiber gives up the
   CPU only inside __syncthreads (a barrier of its block) and __shfl_sync
   (a barrier of its shuffle segment, with warp-synchronous semantics:
   each thread of the segment deposits its value, then each reads its
   source's). So walkers of different blocks interleave at every shuffle.
   A walker waiting for a sub-solution record's lock, for work from a
   donor or for a mailbox to come free (spin_pause) lets the others run,
   and counts as no progress; an atomic that changes memory counts as
   progress. Control flow that is not
   uniform within a walker is reported, not run: a shuffle whose partners called it from different source lines,
   and a thread that leaves while the rest of its segment waits in a
   shuffle (a deadlock). x86-64 only (a small hand-written context
   switch).

   Built by tests/test_torch_enum_kernel.py with g++ -std=c++20
   -ffp-contract=off, once per walker width (-DENUM_WIDTH=8, 16 or 32;
   the source's default is the width the card runs), and loaded with
   ctypes through the same parameter struct the CUDA launcher takes.
   Test support only. */
#include "cuda_runtime.h"
#include "../../fplll_tpu_torch/csrc/enum_chunk.cu"
#include "fibers.h"

namespace {

struct EnumLaunch {
  EnumKernel fn;
  EnumParams P;
};

void enum_body(void *arg) {
  EnumLaunch *l = static_cast<EnumLaunch *>(arg);
  l->fn(l->P);
}

}  // namespace

/* the walker width this build was compiled with */
extern "C" int enum_chunk_emulated_width() { return ENUM_WIDTH; }

/* One emulated launch of the instance for P (its height, problem count,
   element type and walk, enum_walk_of: the extended instance where P.ext
   names it)
   over `grid` blocks of `threads` threads; P.walkers must be grid *
   threads / ENUM_WIDTH, as the CUDA launcher requires. Returns 0, or one of fibers.h's codes. */
extern "C" int enum_chunk_emulate(const EnumParams *hp, int grid,
                                  int threads) {
  EnumLaunch l{nullptr, *hp};
  l.fn = enum_instance(l.P.m, l.P.G_real, l.P.dbl, enum_walk_of(l.P));
  if (!l.fn || threads < ENUM_WIDTH || l.P.G_real < 1 ||
      l.P.G_real > l.P.G || l.P.walkers != grid * (threads / ENUM_WIDTH))
    return emu::kBadLaunch;
  return emu::run(grid, threads, ENUM_WIDTH,
                  enum_smem_bytes(l.P.m, l.P.G_real, l.P.dbl ? 8 : 4),
                  enum_body, &l);
}
