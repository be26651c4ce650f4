/* Runs the device code of fplll_tpu_torch/csrc/pruner_grad.cu on the host,
   on the fiber runtime of tests/enum_chunk_host/fibers.h: one fiber per
   CUDA thread of the kernel's one block (pruner_grad_threads()), the
   block's dynamic shared memory as one buffer.

   Built by tests/test_torch_pruner_kernel.py with g++ -std=c++20
   -ffp-contract=off (so that only the source's own fma() fuses, as under
   nvcc -fmad=false) and -I tests/enum_chunk_host, and loaded with ctypes;
   a second build adds -DPRUNER_GRAD_FULL_HORNER (every Horner over all
   d + 2 coefficients). Test support only. */
#include "cuda_runtime.h"
#include "../../fplll_tpu_torch/csrc/pruner_grad.cu"
#include "fibers.h"

namespace {

void pruner_body(void *arg) {
  pruner_grad_kernel(*static_cast<PrunerGradParams *>(arg));
}

}  // namespace

/* One emulated launch with the CUDA launcher's arguments (no stream).
   Returns 0, or one of fibers.h's codes. */
extern "C" int pruner_grad_emulate(const double *tab, const double *in,
                                   double *out, int d, int prob, double sf,
                                   double dx2, double dxn, double log_sf) {
  if (d < 1 || d > PRUNER_GRAD_MAX_D) return emu::kBadLaunch;
  PrunerGradParams P{tab, in, out, d, prob, sf, dx2, dxn, log_sf};
  return emu::run(1, pruner_grad_threads(), 32,
                  pruner_grad_smem_bytes(d, prob), pruner_body, &P);
}
