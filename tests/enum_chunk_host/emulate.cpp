/* Runs the device code of fplll_tpu_torch/csrc/enum_chunk.cu on the host:
   one std::thread per CUDA thread, blocks one after another (blocks never
   wait on each other, so any block order is a valid schedule). Built by
   tests/test_torch_enum_kernel.py with g++ -std=c++20 -ffp-contract=off
   and loaded with ctypes through the same parameter struct the CUDA
   launcher takes. Test support only. */
#include <barrier>
#include <thread>
#include <vector>

#include "cuda_runtime.h"
#include "../../fplll_tpu_torch/csrc/enum_chunk.cu"

thread_local dim3 threadIdx, blockIdx;
dim3 blockDim;
float smem[(ENUM_MAXM * (ENUM_MAXM + 1) + 2 * ENUM_MAXM)];
static std::barrier<> *g_barrier = nullptr;

void __syncthreads() { g_barrier->arrive_and_wait(); }

extern "C" int enum_chunk_emulate(const EnumParams *hp, int threads) {
  const EnumParams P = *hp;
  if (P.m < 2 || P.m > ENUM_MAXM || threads < 1 || P.B % threads != 0)
    return 1;
  blockDim.x = threads;
  const int blocks = P.G * (P.B / threads);
  for (int b = 0; b < blocks; b++) {
    std::barrier<> bar(threads);
    g_barrier = &bar;
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; t++)
      pool.emplace_back([&P, b, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        enum_chunk_kernel(P);
      });
    for (auto &th : pool) th.join();
  }
  return 0;
}
