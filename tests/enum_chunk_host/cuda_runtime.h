/* Host stand-in for the CUDA runtime header: just enough of the device
   language (qualifiers, thread indices, atomics, round-to-nearest
   intrinsics) for a host C++ compiler to build the device code of
   fplll_tpu_torch/csrc/enum_chunk.cu. emulate.cpp runs it with one host
   thread per CUDA thread. Test support only. */
#pragma once

#include <cmath>
#include <cstring>

struct dim3 {
  unsigned x = 0, y = 0, z = 0;
};
extern thread_local dim3 threadIdx, blockIdx;
extern dim3 blockDim;

#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(n)

void __syncthreads();

/* compiled with -ffp-contract=off: every operation rounds on its own */
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }

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

#define EMU_SC __ATOMIC_SEQ_CST
template <typename T> inline T atomicAdd(T *p, T v) {
  return __atomic_fetch_add(p, v, EMU_SC);
}
template <typename T> inline T atomicMax(T *p, T v) {
  T old = __atomic_load_n(p, EMU_SC);
  while (old < v &&
         !__atomic_compare_exchange_n(p, &old, v, false, EMU_SC, EMU_SC)) {
  }
  return old;
}
template <typename T> inline T atomicMin(T *p, T v) {
  T old = __atomic_load_n(p, EMU_SC);
  while (old > v &&
         !__atomic_compare_exchange_n(p, &old, v, false, EMU_SC, EMU_SC)) {
  }
  return old;
}
inline int atomicExch(int *p, int v) { return __atomic_exchange_n(p, v, EMU_SC); }
