// Shared pieces of the hand-written Hopper kernels: dtype codes, float
// conversion, and the block-wide tile product both kernels are built from.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace repro_torch {

// dtype codes passed from Python (kernels/_build.py DTYPE_CODES)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// one (batch, sequence, head) stride triple in elements; the last axis of
// every operand is contiguous
struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <class T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// C[M x Nc] = sum over k < K of a(r, k) * b(k, c), in fp32 FMA on the CUDA
// cores, spread over the block's threads; epi(r, c, value) consumes each
// result.  Every thread owns strided 4x4 micro-tiles: rows r0 + i*RS and
// columns c0 + j*CS (RS = ceil(M/4), CS = ceil(Nc/4)).  Neighbouring lanes
// of a warp therefore read neighbouring columns of B (distinct shared-memory
// banks when B's row stride is odd or its columns are contiguous) and mostly
// one row of A (a broadcast).  Each operand value loaded from shared memory
// feeds four FMAs.  Ragged rows/columns are clamped for the loads and
// skipped in the epilogue.
template <class LoadA, class LoadB, class Epilogue>
__device__ __forceinline__ void block_product(int M, int Nc, int K, LoadA a,
                                              LoadB b, Epilogue epi) {
  const int RS = (M + 3) / 4, CS = (Nc + 3) / 4;
  for (int t = threadIdx.x; t < RS * CS; t += blockDim.x) {
    const int r0 = t / CS, c0 = t % CS;
    int rr[4], cc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      rr[i] = min(r0 + i * RS, M - 1);
      cc[i] = min(c0 + i * CS, Nc - 1);
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < K; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = a(rr[i], k);
        bv[i] = b(k, cc[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + i * RS;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + j * CS;
        if (c < Nc) epi(r, c, acc[i][j]);
      }
    }
  }
}

}  // namespace repro_torch
