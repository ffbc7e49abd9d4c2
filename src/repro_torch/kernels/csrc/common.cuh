// Shared pieces of the hand-written Hopper kernels: dtype codes, float
// conversion, the block-wide SIMT tile product of the fp32 routes, and the
// cp.async, ldmatrix and mma.sync helpers of the bf16 tensor-core routes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

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

// ---------------------------------------------------------------------------
// bf16 tensor-core helpers (sm_80+ instructions, used on sm_90a)
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16-byte copy to shared memory; with !in, the 16 bytes are zero-filled and
// src is not read
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool in = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  cp_async16(smem_addr(dst), src, true);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }
// the same with N known only at run time (0 <= N <= 8)
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    default: cp_async_wait<8>(); break;
  }
}
// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned addr,
                                              unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 2^x on the MUFU unit, denormals flushed; 2^-inf = 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// two floats as a bf16 pair, lo in the low half (the lower column)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + tq.  A: rows g and
// g + 8, columns 2 tq, 2 tq + 1 and those + 8.  B: column g, rows 2 tq,
// 2 tq + 1 and those + 8.  C: rows g (c0, c1) and g + 8 (c2, c3), columns
// 2 tq, 2 tq + 1.  The C fragments of two neighbouring n8 tiles are the A
// fragment of one k16 step.

}  // namespace repro_torch
