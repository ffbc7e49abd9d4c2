// Flash attention (prefill) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_kernel at
// :35, wrapper flash_attention at :99, pl.pallas_call at :122): online
// softmax with an fp32 running max, denominator and accumulator; causal
// mask qpos >= kpos aligned at position 0; sliding window; tanh softcap;
// GQA by kv head h / (H / Hk); kv tiles that hold no unmasked key for the
// q tile are skipped; a row with no unmasked key gives zeros.
//
// What bounds it on this card: at the main path's shapes (S = 4096, 32
// heads, head_dim 80, causal) the work is ~86 GFLOP against ~42 MB of q (=
// k = v on the main path) and o, so the ideal kernel is bound by operations
// (bf16 tensor cores).
// This first kernel does every product as fp32 FMA on the CUDA cores (no
// TF32, no tensor cores), so it is bound by the CUDA cores' FMA rate and by
// the shared-memory reads that feed them.
//
// What the design does about it: the TPU grid's sequential kv axis becomes
// a loop inside the CTA, one CTA per (q tile, head, batch).  The q tile, the
// current k and v tiles, the score tile and the output accumulator all live
// in shared memory in fp32, so q, k, v are read from device memory once per
// CTA and tile and the output is written once.  block_q / block_k are the
// CTA's tile sizes, so the autotuner's candidates change what runs; a tile
// whose footprint exceeds the per-block limit is refused before launch.
// Each shared-memory value loaded in the products feeds four FMAs (the 4x4
// micro-tiles of block_product), and the k tile's rows are padded to an odd
// stride so a warp's loads hit distinct banks.  wgmma, TMA and warp
// specialisation are left for later work.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;

// fp32 words of dynamic shared memory per CTA; kernels/flash_attention.py
// smem_bytes() computes the same figure for the autotuner's pruning.
inline size_t fa_smem_floats(int bq, int bk, int hd) {
  return (size_t)bq * hd          // q tile
         + (size_t)bk * (hd + 1)  // k tile, rows padded to an odd stride
         + (size_t)bk * hd        // v tile
         + (size_t)bq * bk        // scores, then probabilities
         + (size_t)bq * hd        // output accumulator
         + 3 * (size_t)bq;        // running max, denominator, rescale
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
              int H, int Hk, int hd, Strides qs, Strides ks, Strides vs,
              Strides os, int bq, int bk, int causal, int window,
              float softcap, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + bq * hd;
  float* Vs = Ks + bk * (hd + 1);
  float* Ss = Vs + bk * hd;
  float* Os = Ss + bq * bk;
  float* m_s = Os + bq * hd;
  float* l_s = m_s + bq;
  float* a_s = l_s + bq;
  const int ks_stride = hd + 1;

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int q_start = blockIdx.x * bq;
  const int q_rows = min(bq, Sq - q_start);

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int idx = threadIdx.x; idx < bq * hd; idx += blockDim.x) {
    const int r = idx / hd, d = idx % hd;
    Qs[idx] = r < q_rows ? to_float(qb[(q_start + r) * qs.s + d]) : 0.f;
    Os[idx] = 0.f;
  }
  for (int r = threadIdx.x; r < bq; r += blockDim.x) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  // kv tiles that can hold an unmasked key for some row of this q tile:
  // nothing past Sk, nothing in the causal future of the last row, nothing
  // before the window of the first row
  int k_end = Sk;
  if (causal) k_end = min(k_end, q_start + q_rows);
  const int k_begin = window > 0 ? max(0, q_start - window + 1) : 0;
  const int t_begin = k_begin / bk;
  const int t_end = (k_end + bk - 1) / bk;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;

  for (int t = t_begin; t < t_end; ++t) {
    const int k_start = t * bk;
    const int k_rows = min(bk, Sk - k_start);
    __syncthreads();  // the previous tile's readers of Ks, Vs, Ss are done
    for (int idx = threadIdx.x; idx < bk * hd; idx += blockDim.x) {
      const int r = idx / hd, d = idx % hd;
      const bool in = r < k_rows;
      Ks[r * ks_stride + d] = in ? to_float(kb[(k_start + r) * ks.s + d]) : 0.f;
      Vs[idx] = in ? to_float(vb[(k_start + r) * vs.s + d]) : 0.f;
    }
    __syncthreads();

    // scores: S = mask(softcap(scale * q k^T))
    block_product(
        bq, bk, hd, [&](int r, int kk) { return Qs[r * hd + kk]; },
        [&](int kk, int c) { return Ks[c * ks_stride + kk]; },
        [&](int r, int c, float acc) {
          float s = acc * scale;
          if (softcap > 0.f) s = softcap * tanhf(s / softcap);
          const int qpos = q_start + r, kpos = k_start + c;
          bool keep = kpos < Sk;
          if (causal) keep = keep && qpos >= kpos;
          if (window > 0) keep = keep && qpos - kpos < window;
          Ss[r * bk + c] = keep ? s : -INFINITY;
        });
    __syncthreads();

    // online softmax, one warp per row.  A masked score is -inf, so a row
    // with nothing unmasked yet keeps m = -inf, p = 0 and l = 0 without
    // ever forming (-inf) - (-inf).
    for (int r = warp; r < bq; r += n_warps) {
      float mx = -INFINITY;
      for (int c = lane; c < bk; c += 32) mx = fmaxf(mx, Ss[r * bk + c]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < bk; c += 32) {
        const float s = Ss[r * bk + c];
        const float p = s == -INFINITY ? 0.f : expf(s - m_new);
        Ss[r * bk + c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = m_prev == -INFINITY ? 0.f : expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // O = O * alpha + P v
    block_product(
        bq, hd, bk, [&](int r, int c) { return Ss[r * bk + c]; },
        [&](int c, int d) { return Vs[c * hd + d]; },
        [&](int r, int d, float acc) {
          Os[r * hd + d] = Os[r * hd + d] * a_s[r] + acc;
        });
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < q_rows * hd; idx += blockDim.x) {
    const int r = idx / hd, d = idx % hd;
    const float l = l_s[r];
    ob[(q_start + r) * os.s + d] = from_float<T>(l == 0.f ? 0.f : Os[idx] / l);
  }
}

template <class T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int Hk, int hd, const long long* st, int bq,
           int bk, int causal, int window, float softcap, size_t smem,
           cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fa_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid((Sq + bq - 1) / bq, H, B);
  fa_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, Hk, hd, qs, ks,
      vs, os, bq, bk, causal, window, softcap, 1.0f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// q: (B, Sq, H, hd); k, v: (B, Sk, Hk, hd); o: (B, Sq, H, hd), all of one
// dtype, last axis contiguous.  strides: 12 element strides, (batch,
// sequence, head) for q, k, v, o in that order.  window <= 0 means none,
// softcap <= 0 means none.  smem_bytes is the caller's footprint figure and
// must equal this file's.  Returns a cudaError_t code (0 on success).
extern "C" int fa_forward(const void* q, const void* k, const void* v,
                          void* o, int dtype, int B, int Sq, int Sk, int H,
                          int Hk, int hd, const long long* strides, int bq,
                          int bk, int causal, int window, float softcap,
                          long long smem_bytes, void* stream) {
  using namespace repro_torch;
  const size_t smem = fa_smem_floats(bq, bk, hd) * sizeof(float);
  if ((long long)smem != smem_bytes || H % Hk != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(q, k, v, o, B, Sq, Sk, H, Hk, hd, strides, bq, bk,
                           causal, window, softcap, smem, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, Hk, hd, strides,
                                   bq, bk, causal, window, softcap, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
