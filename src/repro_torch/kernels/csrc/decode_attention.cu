// Decode attention for Hopper, sm_90a: one new token per sequence against
// a KV cache, split over the cache (flash-decoding).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py (_kernel at
// :28, wrapper decode_attention at :75, pl.pallas_call at :100): the
// G = H / Hk query heads of one kv head form a (G, hd) group; scores are
// scaled by 1/sqrt(hd), optionally tanh-softcapped and masked to
// kpos < lengths[b]; the softmax is online, with an fp32 running max,
// denominator and accumulator; the cache is read in one pass; a row with
// length 0 gives zeros.
//
// What bounds it on this card: per kv head it is two matrix-vector
// products, 4·B·H·length·hd FLOP (~1.07 GFLOP at granite-8b widths: 16
// sequences, 32 query heads, 8 kv heads, head_dim 128, 4096 cached tokens)
// against one read of k and v (~268 MB), so it is bound by bytes: ~80 us at
// 3.35 TB/s.  What it needs is enough bytes in flight on every SM, and few
// enough instructions per cache row that the copies, not the SM, set the
// pace.
//
// Two routes behind the one entry point da_forward, chosen by dtype:
//
// * bfloat16: da_mma_kernel, on the tensor cores (mma.sync m16n8k16, bf16
//   operands, fp32 accumulators).  Grid (nsplit, Hk * pieces, B); a CTA of
//   4 warps walks its split's 64-row tiles of k and v.  The G query heads
//   of a kv head are the rows of one m16 A tile (groups of 1-16 share it,
//   the rows past G are zero and never written out; a larger group is cut
//   into pieces of 16), so S = q k^T and P v are flash's inner loop with a
//   16-row query tile: K by ldmatrix, V by ldmatrix.trans, P straight from
//   the score fragments into the A fragment of P v.  A cache row costs a
//   few instructions instead of G * hd FMAs.  Each warp takes 16 rows of
//   every tile, so the warps split the key range between them, each with
//   its own (m, l, acc); they merge in shared memory at the end.
//   Tiles come through a ring of `stages` cp.async stages, refilled one
//   tile ahead of the oldest, so stages - 1 tiles are in flight while one
//   is multiplied, with one barrier per tile.  The autotuner's block_k is
//   the number of cache rows the ring keeps in flight: stages = block_k /
//   64 + 1, at least 3.  The caller picks nsplit so that the grid is at
//   most one wave of resident CTAs (the occupancy da_occupancy reports).
//   With nsplit = 1 the CTA writes o itself and the combine is not
//   launched.  (Folding the combine into the last CTA of each group by an
//   atomic ticket was tried and measured no faster on the card.)
// * float32: da_partial, the SIMT kernel (fp32 FMA on the CUDA cores, one
//   thread per cache row for the scores), which keeps fp32 products and so
//   the fp32 tolerance of the tests; no TF32 and no bf16 product is
//   allowed there.  A group of more than 8 query heads is cut into pieces
//   of 8; a group of 3, 5, 6 or 7 is padded to the next power of two.
//
// With the cache split, both routes write partial (m, l, acc) in fp32 per
// split, and a second launch, da_combine, merges the splits.  A split
// wholly past a row's length writes m = -inf, l = 0, which the merge
// skips, so a row of length 0 gives zeros.  TMA and wgmma (whose M of 64
// is four times the largest group here) are left for later work.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Byte offsets of the dynamic shared memory of one CTA;
// kernels/decode_attention.py smem_bytes() computes the same total for the
// autotuner's pruning.
struct Layout {
  size_t k, v, p, q, red, acc, total;
};

__host__ __device__ inline Layout da_layout(int bk, int hd, int esize,
                                            int gp) {
  Layout L;
  L.k = 0;                                            // k tile, input dtype
  L.v = L.k + align16((size_t)bk * hd * esize);       // v tile, input dtype
  L.p = L.v + align16((size_t)bk * hd * esize);       // scores [bk][gp]
  L.q = L.p + align16((size_t)bk * gp * 4);           // q group [gp][hd]
  L.red = L.q + align16((size_t)gp * hd * 4);         // [2][warps][gp]
  L.acc = L.red + align16((size_t)2 * kWarps * gp * 4);
  L.total = L.acc + (size_t)(kThreads / hd) * gp * hd * 4;  // [rg][gp][hd]
  return L;
}

// a 16-byte piece of a row as four floats
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}

template <int GP>
__device__ __forceinline__ void load_group(const float* src, float (&p)[GP]) {
  if constexpr (GP % 4 == 0) {
#pragma unroll
    for (int i = 0; i < GP / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(src)[i];
      p[4 * i] = x.x;
      p[4 * i + 1] = x.y;
      p[4 * i + 2] = x.z;
      p[4 * i + 3] = x.w;
    }
  } else if constexpr (GP == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    p[0] = x.x;
    p[1] = x.y;
  } else {
    p[0] = src[0];
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One CTA per (split, kv head x group piece, batch row).  Strides for q and
// o are (batch, head, -); for k and v (batch, sequence, head).  The
// workspace holds, per (batch, group piece, split), gp*hd accumulators, then
// gp running maxima, then gp denominators.
template <class T, int GP>
__global__ void __launch_bounds__(kThreads)
    da_partial(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ lengths,
               float* __restrict__ ws, int S, int H, int Hk, int hd,
               Strides qs, Strides ks, Strides vs, int bk, int tiles_per_split,
               int nsplit, float softcap, float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte piece
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = da_layout(bk, hd, sizeof(T), GP);
  T* Ks = reinterpret_cast<T*>(smem + L.k);
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  float* Ps = reinterpret_cast<float*>(smem + L.p);
  float* Qs = reinterpret_cast<float*>(smem + L.q);
  float* red_m = reinterpret_cast<float*>(smem + L.red);
  float* red_l = red_m + kWarps * GP;
  float* Acc = reinterpret_cast<float*>(smem + L.acc);

  const int split = blockIdx.x, b = blockIdx.z;
  const int G = H / Hk;
  const int pieces = (G + GP - 1) / GP;
  const int hk = blockIdx.y / pieces;
  const int g0 = (blockIdx.y % pieces) * GP;
  const int gcount = min(GP, G - g0);
  const int h0 = hk * G + g0;
  const size_t rec = (size_t)GP * (hd + 2);
  float* wrec =
      ws + (((size_t)b * gridDim.y + blockIdx.y) * nsplit + split) * rec;

  // lengths outside [0, S] act as the plain version's mask does
  const int len = min(max(lengths[b], 0), S);
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, (len + bk - 1) / bk);

  if (t_begin >= t_end) {  // nothing of this row lies in the split
    if (threadIdx.x < GP) {
      wrec[GP * hd + threadIdx.x] = -INFINITY;
      wrec[GP * hd + GP + threadIdx.x] = 0.f;
    }
    return;
  }

  const int cpr = hd / VEC;  // 16-byte pieces per row
  const int sw = cpr % 8 == 0 ? 7 : cpr % 4 == 0 ? 3 : cpr % 2 == 0 ? 1 : 0;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  auto load_tile = [&](T* dst, const T* src, long long s_stride, int t,
                       int swz) {
    const int start = t * bk;
    const int rows = min(bk, len - start);
    for (int idx = threadIdx.x; idx < rows * cpr; idx += kThreads) {
      const int r = idx / cpr, c = idx % cpr;
      cp_async16(dst + (size_t)r * hd + (c ^ (r & swz)) * VEC,
                 src + (start + r) * s_stride + c * VEC);
    }
  };

  load_tile(Ks, kb, ks.s, t_begin, sw);
  cp_async_commit();
  load_tile(Vs, vb, vs.s, t_begin, 0);
  cp_async_commit();

  for (int idx = threadIdx.x; idx < GP * hd; idx += kThreads) {
    const int g = idx / hd, d = idx % hd;
    Qs[idx] = g < gcount ? to_float(q[b * qs.b + (h0 + g) * qs.s + d]) : 0.f;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nrg = kThreads / hd;  // row groups of the value product
  const int col = threadIdx.x % hd, rg = threadIdx.x / hd;
  float m_run[GP], l_run[GP], acc[GP];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;
    acc[g] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int rows = min(bk, len - t * bk);
    cp_async_wait<1>();  // this tile's k has landed (its v may not have)
    __syncthreads();

    // scores of this thread's rows: softcap(scale * q k^T)
    float mx[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) mx[g] = -INFINITY;
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      float s[GP];
#pragma unroll
      for (int g = 0; g < GP; ++g) s[g] = 0.f;
      const T* row = Ks + (size_t)r * hd;
      for (int c = 0; c < cpr; ++c) {
        float kf[VEC];
        unpack(*reinterpret_cast<const uint4*>(row + (c ^ (r & sw)) * VEC),
               kf);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          const float4* q4 =
              reinterpret_cast<const float4*>(Qs + g * hd + c * VEC);
#pragma unroll
          for (int e4 = 0; e4 < VEC / 4; ++e4) {
            const float4 qv = q4[e4];
            s[g] = fmaf(qv.x, kf[4 * e4], s[g]);
            s[g] = fmaf(qv.y, kf[4 * e4 + 1], s[g]);
            s[g] = fmaf(qv.z, kf[4 * e4 + 2], s[g]);
            s[g] = fmaf(qv.w, kf[4 * e4 + 3], s[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        float x = s[g] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        Ps[r * GP + g] = x;
        mx[g] = fmaxf(mx[g], x);
      }
    }
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      mx[g] = warp_max(mx[g]);
      if (lane == 0) red_m[warp * GP + g] = mx[g];
    }
    __syncthreads();

    // online softmax; every thread keeps the same running (m, l)
    float m_new[GP], alpha[GP], sum[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      float mt = -INFINITY;
      for (int w = 0; w < kWarps; ++w) mt = fmaxf(mt, red_m[w * GP + g]);
      m_new[g] = fmaxf(m_run[g], mt);  // finite: the tile has a row
      alpha[g] = m_run[g] == -INFINITY ? 0.f : expf(m_run[g] - m_new[g]);
      sum[g] = 0.f;
    }
    for (int r = threadIdx.x; r < rows; r += kThreads) {
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        const float p = expf(Ps[r * GP + g] - m_new[g]);
        Ps[r * GP + g] = p;
        sum[g] += p;
      }
    }
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      sum[g] = warp_sum(sum[g]);
      if (lane == 0) red_l[warp * GP + g] = sum[g];
    }
    __syncthreads();  // every read of the k tile is done

    if (t + 1 < t_end) load_tile(Ks, kb, ks.s, t + 1, sw);
    cp_async_commit();
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      float lt = 0.f;
      for (int w = 0; w < kWarps; ++w) lt += red_l[w * GP + g];
      l_run[g] = l_run[g] * alpha[g] + lt;
      m_run[g] = m_new[g];
    }
    cp_async_wait<1>();  // this tile's v has landed (the next k may not)
    __syncthreads();

    // acc = acc * alpha + p v over this thread's column and row group
    if (rg < nrg) {
#pragma unroll
      for (int g = 0; g < GP; ++g) acc[g] *= alpha[g];
      for (int r = rg; r < rows; r += nrg) {
        const float vv = to_float(Vs[(size_t)r * hd + col]);
        float p[GP];
        load_group<GP>(Ps + r * GP, p);
#pragma unroll
        for (int g = 0; g < GP; ++g) acc[g] = fmaf(p[g], vv, acc[g]);
      }
    }
    __syncthreads();  // every read of the v tile and the scores is done

    if (t + 1 < t_end) load_tile(Vs, vb, vs.s, t + 1, 0);
    cp_async_commit();
  }

  // sum the row groups' accumulators; hand on (m, l) through shared memory
  if (rg < nrg) {
#pragma unroll
    for (int g = 0; g < GP; ++g) Acc[(rg * GP + g) * hd + col] = acc[g];
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      red_m[g] = m_run[g];
      red_l[g] = l_run[g];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < gcount * hd; idx += kThreads) {
    const int g = idx / hd, d = idx % hd;
    float a = 0.f;
    for (int i = 0; i < nrg; ++i) a += Acc[(i * GP + g) * hd + d];
    wrec[g * hd + d] = a;
    if (d == 0) {
      wrec[GP * hd + g] = red_m[g];
      wrec[GP * hd + GP + g] = red_l[g];
    }
  }
}

// Merges the splits of one (kv head x group piece, batch row).  A split
// with m = -inf holds nothing; a row whose splits all hold nothing (length
// 0) gives zeros, never (-inf) - (-inf).
template <class T, int GP>
__global__ void __launch_bounds__(kThreads)
    da_combine(const float* __restrict__ ws, T* __restrict__ o, int H, int Hk,
               int hd, Strides os, int nsplit) {
  const int b = blockIdx.y;
  const int G = H / Hk;
  const int pieces = (G + GP - 1) / GP;
  const int hk = blockIdx.x / pieces;
  const int g0 = (blockIdx.x % pieces) * GP;
  const int gcount = min(GP, G - g0);
  const int h0 = hk * G + g0;
  const size_t rec = (size_t)GP * (hd + 2);
  const float* base =
      ws + ((size_t)b * gridDim.x + blockIdx.x) * nsplit * rec;
  for (int idx = threadIdx.x; idx < gcount * hd; idx += kThreads) {
    const int g = idx / hd, d = idx % hd;
    float M = -INFINITY;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, base[s * rec + GP * hd + g]);
    float num = 0.f, den = 0.f;
    if (M != -INFINITY) {
      for (int s = 0; s < nsplit; ++s) {
        const float* r = base + s * rec;
        const float m = r[GP * hd + g];
        if (m == -INFINITY) continue;
        const float w = expf(m - M);
        num = fmaf(w, r[g * hd + d], num);
        den = fmaf(w, r[GP * hd + GP + g], den);
      }
    }
    o[b * os.b + (h0 + g) * os.s + d] =
        from_float<T>(den == 0.f ? 0.f : num / den);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 route: tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kTileRows = 16 * kMmaWarps;  // cache rows of a ring stage
constexpr int kGroupRows = 16;             // query heads of one m16 tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ring stages for block_k: the ring keeps block_k rows in flight beside the
// stage being multiplied, and has at least 3 stages
inline int mma_stages(int bk) {
  const int n = (bk + kTileRows - 1) / kTileRows + 1;
  return n < 3 ? 3 : n;
}
// bytes of dynamic shared memory per CTA; kernels/decode_attention.py
// smem_bytes() computes the same figure for the autotuner's pruning: the
// query tile and the ring of k and v tiles, bf16 rows padded to hd + 8.
// The warps' merge (fp32 (m, l, acc) of 16 rows each) reuses the ring.
inline size_t da_mma_smem(int bk, int hd) {
  return sizeof(bf16) * (size_t)(hd + 8) *
         (kGroupRows + 2 * (size_t)kTileRows * mma_stages(bk));
}

// One CTA per (split, kv head x group piece, batch row).  With nsplit > 1
// each writes the record da_combine<bf16, 16> merges: 16 * hd
// accumulators, then 16 running maxima (natural-log units), then 16
// denominators.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
    da_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ lengths,
                  bf16* __restrict__ o, float* __restrict__ ws, int S, int H,
                  int Hk, Strides qs, Strides ks, Strides vs, Strides os,
                  int stages, int tiles_per_split, int nsplit,
                  float scale_log2, float cap_log2, float scale_over_cap) {
  static_assert(HD % 16 == 0 && HD <= 256, "head_dim");
  constexpr int kStride = HD + 8;   // shared row, in elements
  constexpr int kChunks = HD / 8;   // 16-byte pieces of a row
  constexpr int kKSteps = HD / 16;  // k16 steps of q k^T
  constexpr int kOTiles = HD / 8;   // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char da_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(da_smem);
  bf16* Ring = Qs + kGroupRows * kStride;  // stage s: K, then V

  const int split = blockIdx.x, b = blockIdx.z;
  const int G = H / Hk;
  const int pieces = (G + kGroupRows - 1) / kGroupRows;
  const int hk = blockIdx.y / pieces;
  const int g0 = (blockIdx.y % pieces) * kGroupRows;
  const int gcount = min(kGroupRows, G - g0);
  const int h0 = hk * G + g0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  float* wrec = ws + (((size_t)b * gridDim.y + blockIdx.y) * nsplit + split) *
                         kGroupRows * (HD + 2);
  bf16* ob = o + b * os.b + h0 * os.s;

  // lengths outside [0, S] act as the plain version's mask does
  const int len = min(max(lengths[b], 0), S);
  const int t_begin = split * tiles_per_split;
  const int t_end =
      min(t_begin + tiles_per_split, (len + kTileRows - 1) / kTileRows);
  const int ntiles = t_end - t_begin;

  if (ntiles <= 0) {  // nothing of this row lies in the split
    if (nsplit == 1) {
      for (int idx = threadIdx.x; idx < gcount * HD; idx += kMmaThreads)
        ob[(idx / HD) * os.s + idx % HD] = __float2bfloat16(0.f);
    } else if (threadIdx.x < kGroupRows) {
      wrec[kGroupRows * HD + threadIdx.x] = -INFINITY;
      wrec[kGroupRows * HD + kGroupRows + threadIdx.x] = 0.f;
    }
    return;
  }

  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  // rows past the length are zero-filled, never read, and masked
  auto load_tile = [&](int t, int st) {
    bf16* Kst = Ring + (size_t)st * 2 * kTileRows * kStride;
    bf16* Vst = Kst + kTileRows * kStride;
    const int r0 = t * kTileRows;
    for (int idx = threadIdx.x; idx < kTileRows * kChunks;
         idx += kMmaThreads) {
      const int r = idx / kChunks, c = idx % kChunks;
      const bool in = r0 + r < len;
      const long long row = in ? r0 + r : 0;
      cp_async16(smem_addr(Kst + r * kStride + c * 8),
                 kb + row * ks.s + c * 8, in);
      cp_async16(smem_addr(Vst + r * kStride + c * 8),
                 vb + row * vs.s + c * 8, in);
    }
  };
  for (int i = 0; i < stages - 1; ++i) {
    if (i < ntiles) load_tile(t_begin + i, i);
    cp_async_commit();
  }
  for (int idx = threadIdx.x; idx < kGroupRows * HD; idx += kMmaThreads) {
    const int r = idx / HD, d = idx % HD;
    Qs[r * kStride + d] = r < gcount ? q[b * qs.b + (h0 + r) * qs.s + d]
                                     : __float2bfloat16(0.f);
  }

  // lane offsets of the ldmatrix row addresses (in elements)
  const int a_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * kStride +
                    8 * (lane >> 4);                    // Q as A
  const int k_off = (16 * warp + (lane & 7) + 8 * (lane >> 4)) * kStride +
                    8 * ((lane >> 3) & 1);              // K as B
  const int v_off = (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                        kStride + 8 * (lane >> 4);      // V as B, transposed
  const unsigned q_base = smem_addr(Qs + a_off);
  // scores times to_log2 are in log2 units: a softcapped score already is
  const float to_log2 = cap_log2 > 0.f ? 1.f : scale_log2;

  float acc[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // running max (log2 units) and this lane's share of the row sum, rows g
  // and g + 8
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

  for (int i = 0; i < ntiles; ++i) {
    // tile i has landed, and every warp is done with tile i - 1's stage,
    // which the next copy refills
    cp_async_wait_dyn(stages - 2);
    __syncthreads();
    const int nx = i + stages - 1;
    if (nx < ntiles) load_tile(t_begin + nx, nx % stages);
    cp_async_commit();

    const int kpos0 = (t_begin + i) * kTileRows + 16 * warp;
    if (kpos0 >= len) continue;  // this warp's 16 rows are all past it
    const bf16* Kst = Ring + (size_t)(i % stages) * 2 * kTileRows * kStride;
    const unsigned k_base = smem_addr(Kst + k_off);
    const unsigned v_base = smem_addr(Kst + kTileRows * kStride + v_off);

    // S = q k^T over this warp's 16 keys (two n8 tiles)
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      unsigned a[4], bf[4];
      ldsm_x4(q_base + kk * 16 * sizeof(bf16), a);
      ldsm_x4(k_base + kk * 16 * sizeof(bf16), bf);
      mma_bf16(s[0], a, bf[0], bf[1]);
      mma_bf16(s[1], a, bf[2], bf[3]);
    }
    if (cap_log2 > 0.f) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = cap_log2 * tanhf(s[j][e] * scale_over_cap);
    }
    if (kpos0 + 16 > len) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kpos0 + 8 * j + 2 * tq + (e & 1) >= len) s[j][e] = -INFINITY;
    }
    // the online softmax of flash's kernel: a row with nothing unmasked
    // yet is shifted by 0, never by (-inf) - (-inf)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float shift[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r] * to_log2);
      shift[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2_approx(m_r[r] - shift[r]);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = exp2_approx(fmaf(s[j][e], to_log2, -shift[e >> 1]));
        s[j][e] = pr;
        l_r[e >> 1] += pr;
      }
    unsigned pa[4];
    pa[0] = pack_bf16(s[0][0], s[0][1]);
    pa[1] = pack_bf16(s[0][2], s[0][3]);
    pa[2] = pack_bf16(s[1][0], s[1][1]);
    pa[3] = pack_bf16(s[1][2], s[1][3]);
#pragma unroll
    for (int n = 0; n < kOTiles; n += 2) {
      unsigned bf[4];
      ldsm_x4_trans(v_base + n * 8 * sizeof(bf16), bf);
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
      acc[n + 1][0] *= alpha[0];
      acc[n + 1][1] *= alpha[0];
      acc[n + 1][2] *= alpha[1];
      acc[n + 1][3] *= alpha[1];
      mma_bf16(acc[n], pa, bf[0], bf[1]);
      mma_bf16(acc[n + 1], pa, bf[2], bf[3]);
    }
  }
  cp_async_wait_all();
  __syncthreads();  // the ring is free: the warps merge in it

  float* Macc = reinterpret_cast<float*>(Ring);  // [warp][16][HD]
  float* Mm = Macc + kMmaWarps * kGroupRows * HD;   // [warp][16]
  float* Ml = Mm + kMmaWarps * kGroupRows;          // [warp][16]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = warp * kGroupRows + g + 8 * r;
#pragma unroll
    for (int n = 0; n < kOTiles; ++n)
      *reinterpret_cast<float2*>(Macc + row * HD + n * 8 + 2 * tq) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
    if (tq == 0) {
      Mm[row] = m_r[r];
      Ml[row] = l;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < gcount * HD; idx += kMmaThreads) {
    const int r = idx / HD, d = idx % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) M = fmaxf(M, Mm[w * kGroupRows + r]);
    float num = 0.f, den = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kMmaWarps; ++w) {
        const float m = Mm[w * kGroupRows + r];
        if (m == -INFINITY) continue;
        const float wt = exp2_approx(m - M);
        num = fmaf(wt, Macc[(w * kGroupRows + r) * HD + d], num);
        den = fmaf(wt, Ml[w * kGroupRows + r], den);
      }
    }
    if (nsplit == 1) {
      ob[r * os.s + d] = __float2bfloat16(den == 0.f ? 0.f : num / den);
    } else {
      wrec[r * HD + d] = num;
      if (d == 0) {
        wrec[kGroupRows * HD + r] = M == -INFINITY ? -INFINITY : M * kLn2;
        wrec[kGroupRows * HD + kGroupRows + r] = den;
      }
    }
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v,
               const void* lengths, void* o, void* ws, int B, int S, int H,
               int Hk, const long long* st, int bk, int tiles_per_split,
               int nsplit, float softcap, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      da_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const int groups = Hk * ((H / Hk + kGroupRows - 1) / kGroupRows);
  const float scale = 1.0f / sqrtf((float)HD);
  da_mma_kernel<HD><<<dim3(nsplit, groups, B), kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(lengths),
      static_cast<bf16*>(o), static_cast<float*>(ws), S, H, Hk, qs, ks, vs,
      os, mma_stages(bk), tiles_per_split, nsplit, scale * kLog2e,
      softcap * kLog2e, softcap > 0.f ? scale / softcap : 0.f);
  e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return (int)e;
  da_combine<bf16, kGroupRows><<<dim3(groups, B), kThreads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<bf16*>(o), H, Hk, HD, os,
      nsplit);
  return (int)cudaGetLastError();
}

// the bf16 kernel instance at head_dim hd (the head_dims the paths and the
// GPU tests use), or nullptr
inline const void* mma_kernel(int hd) {
  switch (hd) {
    case 32: return (const void*)da_mma_kernel<32>;
    case 64: return (const void*)da_mma_kernel<64>;
    case 128: return (const void*)da_mma_kernel<128>;
    case 256: return (const void*)da_mma_kernel<256>;
    default: return nullptr;
  }
}

// ---------------------------------------------------------------------------
// float32 route: launch
// ---------------------------------------------------------------------------

inline int group_pad(int G) { return G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8; }

inline const void* simt_kernel(int gp) {
  switch (gp) {
    case 1: return (const void*)da_partial<float, 1>;
    case 2: return (const void*)da_partial<float, 2>;
    case 4: return (const void*)da_partial<float, 4>;
    default: return (const void*)da_partial<float, 8>;
  }
}

template <int GP>
int launch_simt(const void* q, const void* k, const void* v,
                const void* lengths, void* o, void* ws, int B, int S, int H,
                int Hk, int hd, const long long* st, int bk,
                int tiles_per_split, int nsplit, float softcap, size_t smem,
                cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      da_partial<float, GP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const int groups = Hk * ((H / Hk + GP - 1) / GP);
  da_partial<float, GP><<<dim3(nsplit, groups, B), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(lengths),
      static_cast<float*>(ws), S, H, Hk, hd, qs, ks, vs, bk, tiles_per_split,
      nsplit, softcap, 1.0f / sqrtf((float)hd));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  da_combine<float, GP><<<dim3(groups, B), kThreads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<float*>(o), H, Hk, hd, os,
      nsplit);
  return (int)cudaGetLastError();
}

// Shared memory of one CTA of the launch da_forward makes, or 0 if it
// takes no such launch.
inline size_t footprint(int dtype, int G, int hd, int bk) {
  if (dtype == kBFloat16) return mma_kernel(hd) ? da_mma_smem(bk, hd) : 0;
  if (dtype != kFloat32 || hd > kThreads || hd % 4) return 0;
  return da_layout(bk, hd, sizeof(float), group_pad(G)).total;
}

}  // namespace
}  // namespace repro_torch

// q: (B, H, hd); k, v: (B, S, Hk, hd); lengths: (B,) int32; o: (B, H, hd).
// q, k, v, o of one dtype with the last axis contiguous; k and v rows 16-byte
// aligned.  strides: 12 element strides, (batch, head, 1) for q, (batch,
// sequence, head) for k and v, (batch, head, 1) for o.
//
// bfloat16 takes hd in {32, 64, 128, 256}; the splits of tiles_per_split
// tiles of 64 rows must cover S; block_k sets the ring (stages = block_k /
// 64 + 1, at least 3); ws holds B * Hk * ceil(G / 16) * nsplit * 16 *
// (hd + 2) floats and is not read when nsplit = 1.
// float32 takes hd <= 256 a multiple of 4; the splits of tiles_per_split
// tiles of block_k rows must cover S; ws holds B * Hk * pieces * nsplit *
// gp * (hd + 2) floats, where gp is G = H / Hk rounded up to 1, 2, 4 or 8
// and pieces = ceil(G / gp).
//
// softcap <= 0 means none.  smem_bytes is the caller's footprint figure and
// must equal this file's.  Returns a cudaError_t code (0 on success).
extern "C" int da_forward(const void* q, const void* k, const void* v,
                          const void* lengths, void* o, void* ws, int dtype,
                          int B, int S, int H, int Hk, int hd,
                          const long long* strides, int bk,
                          int tiles_per_split, int nsplit, float softcap,
                          long long smem_bytes, void* stream) {
  using namespace repro_torch;
  if (Hk < 1 || H % Hk != 0 || bk < 1 || nsplit < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = footprint(dtype, H / Hk, hd, bk);
  if (smem == 0 || (long long)smem != smem_bytes)
    return (int)cudaErrorInvalidValue;
  const int rows = dtype == kBFloat16 ? kTileRows : bk;
  if ((long long)nsplit * tiles_per_split * rows < S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    switch (hd) {
#define DA_HD(D)                                                          \
  case D:                                                                 \
    return launch_mma<D>(q, k, v, lengths, o, ws, B, S, H, Hk, strides,   \
                         bk, tiles_per_split, nsplit, softcap, smem, s);
      DA_HD(32) DA_HD(64) DA_HD(128) DA_HD(256)
#undef DA_HD
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (group_pad(H / Hk)) {
#define DA_GP(P)                                                            \
  case P:                                                                   \
    return launch_simt<P>(q, k, v, lengths, o, ws, B, S, H, Hk, hd, strides, \
                          bk, tiles_per_split, nsplit, softcap, smem, s);
    DA_GP(1) DA_GP(2) DA_GP(4)
#undef DA_GP
    default:
      return launch_simt<8>(q, k, v, lengths, o, ws, B, S, H, Hk, hd,
                            strides, bk, tiles_per_split, nsplit, softcap,
                            smem, s);
  }
}

// CTAs of the launch da_forward makes with these arguments that fit one SM
// at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), written to
// *ctas_per_sm.  Returns a cudaError_t code (0 on success).
extern "C" int da_occupancy(int dtype, int H, int Hk, int hd, int bk,
                            long long smem_bytes, int* ctas_per_sm) {
  using namespace repro_torch;
  if (Hk < 1 || H % Hk != 0 || bk < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = footprint(dtype, H / Hk, hd, bk);
  if (smem == 0 || (long long)smem != smem_bytes)
    return (int)cudaErrorInvalidValue;
  const bool mma = dtype == kBFloat16;
  const void* fn = mma ? mma_kernel(hd) : simt_kernel(group_pad(H / Hk));
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, fn, mma ? kMmaThreads : kThreads, smem);
}

extern "C" const char* da_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
