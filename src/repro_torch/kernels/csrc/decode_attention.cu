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
// 3.35 TB/s.
//
// What the design does about it:
// * Split-KV.  The TPU grid (B, Hk, nk) walks the cache in order per
//   (batch, kv head).  A (B, Hk) grid is only 128 CTAs at granite widths,
//   fewer than the 132 SMs, and one CTA per SM cannot keep enough bytes in
//   flight.  The grid here is (nsplit, Hk * groups, B): each CTA walks its
//   share of block_k-row tiles and writes a partial (m, l, acc) in fp32 to
//   a workspace, and da_combine merges the splits.  The caller derives
//   nsplit from the shape and the SM count so that the grid holds several
//   CTAs per SM.
// * Loads in flight while the CTA computes.  k and v tiles are staged in
//   shared memory in the input's dtype by 16-byte cp.async copies,
//   neighbouring threads on neighbouring 16-byte pieces of a row.  The next
//   k tile is requested as soon as this tile's scores are taken, the next
//   v tile as soon as its products are done.
// * Scores: one thread per cache row, read as 16-byte pieces (XOR-swizzled
//   in shared memory, so the eight threads of a quarter warp hit distinct
//   banks), q broadcast from shared memory in fp32.  Values: one thread per
//   (head-dim column, row group), the group's accumulators in registers.
//   All products are fp32 FMA on the CUDA cores (no TF32).
// * A partial last tile is masked in place: rows past the length are
//   neither loaded nor read, and splits wholly past it load nothing.
// * A group of more than 8 query heads is cut into pieces of 8 (one CTA
//   each); a group of 3, 5, 6 or 7 is padded to the next power of two
//   with zero query rows that are never written out.
// wgmma, TMA and the tuning of nsplit are left for later work.

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most one committed group of this thread is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// a 16-byte piece of a row as fp32: four floats, or eight bf16 (element 0
// in the low half of the first word)
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[8]) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
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
    cp_async_wait_one();  // this tile's k has landed (its v may not have)
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
    cp_async_wait_one();  // this tile's v has landed (the next k may not)
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

inline int group_pad(int G) { return G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8; }

template <class T, int GP>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* o, void* ws, int B, int S, int H, int Hk, int hd,
           const long long* st, int bk, int tiles_per_split, int nsplit,
           float softcap, long long smem_bytes, cudaStream_t stream) {
  const Layout L = da_layout(bk, hd, sizeof(T), GP);
  if ((long long)L.total != smem_bytes) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      da_partial<T, GP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (e != cudaSuccess) return (int)e;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const int groups = Hk * ((H / Hk + GP - 1) / GP);
  da_partial<T, GP><<<dim3(nsplit, groups, B), kThreads, L.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<float*>(ws), S, H, Hk, hd, qs, ks, vs, bk, tiles_per_split,
      nsplit, softcap, 1.0f / sqrtf((float)hd));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  da_combine<T, GP><<<dim3(groups, B), kThreads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<T*>(o), H, Hk, hd, os,
      nsplit);
  return (int)cudaGetLastError();
}

template <class T>
int dispatch(int gp, const void* q, const void* k, const void* v,
             const void* lengths, void* o, void* ws, int B, int S, int H,
             int Hk, int hd, const long long* st, int bk, int tps, int nsplit,
             float softcap, long long smem, cudaStream_t s) {
  switch (gp) {
    case 1:
      return launch<T, 1>(q, k, v, lengths, o, ws, B, S, H, Hk, hd, st, bk,
                          tps, nsplit, softcap, smem, s);
    case 2:
      return launch<T, 2>(q, k, v, lengths, o, ws, B, S, H, Hk, hd, st, bk,
                          tps, nsplit, softcap, smem, s);
    case 4:
      return launch<T, 4>(q, k, v, lengths, o, ws, B, S, H, Hk, hd, st, bk,
                          tps, nsplit, softcap, smem, s);
    default:
      return launch<T, 8>(q, k, v, lengths, o, ws, B, S, H, Hk, hd, st, bk,
                          tps, nsplit, softcap, smem, s);
  }
}

}  // namespace
}  // namespace repro_torch

// q: (B, H, hd); k, v: (B, S, Hk, hd); lengths: (B,) int32; o: (B, H, hd).
// q, k, v, o of one dtype with the last axis contiguous; k and v rows 16-byte
// aligned.  strides: 12 element strides, (batch, head, 1) for q, (batch,
// sequence, head) for k and v, (batch, head, 1) for o.  ws: fp32 workspace
// of B * Hk * pieces * nsplit * gp * (hd + 2) floats, where gp is
// G = H / Hk rounded up to 1, 2, 4 or 8 and pieces =
// ceil(G / gp).  The splits of tiles_per_split tiles of block_k rows must
// cover S.  softcap <= 0 means none.  smem_bytes is the caller's footprint
// figure and must equal this file's.  Returns a cudaError_t code (0 on
// success).
extern "C" int da_forward(const void* q, const void* k, const void* v,
                          const void* lengths, void* o, void* ws, int dtype,
                          int B, int S, int H, int Hk, int hd,
                          const long long* strides, int bk,
                          int tiles_per_split, int nsplit, float softcap,
                          long long smem_bytes, void* stream) {
  using namespace repro_torch;
  const int esize = dtype == kBFloat16 ? 2 : 4;
  if (Hk < 1 || H % Hk != 0 || hd < 1 || hd > kThreads ||
      (hd * esize) % 16 != 0 || bk < 1 || nsplit < 1 ||
      (long long)nsplit * tiles_per_split * bk < S)
    return (int)cudaErrorInvalidValue;
  const int gp = group_pad(H / Hk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch<float>(gp, q, k, v, lengths, o, ws, B, S, H, Hk, hd,
                             strides, bk, tiles_per_split, nsplit, softcap,
                             smem_bytes, s);
    case kBFloat16:
      return dispatch<__nv_bfloat16>(gp, q, k, v, lengths, o, ws, B, S, H,
                                     Hk, hd, strides, bk, tiles_per_split,
                                     nsplit, softcap, smem_bytes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* da_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
