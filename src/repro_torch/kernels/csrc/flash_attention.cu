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
// k = v on the main path) and o, so it is bound by operations: the bf16
// tensor cores.
//
// Two routes behind the one entry point fa_forward, chosen by dtype:
//
// * bfloat16: fa_mma_kernel, an FA2-style kernel on the tensor cores
//   (mma.sync m16n8k16, bf16 operands, fp32 accumulators).  One CTA per
//   (q tile, head, batch).  At hd <= 80 a warp owns 32 query rows (two m16
//   tiles), so each K and V fragment read from shared memory feeds two
//   MMAs, and reads Q's A fragments from shared memory at each k step (held
//   in registers they push a thread to 255 registers and spill); above,
//   a warp owns 16 rows and, with up to 8 warps and hd <= 128, holds Q in
//   registers for the whole kv loop.  K and V tiles are staged in bf16 in
//   a ring of two stages by 16-byte cp.async copies, tile t+1 in flight
//   while tile t is computed; rows are padded to hd + 8 elements so the 8
//   row addresses of an ldmatrix hit distinct 16-byte bank groups.  K is
//   read as the B operand by ldmatrix, V by ldmatrix.trans.  The score
//   tile stays in registers: softcap and mask are applied there, the row
//   max is reduced across the quad of lanes that share a row, and the scale
//   (folded with log2 e) joins the shift in one FFMA before ex2.approx.  P
//   is rounded to bf16 straight into the A fragment of the PV product (the
//   C layout of two neighbouring n8 tiles is the A layout of one k16 step),
//   so it never touches shared memory.  The mask is applied only on the key
//   steps that cross the causal diagonal, the window's edge or Sk; steps
//   wholly masked for a warp's rows are skipped.  Each lane's share of the
//   row sum is kept apart and reduced across the quad once, in the
//   epilogue.  q tiles are launched from the longest causal row range down.
//   The new rounding against the fp32 plain version is P -> bf16 before PV,
//   as in FA2.
// * float32: fa_kernel, the SIMT kernel (fp32 FMA on the CUDA cores, tiles
//   in fp32 shared memory), which keeps fp32 products and so the fp32
//   tolerance of the tests; no TF32 and no bf16 product is allowed there.
//
// The autotuner's block_q / block_k are the CTA's tiles in both routes; a
// tile whose footprint exceeds the per-block limit is refused before
// launch.  wgmma, TMA and warp specialisation are left for later work.

#include "common.cuh"

namespace repro_torch {
namespace {

// ---------------------------------------------------------------------------
// float32 route: SIMT kernel
// ---------------------------------------------------------------------------

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

int launch_simt(const void* q, const void* k, const void* v, void* o, int B,
                int Sq, int Sk, int H, int Hk, int hd, const long long* st,
                int bq, int bk, int causal, int window, float softcap,
                size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fa_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid((Sq + bq - 1) / bq, H, B);
  fa_kernel<float><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, Hk,
      hd, qs, ks, vs, os, bq, bk, causal, window, softcap,
      1.0f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 route: tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMaxBlockQ = 256;   // query rows of a CTA
constexpr int kQAlign = 32;       // block_q is a multiple of a warp's rows
constexpr int kKeyAlign = 64;     // block_k is a multiple of the widest step
constexpr float kLog2e = 1.4426950408889634f;

// bytes of dynamic shared memory per CTA; kernels/flash_attention.py
// smem_bytes() computes the same figure for the autotuner's pruning: the q
// tile and two stages of k and v tiles, bf16 rows padded to hd + 8
inline size_t fa_mma_smem_bytes(int bq, int bk, int hd) {
  return sizeof(bf16) * (size_t)(hd + 8) * ((size_t)bq + 4 * (size_t)bk);
}

// head_dims up to which a warp takes 32 query rows (two m16 tiles), so
// each K and V fragment read from shared memory feeds two MMAs
constexpr int kPairedHd = 80;

// MT is the m16 tiles of a warp (its rows / 16); MAXW the most warps a
// launch of the instance may have (__launch_bounds__ caps a thread at 255
// registers for 8, at 128 for 16).  A warp of two m16 tiles (8 warps, hd
// <= 80) steps by 64 keys and reads Q from shared memory at each k step:
// beside O's and S's registers, Q's would spill.  A warp of one m16 tile
// with 8 warps up to hd 128 (and at hd <= 32) holds Q in registers and
// steps by 64 keys, which fits 255 registers without spills; otherwise it
// reads Q from shared memory and steps by 32 keys, so the output
// accumulator keeps to registers.
template <int HD, int MT, int MAXW>
struct MmaCfg {
  static_assert(HD % 16 == 0 && HD <= 256, "head_dim");
  static_assert(MT == 1 || (MT == 2 && MAXW == 8 && HD <= kPairedHd),
                "32-row warps are for 8 warps at hd <= 80");
  static constexpr bool kQInRegs =
      MT == 1 && (MAXW == 8 ? HD <= 128 : HD <= 32);
  static constexpr int kN = MT == 2 || kQInRegs ? 64 : 32;  // keys a step
  static constexpr int kRows = 16 * MT;        // query rows of a warp
  static constexpr int kKSteps = HD / 16;      // k16 steps of q k^T
  static constexpr int kSTiles = kN / 8;       // n8 tiles of a score step
  static constexpr int kOTiles = HD / 8;       // n8 tiles of the output
  static constexpr int kStride = HD + 8;       // shared row, in elements
  static constexpr int kChunks = HD / 8;       // 16-byte pieces of a row
  static_assert(kQAlign % kRows == 0, "block_q alignment");
};

// cp.async, ldmatrix, mma.sync and the bf16 packing are in common.cuh.

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + tq.  A: rows g and
// g + 8, columns 2 tq, 2 tq + 1 and those + 8.  B: column g, rows 2 tq,
// 2 tq + 1 and those + 8.  C: rows g (c0, c1) and g + 8 (c2, c3), columns
// 2 tq, 2 tq + 1.  A warp's m16 tile mt holds rows r_lo + 16 mt ...
// The bound's explicit 1 CTA per SM allows no more registers than the
// thread count alone, yet ptxas allocates differently with it: the
// 16-warp instances above hd 144 spill up to 900 B with it and up to
// 2556 B without (the ptxas line of chip_smoke.py, sm_90a).
template <int HD, int MT, int MAXW>
__global__ void __launch_bounds__(MAXW * 32, 1)
    fa_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int Sq,
                  int Sk, int H, int Hk, Strides qs, Strides ks, Strides vs,
                  Strides os, int bq, int bk, int causal, int window,
                  float scale_log2, float cap_log2, float scale_over_cap) {
  using C = MmaCfg<HD, MT, MAXW>;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(fa_smem);
  bf16* KVs = Qs + bq * C::kStride;  // stage s: K, then V, bk rows each

  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (H / Hk);
  // the last q tile has the longest causal row range: launch it first
  const int q_start = (gridDim.z - 1 - blockIdx.z) * bq;
  const int q_rows = min(bq, Sq - q_start);
  const int nthreads = blockDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  bf16* ob = o + b * os.b + h * os.h;
  // scores times to_log2 are in log2 units: a softcapped score already is
  const float to_log2 = cap_log2 > 0.f ? 1.f : scale_log2;

  for (int idx = threadIdx.x; idx < bq * C::kChunks; idx += nthreads) {
    const int r = idx / C::kChunks, c = idx % C::kChunks;
    const bool in = r < q_rows;
    cp_async16(smem_addr(Qs + r * C::kStride + c * 8),
               qb + (long long)(in ? q_start + r : 0) * qs.s + c * 8, in);
  }

  // kv tiles that can hold an unmasked key for some row of this q tile
  int k_end = Sk;
  if (causal) k_end = min(k_end, q_start + q_rows);
  const int k_begin = window > 0 ? max(0, q_start - window + 1) : 0;
  const int t_begin = k_begin / bk;
  const int t_end = (k_end + bk - 1) / bk;

  auto load_kv = [&](int t, int stage) {
    const int k0 = t * bk;
    bf16* Kst = KVs + stage * 2 * bk * C::kStride;
    bf16* Vst = Kst + bk * C::kStride;
    for (int idx = threadIdx.x; idx < bk * C::kChunks; idx += nthreads) {
      const int r = idx / C::kChunks, c = idx % C::kChunks;
      const bool in = k0 + r < Sk;
      const long long row = in ? k0 + r : 0;
      cp_async16(smem_addr(Kst + r * C::kStride + c * 8),
                 kb + row * ks.s + c * 8, in);
      cp_async16(smem_addr(Vst + r * C::kStride + c * 8),
                 vb + row * vs.s + c * 8, in);
    }
  };
  if (t_begin < t_end) load_kv(t_begin, 0);
  cp_async_commit();

  // this warp's query rows are r_lo .. r_hi
  const int r_lo = q_start + warp * C::kRows, r_hi = r_lo + C::kRows - 1;
  float acc[MT][C::kOTiles][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < C::kOTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  // running max (log2 domain) and this lane's share of the row sum, for
  // rows g and g + 8 of each m16 tile
  float m_r[MT][2], l_r[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_r[mt][i] = -INFINITY;
      l_r[mt][i] = 0.f;
    }

  // lane offsets of the ldmatrix row addresses (in elements)
  const int a_off = (warp * C::kRows + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                        C::kStride + 8 * (lane >> 4);   // Q as A
  const int k_off = ((lane & 7) + 8 * (lane >> 4)) * C::kStride +
                    8 * ((lane >> 3) & 1);              // K as B
  const int v_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * C::kStride +
                    8 * (lane >> 4);                    // V as B, transposed
  const unsigned q_base = smem_addr(Qs + a_off);
  // Q's A fragment of m16 tile mt, k16 step kk
  auto q_frag = [&](int mt, int kk, unsigned (&a)[4]) {
    ldsm_x4(q_base + (mt * 16 * C::kStride + kk * 16) * sizeof(bf16), a);
  };

  cp_async_wait_all();
  __syncthreads();
  unsigned qf[MT][C::kQInRegs ? C::kKSteps : 1][4];
  if constexpr (C::kQInRegs) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kk = 0; kk < C::kKSteps; ++kk) q_frag(mt, kk, qf[mt][kk]);
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    if (t + 1 < t_end) load_kv(t + 1, stage ^ 1);
    cp_async_commit();
    const bf16* Kst = KVs + stage * 2 * bk * C::kStride;
    const bf16* Vst = Kst + bk * C::kStride;
    const unsigned k_base = smem_addr(Kst + k_off);
    const unsigned v_base = smem_addr(Vst + v_off);

    for (int c0 = 0; c0 < bk; c0 += C::kN) {
      const int kpos0 = t * bk + c0;
      // a step with no unmasked key for any of this warp's rows (or rows
      // that are all past Sq) is skipped; one that crosses the causal
      // diagonal, the window's edge or Sk is masked; the rest are not
      if (r_lo >= Sq || kpos0 >= Sk || (causal && kpos0 > r_hi) ||
          (window > 0 && r_lo - (kpos0 + C::kN - 1) >= window))
        continue;
      const bool edge = kpos0 + C::kN > Sk ||
                        (causal && kpos0 + C::kN - 1 > r_lo) ||
                        (window > 0 && r_hi - kpos0 >= window);

      // S = q k^T over this step's kN keys; each K fragment feeds the MT
      // m16 tiles
      float s[MT][C::kSTiles][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < C::kSTiles; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < C::kKSteps; ++kk) {
        unsigned a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (C::kQInRegs) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[mt][e] = qf[mt][kk][e];
          } else {
            q_frag(mt, kk, a[mt]);
          }
        }
#pragma unroll
        for (int j = 0; j < C::kSTiles; j += 2) {
          unsigned bf[4];
          ldsm_x4(k_base + ((c0 + j * 8) * C::kStride + kk * 16) *
                               sizeof(bf16), bf);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][j], a[mt], bf[0], bf[1]);
            mma_bf16(s[mt][j + 1], a[mt], bf[2], bf[3]);
          }
        }
      }

#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // softcap (to log2 units), mask, then the row max over the quad
        if (cap_log2 > 0.f) {
#pragma unroll
          for (int j = 0; j < C::kSTiles; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[mt][j][e] = cap_log2 * tanhf(s[mt][j][e] * scale_over_cap);
        }
        if (edge) {
#pragma unroll
          for (int j = 0; j < C::kSTiles; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qpos = r_lo + 16 * mt + g + 8 * (e >> 1);
              const int kpos = kpos0 + 8 * j + 2 * tq + (e & 1);
              bool keep = kpos < Sk;
              if (causal) keep = keep && qpos >= kpos;
              if (window > 0) keep = keep && qpos - kpos < window;
              if (!keep) s[mt][j][e] = -INFINITY;
            }
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < C::kSTiles; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][j][e]);
        // The max is taken before scaling (to_log2 > 0).  A row with
        // nothing unmasked yet keeps m = -inf; it is shifted by 0 instead,
        // so p = exp2(-inf) = 0 and alpha = 0, never (-inf) - (-inf).
        float shift[2], alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float m_new = fmaxf(m_r[mt][i], mx[i] * to_log2);
          shift[i] = m_new == -INFINITY ? 0.f : m_new;
          alpha[i] = exp2_approx(m_r[mt][i] - shift[i]);
          m_r[mt][i] = m_new;
          l_r[mt][i] *= alpha[i];
        }
#pragma unroll
        for (int j = 0; j < C::kSTiles; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p =
                exp2_approx(fmaf(s[mt][j][e], to_log2, -shift[e >> 1]));
            s[mt][j][e] = p;
            l_r[mt][e >> 1] += p;
          }
        }
#pragma unroll
        for (int n = 0; n < C::kOTiles; ++n) {
          acc[mt][n][0] *= alpha[0];
          acc[mt][n][1] *= alpha[0];
          acc[mt][n][2] *= alpha[1];
          acc[mt][n][3] *= alpha[1];
        }
      }

      // O += P v: P's C fragments of n8 tiles 2 ks and 2 ks + 1 are the A
      // fragment of k16 step ks; each V fragment feeds the MT m16 tiles
#pragma unroll
      for (int ks2 = 0; ks2 < C::kN / 16; ++ks2) {
        unsigned a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          a[mt][0] = pack_bf16(s[mt][2 * ks2][0], s[mt][2 * ks2][1]);
          a[mt][1] = pack_bf16(s[mt][2 * ks2][2], s[mt][2 * ks2][3]);
          a[mt][2] = pack_bf16(s[mt][2 * ks2 + 1][0], s[mt][2 * ks2 + 1][1]);
          a[mt][3] = pack_bf16(s[mt][2 * ks2 + 1][2], s[mt][2 * ks2 + 1][3]);
        }
#pragma unroll
        for (int n = 0; n < C::kOTiles; n += 2) {
          unsigned bf[4];
          ldsm_x4_trans(v_base + ((c0 + ks2 * 16) * C::kStride + n * 8) *
                                     sizeof(bf16), bf);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][n], a[mt], bf[0], bf[1]);
            mma_bf16(acc[mt][n + 1], a[mt], bf[2], bf[3]);
          }
        }
      }
    }
    // tile t + 1 has landed, and every warp is done with tile t's stage
    cp_async_wait_all();
    __syncthreads();
  }

  // O / l in bf16; a row with no unmasked key (l == 0) gives zeros
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_r[mt][i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = l == 0.f ? 0.f : 1.f / l;
      const int r = r_lo + 16 * mt + g + 8 * i;
      if (r >= Sq) continue;
      bf16* orow = ob + (long long)r * os.s + 2 * tq;
#pragma unroll
      for (int n = 0; n < C::kOTiles; ++n)
        *reinterpret_cast<unsigned*>(orow + n * 8) =
            pack_bf16(acc[mt][n][2 * i] * inv, acc[mt][n][2 * i + 1] * inv);
    }
  }
}

template <int HD, int MT, int MAXW>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Sk, int H, int Hk, const long long* st, int bq,
               int bk, int causal, int window, float softcap, size_t smem,
               cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fa_mma_kernel<HD, MT, MAXW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const float scale = 1.0f / sqrtf((float)HD);
  const dim3 grid(H, B, (Sq + bq - 1) / bq);
  fa_mma_kernel<HD, MT, MAXW><<<grid, bq / (16 * MT) * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Sk, H, Hk, qs,
      ks, vs, os, bq, bk, causal, window, scale * kLog2e, softcap * kLog2e,
      softcap > 0.f ? scale / softcap : 0.f);
  return (int)cudaGetLastError();
}

// The instance a launch at block_q bq runs: at hd <= 80, 32 rows a warp
// (block_q <= 256 is at most 8 warps); otherwise 16 rows a warp, and 16
// warps above block_q 128.
template <int HD>
int launch_mma_hd(const void* q, const void* k, const void* v, void* o,
                  int B, int Sq, int Sk, int H, int Hk, const long long* st,
                  int bq, int bk, int causal, int window, float softcap,
                  size_t smem, cudaStream_t stream) {
  if constexpr (HD <= kPairedHd)
    return launch_mma<HD, 2, 8>(q, k, v, o, B, Sq, Sk, H, Hk, st, bq, bk,
                                causal, window, softcap, smem, stream);
  else if (bq > 128)
    return launch_mma<HD, 1, 16>(q, k, v, o, B, Sq, Sk, H, Hk, st, bq, bk,
                                 causal, window, softcap, smem, stream);
  else
    return launch_mma<HD, 1, 8>(q, k, v, o, B, Sq, Sk, H, Hk, st, bq, bk,
                                causal, window, softcap, smem, stream);
}

}  // namespace
}  // namespace repro_torch

// q: (B, Sq, H, hd); k, v: (B, Sk, Hk, hd); o: (B, Sq, H, hd), all of one
// dtype, last axis contiguous.  strides: 12 element strides, (batch,
// sequence, head) for q, k, v, o in that order.  window <= 0 means none,
// softcap <= 0 means none.  smem_bytes is the caller's footprint figure and
// must equal this file's.  bfloat16 takes hd % 16 == 0 and hd <= 256,
// block_q a multiple of 32 up to 256 and block_k a multiple of 64, with
// every row 16-byte aligned.  Returns a cudaError_t code (0 on success).
extern "C" int fa_forward(const void* q, const void* k, const void* v,
                          void* o, int dtype, int B, int Sq, int Sk, int H,
                          int Hk, int hd, const long long* strides, int bq,
                          int bk, int causal, int window, float softcap,
                          long long smem_bytes, void* stream) {
  using namespace repro_torch;
  if (H % Hk != 0 || bq < 1 || bk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    const size_t smem = fa_smem_floats(bq, bk, hd) * sizeof(float);
    if ((long long)smem != smem_bytes) return (int)cudaErrorInvalidValue;
    return launch_simt(q, k, v, o, B, Sq, Sk, H, Hk, hd, strides, bq, bk,
                       causal, window, softcap, smem, s);
  }
  if (dtype != kBFloat16 || bq % kQAlign || bq > kMaxBlockQ ||
      bk % kKeyAlign ||
      (Sq + bq - 1) / bq > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = fa_mma_smem_bytes(bq, bk, hd);
  if ((long long)smem != smem_bytes) return (int)cudaErrorInvalidValue;
  switch (hd) {
#define FA_HD(D)                                                           \
  case D:                                                                  \
    return launch_mma_hd<D>(q, k, v, o, B, Sq, Sk, H, Hk, strides, bq, bk, \
                            causal, window, softcap, smem, s);
    FA_HD(16) FA_HD(32) FA_HD(48) FA_HD(64) FA_HD(80) FA_HD(96) FA_HD(112)
    FA_HD(128) FA_HD(144) FA_HD(160) FA_HD(176) FA_HD(192) FA_HD(208)
    FA_HD(224) FA_HD(240) FA_HD(256)
#undef FA_HD
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
