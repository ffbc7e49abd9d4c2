// Mamba-2 SSD chunked scan for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (_kernel at :25,
// wrapper ssd_scan at :71, pl.pallas_call at :93).  Per chunk of L steps:
// the decay-masked scores G = (c b^T) * exp(seg_i - seg_j) for j <= i, the
// intra-chunk output G x, the inter-chunk output exp(seg_i) c_i . state, and
// the state update state * exp(total) + sum_j exp(total - seg_j) b_j x_j^T.
// The (N, P) fp32 state is carried across chunks; the final state is an
// output.  Steps past S behave as padding with log_a = 0 and x = b = c = 0.
// exp(seg_i - seg_j) is formed only for j <= i: above the diagonal the
// exponent is positive and can overflow to inf, and inf * 0 would be NaN.
//
// What bounds it on this card: at the main path's shapes (S = 4096, 32
// heads, P = 80, N = 64) the work is a few GFLOP against ~43 MB of x,
// log_a, y and the fp32 final state (the node's b = c are views of x), so
// an ideal kernel is bound by bytes.
//
// Two routes behind the one entry point ssd_forward, chosen by x's dtype:
//
// * bfloat16: the chunk-parallel form of the recurrence, as GPU Mamba-2
//   implementations run it, in three launches on the caller's stream.
//   1. ssd_chunk_state, grid (chunk, head, batch): seg, the chunk's
//      cumulative sum of log_a, by warp scans; its local state
//      s_c = sum_j exp(total - seg_j) b_j x_j^T (N x P) on the tensor
//      cores; s_c and exp(total) go to a workspace.
//   2. ssd_state_pass, grid (slices of N * P, head, batch): walks the
//      chunks in order, S_in[c] = S_in[c-1] exp(total[c-1]) + s[c-1],
//      S_in[0] = 0, overwriting each s[c] with S_in[c] (the loads run
//      ahead of the chain); the last state is the final state.
//   3. ssd_chunk_scan, grid (chunk, head, batch):
//      y_i = exp(seg_i) (c_i . S_in[c]) + sum_{j <= i} G_ij x_j, c b^T
//      with c and b by ldmatrix, the decay-masked scores kept in registers
//      as the A fragment of the product with x (x by ldmatrix.trans), as
//      flash hands on P.
//   Products are mma.sync m16n8k16 with bf16 operands and fp32
//   accumulators.  An operand that is an input (x, b, c) is exact in bf16;
//   one that is computed in fp32 (b times each step's weight in pass 1,
//   the scores G, the state S_in) is split into a bf16 high part and a
//   bf16 remainder, two products, so the result keeps about 16 bits of
//   each term: the tests hold the final state at the fp32 tolerance, and a
//   single bf16 rounding of G or S_in would exceed the bf16 tolerance of y
//   where y is near 0.  Where b's rows are the first N columns of x's and
//   c is b (the node's b = c = x[..., :N]), passes 1 and 3 copy only x and
//   read b and c from its rows in shared memory: each byte is read once.
//   L is the autotuner's chunk rounded up to 16 (at most 256); P and N are
//   zero-padded to multiples of 16 in shared memory (P <= 128, N <= 64),
//   and the instances hold P's n8 tiles as a template parameter (4, 8, 10
//   or 16).  The workspace (B, H, nc, N, P) fp32 states and (B, H, nc)
//   decays is the caller's.
//   Wider heads (P > 128 or N > 64, up to 384 each: the xLSTM's mLSTM runs
//   P = N = 384) take the wide route, whose chunk is at most 128.  Pass 1
//   tiles the (N, P) chunk state over the grid, one 64 x 128 tile a CTA.
//   Pass 3 (ssd_chunk_scan_wide) tiles P over the grid, 128 columns a CTA,
//   and streams N through shared memory in slabs of 64: per slab the c and
//   b rows and the S_in rows of its P tile arrive, and each warp adds the
//   slab's share of c b^T (its m16 row tile's causal scores) and of
//   c . S_in to accumulators it keeps in registers across the slabs; the
//   decay mask and the product with x follow once N is summed.  A 384 x
//   384 fp32 state never sits in one CTA, as the TPU's VMEM holds it.
// * float32: ssd_kernel, the SIMT kernel (fp32 FMA on the CUDA cores, one
//   CTA per (batch, head) looping over the chunks with the state in shared
//   memory), which keeps fp32 products and so the fp32 tolerance of the
//   tests; no TF32 and no bf16 product is allowed there.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;

// fp32 words of dynamic shared memory per CTA; kernels/ssd_scan.py
// smem_bytes() computes the same figure for the autotuner's pruning.
inline size_t ssd_smem_floats(int L, int P, int N) {
  return (size_t)L * P               // x chunk
         + 2 * (size_t)L * (N + 1)   // b and c chunks, rows padded
         + (size_t)L * L             // decay-masked scores
         + (size_t)N * P             // carried state
         + 3 * (size_t)L;            // seg, exp(seg), exp(total - seg)
}

// T: the dtype of x, b, c and y; A: the dtype of log_a, which may differ
// (the node hands over bf16, a caller may keep its decays in fp32)
template <class T, class A>
__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const T* __restrict__ x, const A* __restrict__ la,
               const T* __restrict__ bm, const T* __restrict__ cm,
               T* __restrict__ y, float* __restrict__ fin, int S, int H, int P,
               int N, Strides xs, Strides as, Strides bs, Strides cs,
               Strides ys, int L) {
  extern __shared__ float smem[];
  const int bn = N + 1;  // padded row stride of b and c
  float* Xs = smem;
  float* Bs = Xs + L * P;
  float* Cs = Bs + L * bn;
  float* Gs = Cs + L * bn;
  float* St = Gs + L * L;
  float* seg = St + N * P;
  float* eseg = seg + L;
  float* w = eseg + L;

  const int h = blockIdx.x, b = blockIdx.y;
  const T* xb = x + b * xs.b + h * xs.h;
  const A* ab = la + b * as.b + h * as.h;
  const T* bb = bm + b * bs.b + h * bs.h;
  const T* cb = cm + b * cs.b + h * cs.h;
  T* yb = y + b * ys.b + h * ys.h;

  for (int idx = threadIdx.x; idx < N * P; idx += blockDim.x) St[idx] = 0.f;

  const int nc = (S + L - 1) / L;
  for (int ic = 0; ic < nc; ++ic) {
    const int t0 = ic * L;
    const int rows = min(L, S - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int idx = threadIdx.x; idx < L * P; idx += blockDim.x) {
      const int i = idx / P, p = idx % P;
      Xs[idx] = i < rows ? to_float(xb[(t0 + i) * xs.s + p]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < L * N; idx += blockDim.x) {
      const int i = idx / N, n = idx % N;
      const bool in = i < rows;
      Bs[i * bn + n] = in ? to_float(bb[(t0 + i) * bs.s + n]) : 0.f;
      Cs[i * bn + n] = in ? to_float(cb[(t0 + i) * cs.s + n]) : 0.f;
    }
    for (int i = threadIdx.x; i < L; i += blockDim.x)
      seg[i] = i < rows ? to_float(ab[(t0 + i) * as.s]) : 0.f;
    __syncthreads();
    if (threadIdx.x == 0) {  // inclusive cumulative sum of log_a
      float run = 0.f;
      for (int i = 0; i < L; ++i) {
        run += seg[i];
        seg[i] = run;
      }
    }
    __syncthreads();
    const float total = seg[L - 1];
    for (int i = threadIdx.x; i < L; i += blockDim.x) {
      eseg[i] = expf(seg[i]);
      w[i] = expf(total - seg[i]);
    }

    // G[i][j] = (c_i . b_j) * exp(seg_i - seg_j) for j <= i, else 0
    block_product(
        L, L, N, [&](int i, int n) { return Cs[i * bn + n]; },
        [&](int n, int j) { return Bs[j * bn + n]; },
        [&](int i, int j, float acc) {
          Gs[i * L + j] = j <= i ? acc * expf(seg[i] - seg[j]) : 0.f;
        });
    __syncthreads();

    // y = [G | exp(seg) c] . [x ; state]: intra- and inter-chunk parts as
    // one product over L + N, read against the state carried in
    block_product(
        L, P, L + N,
        [&](int i, int kk) {
          return kk < L ? Gs[i * L + kk] : eseg[i] * Cs[i * bn + kk - L];
        },
        [&](int kk, int p) {
          return kk < L ? Xs[kk * P + p] : St[(kk - L) * P + p];
        },
        [&](int i, int p, float acc) {
          if (i < rows) yb[(t0 + i) * ys.s + p] = from_float<T>(acc);
        });
    __syncthreads();

    // state = state * exp(total) + sum_j exp(total - seg_j) b_j x_j^T
    const float decay = expf(total);
    block_product(
        N, P, L, [&](int n, int j) { return Bs[j * bn + n] * w[j]; },
        [&](int j, int p) { return Xs[j * P + p]; },
        [&](int n, int p, float acc) {
          St[n * P + p] = St[n * P + p] * decay + acc;
        });
  }
  __syncthreads();

  float* fb = fin + ((size_t)b * H + h) * N * P;
  for (int idx = threadIdx.x; idx < N * P; idx += blockDim.x) fb[idx] = St[idx];
}

template <class A>
int launch_simt(const void* x, const void* la, const void* bm, const void* cm,
                void* y, float* fin, int B, int S, int H, int P, int N,
                const long long* st, int L, size_t smem,
                cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel<float, A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const Strides xs{st[0], st[1], st[2]}, as{st[3], st[4], st[5]},
      bs{st[6], st[7], st[8]}, cs{st[9], st[10], st[11]},
      ys{st[12], st[13], st[14]};
  ssd_kernel<float, A><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const A*>(la),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<float*>(y), fin, S, H, P, N, xs, as, bs, cs, ys, L);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 route: chunk-parallel, three passes on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMaxChunk = 256;  // at most 2 steps of the scan a thread
constexpr int kMaxPT = 16;      // n8 tiles of P: P <= 128
constexpr int kMaxNK = 4;       // k16 steps of N: N <= 64
constexpr int kLoadBatch = 8;  // S_in loads in flight per thread
// float4 loads of S_in per thread: N * P / 4 over the threads, at most
constexpr int kS4 = 16 * kMaxNK * 8 * kMaxPT / 4 / kMmaThreads;
constexpr int kPassThreads = 128;
constexpr int kPassUnroll = 16;  // chunks whose loads run ahead in pass 2
// the wide route: P tiles of 8 kWidePT columns and N tiles (pass 1) or
// slabs (pass 3) of kWideN, a chunk of at most kWideMaxChunk (one m16 row
// tile per warp), P and N up to kMaxWidth
constexpr int kWidePT = 16;
constexpr int kWideN = 64;
constexpr int kWideMaxChunk = 16 * kMmaWarps;
constexpr int kMaxWidth = 384;

constexpr float kLog2e = 1.4426950408889634f;

inline int round16(int n) { return (n + 15) / 16 * 16; }

// Byte offsets of the dynamic shared memory of passes 1 and 3 at chunk L
// (a multiple of 16) and padded widths Pp, Np; bf16 rows are padded by 8
// elements so the 8 row addresses of an ldmatrix hit distinct 16-byte bank
// groups.  b and c have rows of their own only where they are not read
// from x's (bx: b is x's first N columns; cb: c is b).
struct Layout {
  size_t x, sh, sl, seg, eseg, b, c, total;
};
__host__ __device__ inline Layout state_layout(int L, int Pp, int Np,
                                               bool bx) {
  Layout o{};
  o.x = 0;                                          // x
  o.seg = o.x + 2 * (size_t)L * (Pp + 8);           // seg, then weights
  o.b = o.seg + 4 * (size_t)L;                      // b
  o.total = o.b + (bx ? 0 : 2 * (size_t)L * (Np + 8));
  return o;
}
__host__ __device__ inline Layout scan_layout(int L, int Pp, int Np, bool bx,
                                              bool cb) {
  Layout o{};
  o.x = 0;                                          // x
  o.sh = o.x + 2 * (size_t)L * (Pp + 8);            // S_in, high part
  o.sl = o.sh + 2 * (size_t)Np * (Pp + 8);          // S_in, low part
  o.seg = o.sl + 2 * (size_t)Np * (Pp + 8);         // seg
  o.eseg = o.seg + 4 * (size_t)L;                   // exp(seg)
  o.b = o.eseg + 4 * (size_t)L;                     // b
  o.c = o.b + (bx ? 0 : 2 * (size_t)L * (Np + 8));  // c
  o.total = o.c + (cb ? 0 : 2 * (size_t)L * (Np + 8));
  return o;
}
// pass 3 of the wide route: x's P tile, the S_in slab's high and low
// parts, seg, exp(seg), and the b and c slabs
__host__ __device__ inline Layout wide_layout(int L) {
  const size_t sx = 8 * kWidePT + 8, sn = kWideN + 8;
  Layout o{};
  o.x = 0;
  o.sh = o.x + 2 * (size_t)L * sx;
  o.sl = o.sh + 2 * (size_t)kWideN * sx;
  o.seg = o.sl + 2 * (size_t)kWideN * sx;
  o.eseg = o.seg + 4 * (size_t)L;
  o.b = o.eseg + 4 * (size_t)L;
  o.c = o.b + 2 * (size_t)L * sn;
  o.total = o.c + 2 * (size_t)L * sn;
  return o;
}
inline bool wide_route(int P, int N) {
  return P > 8 * kMaxPT || N > 16 * kMaxNK;
}
// kernels/ssd_scan.py smem_bytes() computes the same figure for the
// autotuner's pruning: the larger of the two passes where b and c have
// rows of their own; a launch that reads them from x's takes less
inline size_t chunked_smem(int L, int P, int N) {
  if (wide_route(P, N)) {
    const size_t a = state_layout(L, 8 * kWidePT, kWideN, false).total;
    const size_t b = wide_layout(L).total;
    return a > b ? a : b;
  }
  const size_t a = state_layout(L, round16(P), round16(N), false).total;
  const size_t b = scan_layout(L, round16(P), round16(N), false, false).total;
  return a > b ? a : b;
}

struct ChunkArgs {
  const bf16 *x, *b, *c;
  const void* la;
  bf16* y;
  float* ws;     // (B, H, nc, N, P) states
  float* decay;  // (B, H, nc) exp(total)
  int S, H, P, N, L, Pp, Np, nc;
  // pass 1's tiles of the (N, P) chunk state: tn x tp (padded widths),
  // ntiles x ptiles of them; one tile of Np x Pp below the wide route
  int tp, tn, ptiles, ntiles;
  Strides xs, as, bs, cs, ys;
  int vx, vb, vc;  // rows may be copied as 16-byte pieces
  // b's rows are the first N columns of x's (N a multiple of 16), and c's
  // are b's: the node's b = c = x[..., :N].  Each is then read from the
  // rows already in shared memory, not copied again.
  int bx, cb;
};

// rows t0 .. t0 + L - 1 of one (batch, head) slice of a (B, S, H, width)
// bf16 tensor into dst (row stride dstride), zero past `rows` and past
// `width` up to `padded`
__device__ __forceinline__ void load_rows(bf16* dst, int dstride,
                                          const bf16* src, long long s_stride,
                                          int t0, int rows, int L, int width,
                                          int padded, bool vec) {
  const bf16 zero = __float2bfloat16(0.f);
  if (vec) {
    const int pieces = width / 8;
    for (int idx = threadIdx.x; idx < L * pieces; idx += kMmaThreads) {
      const int r = idx / pieces, c = idx % pieces;
      const bool in = r < rows;
      cp_async16(smem_addr(dst + r * dstride + c * 8),
                 src + (long long)(t0 + (in ? r : 0)) * s_stride + c * 8, in);
    }
    const int pad = padded - width;
    for (int idx = threadIdx.x; idx < L * pad; idx += kMmaThreads)
      dst[(idx / pad) * dstride + width + idx % pad] = zero;
  } else {
    for (int idx = threadIdx.x; idx < L * padded; idx += kMmaThreads) {
      const int r = idx / padded, c = idx % padded;
      dst[r * dstride + c] = r < rows && c < width
                                 ? src[(long long)(t0 + r) * s_stride + c]
                                 : zero;
    }
  }
}

// seg[i] = log_a of step t0 + i (0 past `rows`), then its inclusive
// cumulative sum over i < L: each thread takes two neighbouring steps, a
// warp scans its 64 by shuffles, and the warps' totals are added on.
template <class A>
__device__ __forceinline__ void chunk_cumsum(float* seg, const A* la,
                                             long long s_stride, int t0,
                                             int rows, int L) {
  __shared__ float warp_total[kMmaWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i0 = 2 * threadIdx.x;
  const float a0 = i0 < rows ? to_float(la[(long long)(t0 + i0) * s_stride])
                             : 0.f;
  const float a1 =
      i0 + 1 < rows ? to_float(la[(long long)(t0 + i0 + 1) * s_stride]) : 0.f;
  const float pair = a0 + a1;
  float incl = pair;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float n = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += n;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  float base = 0.f;
  for (int w = 0; w < warp; ++w) base += warp_total[w];
  const float before = base + incl - pair;
  if (i0 < L) seg[i0] = before + a0;
  if (i0 + 1 < L) seg[i0 + 1] = before + pair;
  __syncthreads();
}

// the (high, low) bf16 pair of fp32 lo-column and hi-column values: high
// parts packed in `h`, the remainders in `l`
__device__ __forceinline__ void split_pack(float v0, float v1, unsigned& h,
                                           unsigned& l) {
  const __nv_bfloat162 hv = __floats2bfloat162_rn(v0, v1);
  h = *reinterpret_cast<const unsigned*>(&hv);
  l = pack_bf16(v0 - __low2float(hv), v1 - __high2float(hv));
}
// a bf16 pair (lo half first) times (w.x, w.y), split as split_pack does
__device__ __forceinline__ void scale_split(unsigned pair, float2 w,
                                            unsigned& h, unsigned& l) {
  split_pack(__uint_as_float(pair << 16) * w.x,
             __uint_as_float(pair & 0xffff0000u) * w.y, h, l);
}

// Pass 1: one tile of the local state of a (chunk, head, batch),
// s = (b w)^T x: state rows n0 .. n0 + tn - 1 and columns p0 .. p0 + tp - 1
// (the whole state below the wide route).  Warp w computes tile rows
// 16 (w % 4) .. + 15 against one half of the tile's n8 tiles: A = b^T by
// ldmatrix.trans, scaled by each step's weight in registers and split into
// high and low parts; B = x by ldmatrix.trans.  PT is the n8 tiles the
// instance holds (tp <= 8 PT).
template <class A, int PT>
__global__ void __launch_bounds__(kMmaThreads, 2)
    ssd_chunk_state(const ChunkArgs a) {
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  const int L = a.L, sx = a.tp + 8, sn = a.tn + 8;
  const Layout lo = state_layout(L, a.tp, a.tn, a.bx);
  bf16* Xs = reinterpret_cast<bf16*>(ssd_smem + lo.x);
  float* w = reinterpret_cast<float*>(ssd_smem + lo.seg);
  bf16* Bs = reinterpret_cast<bf16*>(ssd_smem + lo.b);
  const int tiles = a.ptiles * a.ntiles, tile = blockIdx.x % tiles;
  const int ic = blockIdx.x / tiles, h = blockIdx.y, bb = blockIdx.z;
  const int t0 = ic * L, rows = min(L, a.S - t0);
  const int p0 = tile % a.ptiles * a.tp, n0 = tile / a.ptiles * a.tn;
  const int pw = min(a.tp, a.P - p0), nw = min(a.tn, a.N - n0);

  load_rows(Xs, sx, a.x + bb * a.xs.b + h * a.xs.h + p0, a.xs.s, t0, rows,
            L, pw, a.tp, a.vx);
  if (!a.bx)
    load_rows(Bs, sn, a.b + bb * a.bs.b + h * a.bs.h + n0, a.bs.s, t0, rows,
              L, nw, a.tn, a.vb);
  cp_async_commit();
  chunk_cumsum(w, static_cast<const A*>(a.la) + bb * a.as.b + h * a.as.h,
               a.as.s, t0, rows, L);
  const float total = w[L - 1];
  __syncthreads();  // every thread has read total
  // w[j] becomes the weight exp(total - seg_j) of step j
  for (int j = threadIdx.x; j < L; j += kMmaThreads)
    w[j] = exp2_approx((total - w[j]) * kLog2e);
  cp_async_wait_all();
  __syncthreads();

  const size_t slice = (size_t)(bb * a.H + h) * a.nc + ic;
  if (threadIdx.x == 0 && tile == 0) a.decay[slice] = expf(total);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int mt = warp % 4, pt = a.tp / 8;
  const int half = (pt / 2 + 1) / 2 * 2;  // n8 tiles of the first half
  const int n_lo = warp < 4 ? 0 : half, n_hi = warp < 4 ? half : pt;
  if (mt >= a.tn / 16) return;
  const bf16* Bu = a.bx ? Xs : Bs;
  const int bstr = a.bx ? sx : sn;
  const unsigned b_base = smem_addr(
      Bu + ((lane & 7) + 8 * (lane >> 4)) * bstr + 16 * mt +
      8 * ((lane >> 3) & 1));
  const unsigned x_base = smem_addr(
      Xs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * sx + 8 * (lane >> 4));
  float acc[PT][4];
#pragma unroll
  for (int n = 0; n < PT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int kk = 0; kk < L / 16; ++kk) {
    unsigned af[4], xf[PT / 2][4];
    ldsm_x4_trans(b_base + kk * 16 * bstr * sizeof(bf16), af);
#pragma unroll
    for (int n = 0; n < PT; n += 2)
      if (n >= n_lo && n < n_hi)
        ldsm_x4_trans(x_base + (kk * 16 * sx + n * 8) * sizeof(bf16),
                      xf[n / 2]);
    // A's columns (k) 2 tq, 2 tq + 1 in af[0..1], those + 8 in af[2..3]
    const float2 w0 = *reinterpret_cast<const float2*>(w + kk * 16 + 2 * tq);
    const float2 w1 =
        *reinterpret_cast<const float2*>(w + kk * 16 + 2 * tq + 8);
    unsigned ah[4], al[4];
    scale_split(af[0], w0, ah[0], al[0]);
    scale_split(af[1], w0, ah[1], al[1]);
    scale_split(af[2], w1, ah[2], al[2]);
    scale_split(af[3], w1, ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < PT; n += 2) {
      if (n < n_lo || n >= n_hi) continue;
      mma_bf16(acc[n], ah, xf[n / 2][0], xf[n / 2][1]);
      mma_bf16(acc[n], al, xf[n / 2][0], xf[n / 2][1]);
      mma_bf16(acc[n + 1], ah, xf[n / 2][2], xf[n / 2][3]);
      mma_bf16(acc[n + 1], al, xf[n / 2][2], xf[n / 2][3]);
    }
  }
  float* out = a.ws + slice * a.N * a.P + (size_t)n0 * a.P + p0;
#pragma unroll
  for (int n = 0; n < PT; ++n) {
    if (n < n_lo || n >= n_hi) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * mt + g + 8 * (e >> 1);
      const int col = n * 8 + 2 * tq + (e & 1);
      if (row < nw && col < pw) out[row * a.P + col] = acc[n][e];
    }
  }
}

// Pass 2: one thread per state entry of a (head, batch) walks the chunks;
// the loads of kPassUnroll chunks are issued before their chain.
__global__ void __launch_bounds__(kPassThreads)
    ssd_state_pass(float* __restrict__ ws, const float* __restrict__ decay,
                   float* __restrict__ fin, int H, int nc, int NP) {
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= NP) return;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  float* st = ws + bh * nc * NP + e;
  const float* dc = decay + bh * nc;
  float run = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kPassUnroll) {
    float s[kPassUnroll], d[kPassUnroll];
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      if (c0 + u < nc) {
        s[u] = st[(size_t)(c0 + u) * NP];
        d[u] = dc[c0 + u];
      }
    }
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      if (c0 + u < nc) {
        st[(size_t)(c0 + u) * NP] = run;
        run = fmaf(run, d[u], s[u]);
      }
    }
  }
  fin[bh * NP + e] = run;
}

// Pass 3: the output of one (chunk, head, batch).  Each warp takes m16
// tiles of rows in zigzag order; for each, c . S_in (high and low parts of
// S_in) scaled by exp(seg_i), then the causal j tiles of G x.
template <class A, int PT>
__global__ void __launch_bounds__(kMmaThreads, 2)
    ssd_chunk_scan(const ChunkArgs a) {
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  const int L = a.L, sx = a.Pp + 8, sn = a.Np + 8;
  const Layout lo = scan_layout(L, a.Pp, a.Np, a.bx, a.cb);
  bf16* Xs = reinterpret_cast<bf16*>(ssd_smem + lo.x);
  bf16* Sh = reinterpret_cast<bf16*>(ssd_smem + lo.sh);
  bf16* Sl = reinterpret_cast<bf16*>(ssd_smem + lo.sl);
  float* seg = reinterpret_cast<float*>(ssd_smem + lo.seg);
  float* eseg = reinterpret_cast<float*>(ssd_smem + lo.eseg);
  bf16* Bs = reinterpret_cast<bf16*>(ssd_smem + lo.b);
  bf16* Cs = reinterpret_cast<bf16*>(ssd_smem + lo.c);
  const int ic = blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int t0 = ic * L, rows = min(L, a.S - t0);

  // S_in: its loads are issued first, so they overlap the copies below;
  // four floats at a time where a row holds whole float4s
  const size_t slice = (size_t)(bb * a.H + h) * a.nc + ic;
  const float* st = a.ws + slice * a.N * a.P;
  const bool v4 = a.P % 4 == 0;
  const int n4 = a.N * a.P / 4;
  float4 sv[kS4];
  if (v4) {
#pragma unroll
    for (int u = 0; u < kS4; ++u) {
      const int idx = threadIdx.x + u * kMmaThreads;
      if (idx < n4) sv[u] = __ldg(reinterpret_cast<const float4*>(st) + idx);
    }
  }
  load_rows(Xs, sx, a.x + bb * a.xs.b + h * a.xs.h, a.xs.s, t0, rows, L,
            a.P, a.Pp, a.vx);
  if (!a.bx)
    load_rows(Bs, sn, a.b + bb * a.bs.b + h * a.bs.h, a.bs.s, t0, rows, L,
              a.N, a.Np, a.vb);
  if (!a.cb)
    load_rows(Cs, sn, a.c + bb * a.cs.b + h * a.cs.h, a.cs.s, t0, rows, L,
              a.N, a.Np, a.vc);
  cp_async_commit();
  auto put = [&](int n, int p, float v) {  // S_in[n][p] as high and low
    const bf16 hi = __float2bfloat16(v);
    Sh[n * sx + p] = hi;
    Sl[n * sx + p] = __float2bfloat16(v - __bfloat162float(hi));
  };
  if (v4) {
#pragma unroll
    for (int u = 0; u < kS4; ++u) {
      const int idx = threadIdx.x + u * kMmaThreads;
      if (idx >= n4) break;
      const int n = 4 * idx / a.P, p = 4 * idx % a.P;
      unsigned hi[2], lo[2];
      split_pack(sv[u].x, sv[u].y, hi[0], lo[0]);
      split_pack(sv[u].z, sv[u].w, hi[1], lo[1]);
      *reinterpret_cast<uint2*>(Sh + n * sx + p) = make_uint2(hi[0], hi[1]);
      *reinterpret_cast<uint2*>(Sl + n * sx + p) = make_uint2(lo[0], lo[1]);
    }
    if (a.Np > a.N || a.Pp > a.P) {  // the zero padding
      for (int idx = threadIdx.x; idx < a.Np * a.Pp; idx += kMmaThreads) {
        const int n = idx / a.Pp, p = idx % a.Pp;
        if (n >= a.N || p >= a.P) put(n, p, 0.f);
      }
    }
  } else {
    // in batches of kLoadBatch loads issued before their stores (the
    // compiler cannot tell the shared-memory stores from the loads)
    const int nsp = a.Np * a.Pp;
    for (int i0 = threadIdx.x; i0 < nsp; i0 += kLoadBatch * kMmaThreads) {
      float v[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int idx = i0 + u * kMmaThreads;
        const int n = idx / a.Pp, p = idx % a.Pp;
        v[u] = idx < nsp && n < a.N && p < a.P ? __ldg(st + n * a.P + p)
                                               : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int idx = i0 + u * kMmaThreads;
        if (idx >= nsp) break;
        put(idx / a.Pp, idx % a.Pp, v[u]);
      }
    }
  }
  chunk_cumsum(seg, static_cast<const A*>(a.la) + bb * a.as.b + h * a.as.h,
               a.as.s, t0, rows, L);
  // seg in log2 units from here on
  for (int i = threadIdx.x; i < L; i += kMmaThreads) {
    seg[i] *= kLog2e;
    eseg[i] = exp2_approx(seg[i]);
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int nk = a.Np / 16;
  const bf16* Bu = a.bx ? Xs : Bs;
  const int bstr = a.bx ? sx : sn;
  const bf16* Cu = a.cb ? Bu : Cs;
  const int cstr = a.cb ? bstr : sn;
  // lane offsets of the ldmatrix row addresses (in elements)
  const unsigned c_base = smem_addr(
      Cu + ((lane & 7) + 8 * ((lane >> 3) & 1)) * cstr + 8 * (lane >> 4));
  const unsigned b_base = smem_addr(
      Bu + ((lane & 7) + 8 * (lane >> 4)) * bstr + 8 * ((lane >> 3) & 1));
  const int to = ((lane & 7) + 8 * ((lane >> 3) & 1)) * sx + 8 * (lane >> 4);
  const unsigned x_base = smem_addr(Xs + to);
  const unsigned sh_base = smem_addr(Sh + to), sl_base = smem_addr(Sl + to);
  bf16* yb = a.y + bb * a.ys.b + h * a.ys.h;
  const int pt = a.Pp / 8;

  // m16 tiles go to the warps in zigzag order (w, then 2W - 1 - w, ...):
  // a tile's work grows with its index, so the warps' shares even out
  const int nt = L / 16;
  for (int r = 0; r * kMmaWarps < nt; ++r) {
    const int mt = r * kMmaWarps + (r % 2 ? kMmaWarps - 1 - warp : warp);
    if (mt >= nt) continue;
    const int i0 = 16 * mt;
    unsigned cf[kMaxNK][4];
#pragma unroll
    for (int kk = 0; kk < kMaxNK; ++kk)
      if (kk < nk)
        ldsm_x4(c_base + (i0 * cstr + kk * 16) * sizeof(bf16), cf[kk]);
    float acc[PT][4];
#pragma unroll
    for (int n = 0; n < PT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    // inter-chunk: exp(seg_i) * (c_i . S_in)
#pragma unroll
    for (int kk = 0; kk < kMaxNK; ++kk) {
      if (kk >= nk) break;
#pragma unroll
      for (int n = 0; n < PT; n += 2) {
        if (n >= pt) break;
        unsigned sh[4], sl[4];
        const unsigned off = (kk * 16 * sx + n * 8) * sizeof(bf16);
        ldsm_x4_trans(sh_base + off, sh);
        ldsm_x4_trans(sl_base + off, sl);
        mma_bf16(acc[n], cf[kk], sh[0], sh[1]);
        mma_bf16(acc[n], cf[kk], sl[0], sl[1]);
        mma_bf16(acc[n + 1], cf[kk], sh[2], sh[3]);
        mma_bf16(acc[n + 1], cf[kk], sl[2], sl[3]);
      }
    }
    const float seg_i[2] = {seg[i0 + g], seg[i0 + g + 8]};  // log2 units
    const float e0 = eseg[i0 + g], e1 = eseg[i0 + g + 8];
#pragma unroll
    for (int n = 0; n < PT; ++n) {
      acc[n][0] *= e0;
      acc[n][1] *= e0;
      acc[n][2] *= e1;
      acc[n][3] *= e1;
    }

    // intra-chunk: the j tiles at or below the diagonal
    for (int jt = 0; jt <= mt; ++jt) {
      float s[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kMaxNK; ++kk) {
        if (kk >= nk) break;
        unsigned bfr[4];
        ldsm_x4(b_base + (jt * 16 * bstr + kk * 16) * sizeof(bf16), bfr);
        mma_bf16(s[0], cf[kk], bfr[0], bfr[1]);
        mma_bf16(s[1], cf[kk], bfr[2], bfr[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int j0 = 16 * jt + 8 * j + 2 * tq;
        const float seg_j[2] = {seg[j0], seg[j0 + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + g + 8 * (e >> 1);
          s[j][e] = j0 + (e & 1) <= i
                        ? s[j][e] * exp2_approx(seg_i[e >> 1] - seg_j[e & 1])
                        : 0.f;
        }
      }
      unsigned ah[4], al[4];
      split_pack(s[0][0], s[0][1], ah[0], al[0]);
      split_pack(s[0][2], s[0][3], ah[1], al[1]);
      split_pack(s[1][0], s[1][1], ah[2], al[2]);
      split_pack(s[1][2], s[1][3], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < PT; n += 2) {
        if (n >= pt) break;
        unsigned xf[4];
        ldsm_x4_trans(x_base + (jt * 16 * sx + n * 8) * sizeof(bf16), xf);
        mma_bf16(acc[n], ah, xf[0], xf[1]);
        mma_bf16(acc[n], al, xf[0], xf[1]);
        mma_bf16(acc[n + 1], ah, xf[2], xf[3]);
        mma_bf16(acc[n + 1], al, xf[2], xf[3]);
      }
    }

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = i0 + g + 8 * rr;
      if (i >= rows) continue;
      bf16* yrow = yb + (long long)(t0 + i) * a.ys.s;
#pragma unroll
      for (int n = 0; n < PT; ++n) {
        if (n >= pt) break;
        const int col = n * 8 + 2 * tq;
        if (col + 1 < a.P && (a.P & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(yrow + col) =
              __floats2bfloat162_rn(acc[n][2 * rr], acc[n][2 * rr + 1]);
        } else {
          if (col < a.P) yrow[col] = __float2bfloat16(acc[n][2 * rr]);
          if (col + 1 < a.P)
            yrow[col + 1] = __float2bfloat16(acc[n][2 * rr + 1]);
        }
      }
    }
  }
}

// Pass 3 of the wide route: the output columns p0 .. p0 + 127 of one
// (chunk, head, batch).  Warp w owns the m16 row tile w (L <= 128).  N
// streams through shared memory in slabs of kWideN: per slab, the warp
// loads its c fragments once and adds c . S_in (high and low parts) to its
// output accumulators and c b^T to its causal score tiles, both held in
// registers across the slabs.  Then the output is scaled by exp(seg_i),
// the scores are decay-masked, split, and multiplied with x's P tile.
template <class A, int PT>
__global__ void __launch_bounds__(kMmaThreads, 1)
    ssd_chunk_scan_wide(const ChunkArgs a) {
  static_assert(PT == kWidePT, "wide_layout holds P tiles of 8 kWidePT");
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  constexpr int TP = 8 * PT, sx = TP + 8, sn = kWideN + 8;
  constexpr int JT = kWideMaxChunk / 16;  // k16 tiles of j, at most
  const int L = a.L;
  const Layout lo = wide_layout(L);
  bf16* Xs = reinterpret_cast<bf16*>(ssd_smem + lo.x);
  bf16* Sh = reinterpret_cast<bf16*>(ssd_smem + lo.sh);
  bf16* Sl = reinterpret_cast<bf16*>(ssd_smem + lo.sl);
  float* seg = reinterpret_cast<float*>(ssd_smem + lo.seg);
  float* eseg = reinterpret_cast<float*>(ssd_smem + lo.eseg);
  bf16* Bs = reinterpret_cast<bf16*>(ssd_smem + lo.b);
  bf16* Cs = reinterpret_cast<bf16*>(ssd_smem + lo.c);
  const int ic = blockIdx.x / a.ptiles, h = blockIdx.y, bb = blockIdx.z;
  const int p0 = blockIdx.x % a.ptiles * TP, pw = min(TP, a.P - p0);
  const int t0 = ic * L, rows = min(L, a.S - t0);
  const size_t slice = (size_t)(bb * a.H + h) * a.nc + ic;
  const float* st = a.ws + slice * a.N * a.P + p0;

  load_rows(Xs, sx, a.x + bb * a.xs.b + h * a.xs.h + p0, a.xs.s, t0, rows,
            L, pw, TP, a.vx);
  cp_async_commit();
  chunk_cumsum(seg, static_cast<const A*>(a.la) + bb * a.as.b + h * a.as.h,
               a.as.s, t0, rows, L);
  // seg in log2 units from here on
  for (int i = threadIdx.x; i < L; i += kMmaThreads) {
    seg[i] *= kLog2e;
    eseg[i] = exp2_approx(seg[i]);
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int mt = warp, i0 = 16 * mt;
  const bool active = mt < L / 16;
  const unsigned c_base = smem_addr(
      Cs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * sn + 8 * (lane >> 4));
  const unsigned b_base = smem_addr(
      Bs + ((lane & 7) + 8 * (lane >> 4)) * sn + 8 * ((lane >> 3) & 1));
  const int to = ((lane & 7) + 8 * ((lane >> 3) & 1)) * sx + 8 * (lane >> 4);
  const unsigned x_base = smem_addr(Xs + to);
  const unsigned sh_base = smem_addr(Sh + to), sl_base = smem_addr(Sl + to);
  const bool v4 = a.P % 4 == 0;

  float acc[PT][4], s[2 * JT][4];
#pragma unroll
  for (int n = 0; n < PT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < 2 * JT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;

  for (int n0 = 0; n0 < a.N; n0 += kWideN) {
    const int nw = min(kWideN, a.N - n0);
    __syncthreads();  // the previous slab's readers are done
    load_rows(Bs, sn, a.b + bb * a.bs.b + h * a.bs.h + n0, a.bs.s, t0, rows,
              L, nw, kWideN, a.vb);
    load_rows(Cs, sn, a.c + bb * a.cs.b + h * a.cs.h + n0, a.cs.s, t0, rows,
              L, nw, kWideN, a.vc);
    cp_async_commit();
    // the S_in rows n0 .. n0 + nw - 1 of the P tile, as high and low parts
    // (zero past N and past P)
    if (v4) {
      for (int idx = threadIdx.x; idx < kWideN * TP / 4; idx += kMmaThreads) {
        const int n = idx / (TP / 4), p = 4 * (idx % (TP / 4));
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (n < nw && p < pw)
          v = __ldg(reinterpret_cast<const float4*>(
              st + (size_t)(n0 + n) * a.P + p));
        unsigned hi[2], lw[2];
        split_pack(v.x, v.y, hi[0], lw[0]);
        split_pack(v.z, v.w, hi[1], lw[1]);
        *reinterpret_cast<uint2*>(Sh + n * sx + p) = make_uint2(hi[0], hi[1]);
        *reinterpret_cast<uint2*>(Sl + n * sx + p) = make_uint2(lw[0], lw[1]);
      }
    } else {
      for (int idx = threadIdx.x; idx < kWideN * TP / 2; idx += kMmaThreads) {
        const int n = idx / (TP / 2), p = 2 * (idx % (TP / 2));
        const bool in = n < nw;
        const float v0 = in && p < pw ? st[(size_t)(n0 + n) * a.P + p] : 0.f;
        const float v1 =
            in && p + 1 < pw ? st[(size_t)(n0 + n) * a.P + p + 1] : 0.f;
        unsigned hi, lw;
        split_pack(v0, v1, hi, lw);
        *reinterpret_cast<unsigned*>(Sh + n * sx + p) = hi;
        *reinterpret_cast<unsigned*>(Sl + n * sx + p) = lw;
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if (!active) continue;
    unsigned cf[kWideN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kWideN / 16; ++kk)
      ldsm_x4(c_base + (i0 * sn + kk * 16) * sizeof(bf16), cf[kk]);
    // inter-chunk: c_i . S_in over this slab
#pragma unroll
    for (int kk = 0; kk < kWideN / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < PT; n += 2) {
        unsigned sh[4], sl[4];
        const unsigned off = (kk * 16 * sx + n * 8) * sizeof(bf16);
        ldsm_x4_trans(sh_base + off, sh);
        ldsm_x4_trans(sl_base + off, sl);
        mma_bf16(acc[n], cf[kk], sh[0], sh[1]);
        mma_bf16(acc[n], cf[kk], sl[0], sl[1]);
        mma_bf16(acc[n + 1], cf[kk], sh[2], sh[3]);
        mma_bf16(acc[n + 1], cf[kk], sl[2], sl[3]);
      }
    }
    // scores: c_i . b_j over this slab, for the j tiles at or below the
    // diagonal
#pragma unroll
    for (int jt = 0; jt < JT; ++jt) {
      if (jt > mt) continue;
#pragma unroll
      for (int kk = 0; kk < kWideN / 16; ++kk) {
        unsigned bfr[4];
        ldsm_x4(b_base + (jt * 16 * sn + kk * 16) * sizeof(bf16), bfr);
        mma_bf16(s[2 * jt], cf[kk], bfr[0], bfr[1]);
        mma_bf16(s[2 * jt + 1], cf[kk], bfr[2], bfr[3]);
      }
    }
  }
  if (!active) return;

  const float seg_i[2] = {seg[i0 + g], seg[i0 + g + 8]};  // log2 units
  const float e0 = eseg[i0 + g], e1 = eseg[i0 + g + 8];
#pragma unroll
  for (int n = 0; n < PT; ++n) {
    acc[n][0] *= e0;
    acc[n][1] *= e0;
    acc[n][2] *= e1;
    acc[n][3] *= e1;
  }
  // intra-chunk: the decay-masked scores times x
#pragma unroll
  for (int jt = 0; jt < JT; ++jt) {
    if (jt > mt) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int j0 = 16 * jt + 8 * j + 2 * tq;
      const float seg_j[2] = {seg[j0], seg[j0 + 1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + g + 8 * (e >> 1);
        s[2 * jt + j][e] =
            j0 + (e & 1) <= i
                ? s[2 * jt + j][e] * exp2_approx(seg_i[e >> 1] - seg_j[e & 1])
                : 0.f;
      }
    }
    unsigned ah[4], al[4];
    split_pack(s[2 * jt][0], s[2 * jt][1], ah[0], al[0]);
    split_pack(s[2 * jt][2], s[2 * jt][3], ah[1], al[1]);
    split_pack(s[2 * jt + 1][0], s[2 * jt + 1][1], ah[2], al[2]);
    split_pack(s[2 * jt + 1][2], s[2 * jt + 1][3], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < PT; n += 2) {
      unsigned xf[4];
      ldsm_x4_trans(x_base + (jt * 16 * sx + n * 8) * sizeof(bf16), xf);
      mma_bf16(acc[n], ah, xf[0], xf[1]);
      mma_bf16(acc[n], al, xf[0], xf[1]);
      mma_bf16(acc[n + 1], ah, xf[2], xf[3]);
      mma_bf16(acc[n + 1], al, xf[2], xf[3]);
    }
  }

  bf16* yb = a.y + bb * a.ys.b + h * a.ys.h + p0;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = i0 + g + 8 * rr;
    if (i >= rows) continue;
    bf16* yrow = yb + (long long)(t0 + i) * a.ys.s;
#pragma unroll
    for (int n = 0; n < PT; ++n) {
      const int col = n * 8 + 2 * tq;
      if (col + 1 < pw && (a.P & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(yrow + col) =
            __floats2bfloat162_rn(acc[n][2 * rr], acc[n][2 * rr + 1]);
      } else {
        if (col < pw) yrow[col] = __float2bfloat16(acc[n][2 * rr]);
        if (col + 1 < pw)
          yrow[col + 1] = __float2bfloat16(acc[n][2 * rr + 1]);
      }
    }
  }
}

// whether rows of width `width` of a bf16 tensor at `p` with these
// strides may be copied as 16-byte pieces
inline int rows_vec(const void* p, Strides s, int width) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && width % 8 == 0 &&
         s.b % 8 == 0 && s.s % 8 == 0 && s.h % 8 == 0;
}
inline bool same(Strides u, Strides v) {
  return u.b == v.b && u.s == v.s && u.h == v.h;
}

// the three passes; Wide picks pass 3's wide instance
template <class A, int PT, bool Wide = false>
int launch_chunked(const ChunkArgs& a, int B, float* fin,
                   cudaStream_t stream) {
  void (*scan)(const ChunkArgs);
  size_t s3;
  if constexpr (Wide) {
    scan = ssd_chunk_scan_wide<A, PT>;
    s3 = wide_layout(a.L).total;
  } else {
    scan = ssd_chunk_scan<A, PT>;
    s3 = scan_layout(a.L, a.Pp, a.Np, a.bx, a.cb).total;
  }
  const size_t s1 = state_layout(a.L, a.tp, a.tn, a.bx).total;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_state<A, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s3);
  if (e != cudaSuccess) return (int)e;
  ssd_chunk_state<A, PT>
      <<<dim3(a.nc * a.ptiles * a.ntiles, a.H, B), kMmaThreads, s1, stream>>>(
          a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int NP = a.N * a.P;
  ssd_state_pass<<<dim3((NP + kPassThreads - 1) / kPassThreads, a.H, B),
                   kPassThreads, 0, stream>>>(a.ws, a.decay, fin, a.H, a.nc,
                                              NP);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(Wide ? a.nc * a.ptiles : a.nc, a.H, B);
  scan<<<grid, kMmaThreads, s3, stream>>>(a);
  return (int)cudaGetLastError();
}

// The instance for P: PT n8 tiles, P rounded up to 16 at most 8 PT; the
// paths' and the GPU tests' widths (P = 80 on the main path).
template <class A>
int launch_chunked_p(const ChunkArgs& a, int B, float* fin,
                     cudaStream_t stream) {
  if (wide_route(a.P, a.N))
    return launch_chunked<A, kWidePT, true>(a, B, fin, stream);
  if (a.Pp <= 32) return launch_chunked<A, 4>(a, B, fin, stream);
  if (a.Pp <= 64) return launch_chunked<A, 8>(a, B, fin, stream);
  if (a.Pp <= 80) return launch_chunked<A, 10>(a, B, fin, stream);
  return launch_chunked<A, kMaxPT>(a, B, fin, stream);
}

int launch_chunked_all(const void* x, const void* la, const void* bm,
                       const void* cm, void* y, float* fin, float* ws,
                       int la_dtype, int B, int S, int H, int P, int N,
                       const long long* st, int L, cudaStream_t stream) {
  ChunkArgs a;
  a.x = static_cast<const bf16*>(x);
  a.b = static_cast<const bf16*>(bm);
  a.c = static_cast<const bf16*>(cm);
  a.la = la;
  a.y = static_cast<bf16*>(y);
  a.S = S;
  a.H = H;
  a.P = P;
  a.N = N;
  a.L = L;
  a.Pp = round16(P);
  a.Np = round16(N);
  a.nc = (S + L - 1) / L;
  a.ws = ws;
  a.decay = ws + (size_t)B * H * a.nc * N * P;
  a.xs = Strides{st[0], st[1], st[2]};
  a.as = Strides{st[3], st[4], st[5]};
  a.bs = Strides{st[6], st[7], st[8]};
  a.cs = Strides{st[9], st[10], st[11]};
  a.ys = Strides{st[12], st[13], st[14]};
  a.vx = rows_vec(x, a.xs, P);
  a.vb = rows_vec(bm, a.bs, N);
  a.vc = rows_vec(cm, a.cs, N);
  const bool wide = wide_route(P, N);
  a.tp = wide ? 8 * kWidePT : a.Pp;
  a.tn = wide ? kWideN : a.Np;
  a.ptiles = (a.Pp + a.tp - 1) / a.tp;
  a.ntiles = (a.Np + a.tn - 1) / a.tn;
  // the wide route copies b and c slab by slab from their own pointers
  a.bx = !wide && bm == x && same(a.bs, a.xs) && N % 16 == 0 && N <= P;
  a.cb = !wide && cm == bm && same(a.cs, a.bs);
  return la_dtype == kFloat32 ? launch_chunked_p<float>(a, B, fin, stream)
                              : launch_chunked_p<bf16>(a, B, fin, stream);
}

}  // namespace
}  // namespace repro_torch

// x: (B, S, H, P); log_a: (B, S, H); b, c: (B, S, H, N); y: (B, S, H, P)
// in x's dtype; final_state: (B, H, N, P) fp32, contiguous.  x, b, c, y
// share the dtype code `dtype` and have a contiguous last axis; log_a has
// the dtype code `la_dtype`.  strides: 15 element strides, (batch,
// sequence, head) for x, log_a, b, c, y in that order; y is contiguous.
// chunk is the chunk length L: for float32 at least 1; for bfloat16 a
// multiple of 16 up to 256 with P <= 128 and N <= 64, or up to 128 with P
// and N up to 384 (the wide route), and workspace holds
// B * H * nc * (N * P + 1) floats, nc = ceil(S / L) (float32 reads none).
// smem_bytes is the caller's footprint figure and must equal this file's.
// Returns a cudaError_t code (0 on success).
extern "C" int ssd_forward(const void* x, const void* log_a, const void* b,
                           const void* c, void* y, void* final_state,
                           void* workspace, int dtype, int la_dtype, int B,
                           int S, int H, int P, int N,
                           const long long* strides, int L,
                           long long smem_bytes, void* stream) {
  using namespace repro_torch;
  if ((dtype != kFloat32 && dtype != kBFloat16) ||
      (la_dtype != kFloat32 && la_dtype != kBFloat16) || L < 1 || S < 1 ||
      P < 1 || N < 1 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  float* fin = static_cast<float*>(final_state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    const size_t smem = ssd_smem_floats(L, P, N) * sizeof(float);
    if ((long long)smem != smem_bytes) return (int)cudaErrorInvalidValue;
    return la_dtype == kFloat32
               ? launch_simt<float>(x, log_a, b, c, y, fin, B, S, H, P, N,
                                    strides, L, smem, s)
               : launch_simt<bf16>(x, log_a, b, c, y, fin, B, S, H, P, N,
                                   strides, L, smem, s);
  }
  if (L % 16 || L > kMaxChunk || P > kMaxWidth || N > kMaxWidth ||
      (wide_route(P, N) && L > kWideMaxChunk) ||
      (long long)chunked_smem(L, P, N) != smem_bytes)
    return (int)cudaErrorInvalidValue;
  return launch_chunked_all(x, log_a, b, c, y, fin,
                            static_cast<float*>(workspace), la_dtype, B, S, H,
                            P, N, strides, L, s);
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
