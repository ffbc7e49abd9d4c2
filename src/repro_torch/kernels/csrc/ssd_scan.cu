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
// A second entry point, ssd_decode, runs the one-token step a decode takes
// (its own section at the end, before the entry points).
//
// Three routes behind the one entry point ssd_forward, chosen by x's dtype
// and the widths:
//
// * bfloat16, P <= 128 and N <= 64 (the narrow route, Mamba-2's heads):
//   the chunk-parallel form of the recurrence, as GPU Mamba-2
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
//   zero-padded to multiples of 16 in shared memory, and the instances
//   hold P's n8 tiles as a template parameter (4, 8, 10 or 16).  The
//   workspace (B, H, nc, N, P) fp32 states and (B, H, nc) decays is the
//   caller's.
// * bfloat16, P > 128 or N > 64, each up to 384, chunk L <= 128 (the wide
//   route: the xLSTM's mLSTM runs P = N = 384).  Bound by bytes too: at
//   (1, 2048, 4, 384) x, b, c and y are 6.3 MB each and the final state
//   2.4 MB, 27.6 MB or 8.2 us at 3.35 TB/s, against 6.4 GFLOP of products
//   (6.5 us at the bf16 peak) of which the high/low splits below double a
//   part.  Two launches, each a warp-specialised Hopper kernel: producer
//   warps keep TMA tile loads (128-byte swizzled boxes of 64 columns) in
//   flight through mbarrier rings, consumer warpgroups multiply on wgmma
//   with their operands in shared memory.
//   A. ssd_wide_state, grid (64 x 128 state tile, head, batch): walks the
//      chunks in order with its tile of the running state in a
//      warpgroup's accumulators, as the TPU kernel's grid walks them with
//      the whole state in VMEM; per chunk it hands S_in[c] (c >= 1) to the
//      workspace as a high and a low bf16 part by TMA stores, then
//      state = state exp(total) + (b w)^T x.  Two stager warpgroups and a
//      weights warp prepare the next chunk's (b w)^T while the current
//      chunk's products run.  The last state is the final state, in
//      fp32.
//   B. ssd_wide_scan, grid (chunk x 192-wide P tile, head, batch: 128
//      CTAs, one wave, at the shape above): two consumer warpgroups of 64
//      rows; N streams through the ring in slabs of 64 (c, b and the S_in
//      slab's two parts), c b^T and c . S_in on wgmma, then
//      y = exp(seg_i) (c . S_in) + G x with G in registers.  It is
//      launched as pass A's programmatic dependent: its CTAs start on the
//      SMs pass A leaves free, load x and their first slabs of c and b,
//      and wait for pass A's end (griddepcontrol.wait) before they ask
//      for S_in.
//   So the chunk states cross memory twice (pass A writes them, pass B
//   reads them), as high and low bf16 parts, which take the bytes of
//   fp32: B H (nc - 1) N P 4 bytes each way, 35.4 MB at the shape above,
//   where the three-pass form moved four fp32 crossings (151 MB); pass
//   A's loads and stores keep their lines in L2 for pass B (evict_last),
//   pass B's last reads let theirs go (evict_first).  The
//   hand-off needs no flag and no wait between CTAs of one grid, and sums
//   run in a fixed order, so two calls give equal bits.  Which operands
//   keep a high/low split, and why, is noted at each pass.
// * float32: ssd_kernel, the SIMT kernel (fp32 FMA on the CUDA cores, one
//   CTA per (batch, head) looping over the chunks with the state in shared
//   memory), which keeps fp32 products and so the fp32 tolerance of the
//   tests; no TF32 and no bf16 product is allowed there.

#include "hopper.cuh"

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
               int N, int hpg, Strides xs, Strides as, Strides bs,
               Strides cs, Strides ys, int L) {
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
  // head h reads the maps of its group, h / hpg (hpg heads a group)
  const T* bb = bm + b * bs.b + (h / hpg) * bs.h;
  const T* cb = cm + b * cs.b + (h / hpg) * cs.h;
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
                int hpg, const long long* st, int L, size_t smem,
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
      static_cast<float*>(y), fin, S, H, P, N, hpg, xs, as, bs, cs, ys, L);
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
// the wide route (P > 8 kMaxPT or N > 16 kMaxNK, each up to kMaxWidth, a
// chunk of at most kWideMaxChunk): TMA boxes of kBox bf16 columns (one
// 128-byte swizzled row a step) by kWideMaxChunk rows; pass A keeps state
// tiles of kWideTN rows by kStateTP columns, pass B output tiles of
// kScanTP columns and streams N in slabs of kWideTN
constexpr int kBox = 64;
constexpr int kWideTN = kBox;
constexpr int kStateTP = 2 * kBox;
constexpr int kScanTP = 3 * kBox;
constexpr int kWideMaxChunk = 128;
constexpr int kMaxWidth = 384;
// pass A's rings: b's box of a chunk, x's two boxes of a chunk
constexpr int kBStages = 3, kXStages = 2;
constexpr int kScanStages = 2;   // pass B's ring: c, b and S_in of a slab
// pass A: the MMA warpgroup, two stager warpgroups, then a warp that loads
// b, one that stores S_in, one that computes the weights, one that loads x
constexpr int kStateThreads = 4 * 128;
constexpr int kMmaRegs = 168, kOtherRegs = 112;  // 128 + 3 * 128 threads
// two consumer warpgroups and a producer warpgroup, one thread of which
// issues the loads: wgmma kernels hold registers by whole warpgroups, and
// setmaxnreg hands the producer's to the consumers
constexpr int kScanThreads = 3 * 128;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kSmallBytes = 2048;  // barriers, weights, seg (both passes)

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
inline bool wide_route(int P, int N) {
  return P > 8 * kMaxPT || N > 16 * kMaxNK;
}
// The wide route's dynamic shared memory: 1024 bytes of slack to align
// the base (TMA's 128-byte swizzle repeats every 1024 bytes and the wgmma
// descriptors assume it), the tiles, then kSmallBytes.  A box is
// kWideMaxChunk rows of 128 bytes whatever the chunk (rows L .. 127 stay
// zero: wgmma takes 64-row tiles and the steps of a k16 block); an S_in
// box kWideTN rows.  Pass A: b's ring of boxes, x's ring of two boxes a
// stage, then two buffers of (b w)^T as high and low parts, each two
// boxes of kWideTN rows, then S_in[c]'s high and low parts on their way
// out, two boxes each; pass B: x's three boxes, then per stage c's and
// b's box and the S_in slab's three, high part then low part.
constexpr size_t kBoxBytes = (size_t)kWideMaxChunk * 2 * kBox;
constexpr size_t kSBoxBytes = (size_t)kWideTN * 2 * kBox;
__host__ __device__ constexpr size_t wide_state_ring() {
  return (kBStages + 2 * kXStages) * kBoxBytes;
}
__host__ __device__ constexpr size_t wide_state_tiles() {
  return wide_state_ring() + (2 * 4 + 4) * kSBoxBytes;
}
__host__ __device__ constexpr size_t wide_scan_stage() {
  return 2 * kBoxBytes + 2 * 3 * kSBoxBytes;
}
__host__ __device__ constexpr size_t wide_scan_tiles() {
  return 3 * kBoxBytes + kScanStages * wide_scan_stage();
}
constexpr size_t kWideStateSmem = 1024 + wide_state_tiles() + kSmallBytes;
constexpr size_t kWideScanSmem = 1024 + wide_scan_tiles() + kSmallBytes;
static_assert(kWideScanSmem <= 232448 && kWideStateSmem <= 232448,
              "the wide route's tiles fit the card's shared memory");
// kernels/ssd_scan.py smem_bytes() computes the same figure for the
// autotuner's pruning: the larger of the two passes where b and c have
// rows of their own (a narrow launch that reads them from x's takes less)
inline size_t chunked_smem(int L, int P, int N) {
  if (wide_route(P, N))
    return kWideStateSmem > kWideScanSmem ? kWideStateSmem : kWideScanSmem;
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
  int hpg;  // heads a group of b and c: head h reads group h / hpg
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

// Pass 1: the local state of one (chunk, head, batch), s = (b w)^T x.  Warp
// w computes state rows 16 (w % 4) .. + 15 against one half of P's n8
// tiles: A = b^T by ldmatrix.trans, scaled by each step's weight in
// registers and split into high and low parts; B = x by ldmatrix.trans.
// PT is the n8 tiles the instance holds (P rounded up to 16 <= 8 PT).
template <class A, int PT>
__global__ void __launch_bounds__(kMmaThreads, 2)
    ssd_chunk_state(const ChunkArgs a) {
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  const int L = a.L, sx = a.Pp + 8, sn = a.Np + 8;
  const Layout lo = state_layout(L, a.Pp, a.Np, a.bx);
  bf16* Xs = reinterpret_cast<bf16*>(ssd_smem + lo.x);
  float* w = reinterpret_cast<float*>(ssd_smem + lo.seg);
  bf16* Bs = reinterpret_cast<bf16*>(ssd_smem + lo.b);
  const int ic = blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int t0 = ic * L, rows = min(L, a.S - t0);

  load_rows(Xs, sx, a.x + bb * a.xs.b + h * a.xs.h, a.xs.s, t0, rows, L,
            a.P, a.Pp, a.vx);
  if (!a.bx)
    load_rows(Bs, sn, a.b + bb * a.bs.b + (h / a.hpg) * a.bs.h, a.bs.s, t0,
              rows, L, a.N, a.Np, a.vb);
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
  if (threadIdx.x == 0) a.decay[slice] = expf(total);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int mt = warp % 4, pt = a.Pp / 8;
  const int half = (pt / 2 + 1) / 2 * 2;  // n8 tiles of the first half
  const int n_lo = warp < 4 ? 0 : half, n_hi = warp < 4 ? half : pt;
  if (mt >= a.Np / 16) return;
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
  float* out = a.ws + slice * a.N * a.P;
#pragma unroll
  for (int n = 0; n < PT; ++n) {
    if (n < n_lo || n >= n_hi) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * mt + g + 8 * (e >> 1);
      const int col = n * 8 + 2 * tq + (e & 1);
      if (row < a.N && col < a.P) out[row * a.P + col] = acc[n][e];
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
    load_rows(Bs, sn, a.b + bb * a.bs.b + (h / a.hpg) * a.bs.h, a.bs.s, t0,
              rows, L, a.N, a.Np, a.vb);
  if (!a.cb)
    load_rows(Cs, sn, a.c + bb * a.cs.b + (h / a.hpg) * a.cs.h, a.cs.s, t0,
              rows, L, a.N, a.Np, a.vc);
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

// ---------------------------------------------------------------------------
// The wide route: warp-specialised wgmma passes fed by TMA
// ---------------------------------------------------------------------------

struct WideArgs {
  // x, b, c: 4-d maps (width, head, step, batch), boxes of kBox columns by
  // L steps; S_in: a 3-d map (P, N, 2 state slot + part), boxes of kBox x
  // kWideTN
  CUtensorMap mx, mb, mc, ms;
  const void* la;
  bf16* y;
  bf16* ws;    // (B, H, nc - 1, 2, N, Pw) S_in[1 ..], high and low parts
  float* fin;  // (B, H, N, P)
  int S, H, P, N, L, nc, Pw;
  // 1, or 0 where the tensor's head (batch) stride is 0: the map then
  // holds one head (batch) and every CTA reads coordinate 0
  int xh, xb, bh, bb, ch, cb;
  Strides as, ys;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}
// zero bytes [from, to) of a shared-memory tile, 16 at a time, by the
// block's threads
__device__ __forceinline__ void zero_bytes(unsigned char* p, size_t from,
                                           size_t to) {
  for (size_t o = from + 16 * threadIdx.x; o < to; o += 16 * blockDim.x)
    *reinterpret_cast<uint4*>(p + o) = make_uint4(0, 0, 0, 0);
}
// the inclusive cumulative sum over a warpgroup's 128 threads of v (one
// step each): a warp scan by shuffles, then the totals of the warps
// before, from `tot` (4 floats) after a barrier `bar` over the
// warpgroup.  Returns the thread's sum; *all is the warpgroup's total.
__device__ __forceinline__ float wg_cumsum(float v, float* tot, int bar,
                                           float* all) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float n = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += n;
  }
  if (lane == 31) tot[warp] = v;
  named_sync(bar, 128);
  float base = 0.f, sum = 0.f;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    base += w < warp ? tot[w] : 0.f;
    sum += tot[w];
  }
  *all = sum;
  return base + v;
}
// Pass A: one (N, P) state tile of kWideTN x kStateTP of a (head, batch),
// walking its chunks in order as the TPU kernel's grid walks them, the
// running state in the accumulators of one warpgroup (the MMA warpgroup).
// Per chunk c it hands on S_in[c] (the state before the chunk, c >= 1) in
// bf16 to the workspace, then state = state exp(total) + (b w)^T x on
// wgmma, A and B from shared memory.  A = (b w)^T, b's rows times each
// step's weight w_j = exp(total - seg_j), is staged by two stager
// warpgroups, one 64-step half each, into a ring of two buffers while the
// previous chunk's products run, so the walk waits on the tensor cores and
// not on the staging: b^T by ldmatrix.trans from b's swizzled box, scaled
// in registers, stored by stmatrix as a high and a low bf16 part (two
// products: the final state is held at the fp32 tolerance, and one bf16
// rounding of b w would cost 8 bits of it).  The MMA warpgroup writes
// each S_in[c] from its accumulators to shared memory as a high and a
// low bf16 part while the chunk's products run (pass B multiplies both,
// so S_in keeps about 16 bits of the fp32 state the TPU kernel keeps in
// VMEM, whatever b's scale).  The fourth warpgroup's warps: two
// producers keep b (for the stagers) and x (for the MMA warpgroup) of the
// chunks ahead in flight by TMA, each in a ring of its own; a store warp
// takes each S_in[c] out of shared memory by TMA stores; a weights warp
// computes each chunk's w.  The MMA warpgroup takes the others' spare
// registers (setmaxnreg).
template <class A>
__global__ void __launch_bounds__(kStateThreads, 1)
    ssd_wide_state(const __grid_constant__ WideArgs a) {
  extern __shared__ __align__(16) unsigned char wide_raw[];
  unsigned char* sm = align1024(wide_raw);
  const int L = a.L;
  // b's and x's rings: loaded, used
  uint64_t* bfull = reinterpret_cast<uint64_t*>(sm + wide_state_tiles());
  uint64_t* bempty = bfull + kBStages;
  uint64_t* xfull = bempty + kBStages;
  uint64_t* xempty = xfull + kXStages;
  uint64_t* afull = xempty + kXStages;     // A buffer staged, per buffer
  uint64_t* aempty = afull + 2;            // A buffer multiplied
  uint64_t* sfull = aempty + 2;            // S_in[c] written to sout
  uint64_t* sempty = sfull + 1;            // ... and stored from it
  uint64_t* wfull = sempty + 1;            // weights written, per buffer
  uint64_t* wempty = wfull + 2;            // weights used
  float* atot = reinterpret_cast<float*>(wempty + 2);  // A's chunk total
  float* wtot = atot + 2;   // the weights' chunk total, per buffer
  float* wbuf = wtot + 2;   // per buffer: 128 weights
  const int h = blockIdx.y, bz = blockIdx.z;
  const int ptiles = (a.P + kStateTP - 1) / kStateTP;
  const int p0 = blockIdx.x % ptiles * kStateTP;
  const int n0 = blockIdx.x / ptiles * kWideTN;
  const bool two = p0 + kBox < a.P;  // x's second box holds columns
  const size_t bhs = (size_t)bz * a.H + h;
  // b's ring stage s; x's ring stage s, its first and second box
  auto bring = [&](int s) { return sm + s * kBoxBytes; };
  auto xring = [&](int s, int k) {
    return sm + (kBStages + 2 * s + k) * kBoxBytes;
  };
  // A buffer u: high parts (k boxes 0, 1), then low parts
  auto abuf = [&](int u, int k) {
    return sm + wide_state_ring() + (4 * u + k) * kSBoxBytes;
  };
  // S_in[c] on its way to the workspace: the high part's two boxes of 64
  // columns, then the low part's
  unsigned char* sout = sm + wide_state_ring() + 8 * kSBoxBytes;
  // ssd_wide_scan may start on the SMs this grid leaves free; it waits for
  // this grid's end before it reads S_in
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBStages; ++s) {
      mbar_init(&bfull[s], 1);
      mbar_init(&bempty[s], 256);
    }
    for (int s = 0; s < kXStages; ++s) {
      mbar_init(&xfull[s], 1);
      mbar_init(&xempty[s], 128);
    }
    for (int u = 0; u < 2; ++u) {
      mbar_init(&afull[u], 256);
      mbar_init(&aempty[u], 128);
    }
    mbar_init(sfull, 128);
    mbar_init(sempty, 1);
    for (int u = 0; u < 2; ++u) {
      mbar_init(&wfull[u], 32);
      mbar_init(&wempty[u], 256);
    }
    mbar_fence_init();
  }
  // rows L .. 127 stay zero, and x's second box where it would lie wholly
  // past P (TMA writes neither)
  for (int s = 0; s < kBStages; ++s)
    zero_bytes(bring(s), (size_t)L * 2 * kBox, kBoxBytes);
  for (int s = 0; s < kXStages; ++s)
    for (int k = 0; k < 2; ++k)
      zero_bytes(xring(s, k), k == 1 && !two ? 0 : (size_t)L * 2 * kBox,
                 kBoxBytes);
  fence_proxy_async();
  __syncthreads();

  // the roles by warp, uniform to the compiler (a branch it cannot prove
  // warp-uniform makes it serialise the wgmma that follow)
  const int wid = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int wg = wid >> 2, warp = wid & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int r0 = 16 * warp + g;  // a thread's state rows r0, r0 + 8

  if (wg > 0)  // their registers go to the MMA warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kOtherRegs));
  if (wid == 13) {  // the store warp: S_in[c]'s two parts out by TMA
    if (lane == 0) {
      for (int ic = 1; ic < a.nc; ++ic) {
        mbar_wait(sfull, (ic - 1) & 1);
        const int slot = 2 * ((int)(bhs * (a.nc - 1)) + ic - 1);
        const uint64_t keep = l2_evict_last();  // ssd_wide_scan reads it
        for (int part = 0; part < 2; ++part) {
          unsigned char* box = sout + 2 * part * kSBoxBytes;
          tma_store_3d(&a.ms, box, p0, n0, slot + part, keep);
          if (two)
            tma_store_3d(&a.ms, box + kSBoxBytes, p0 + kBox, n0, slot + part,
                         keep);
        }
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(sempty);
      }
      bulk_wait();
    }
    return;
  }
  if (wid == 14) {  // the weights warp: 4 steps of each chunk a lane
    const A* la = static_cast<const A*>(a.la) + bz * a.as.b + h * a.as.h;
    float v[4], nv[4];
    auto load = [&](int ic, float (&out)[4]) {
      const int t0 = ic * L, rows = min(L, a.S - t0);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = 4 * lane + k;
        out[k] = t < rows ? to_float(la[(long long)(t0 + t) * a.as.s]) : 0.f;
      }
    };
    load(0, nv);
    for (int ic = 0; ic < a.nc; ++ic) {
      const int u = ic & 1, rows = min(L, a.S - ic * L);
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = nv[k];
      if (ic + 1 < a.nc) load(ic + 1, nv);  // ahead of its use
      // the lane's inclusive sums, then the lanes' before it
#pragma unroll
      for (int k = 1; k < 4; ++k) v[k] += v[k - 1];
      float run = v[3];
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float n = __shfl_up_sync(0xffffffffu, run, off);
        if (lane >= off) run += n;
      }
      const float before = run - v[3];
      const float total = __shfl_sync(0xffffffffu, run, 31);
      mbar_wait(&wempty[u], (ic >> 1 & 1) ^ 1);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = 4 * lane + k;
        wbuf[128 * u + t] =
            t < rows ? exp2_approx((total - before - v[k]) * kLog2e) : 0.f;
      }
      if (lane == 0) wtot[u] = total;
      mbar_arrive(&wfull[u]);
    }
    return;
  }
  if (wid == 12 || wid == 15) {  // the producers of b and of x
    if (lane == 0) {
      const bool xs = wid == 15;
      const uint64_t keep = l2_evict_last();  // ssd_wide_scan reads them
      for (int ic = 0; ic < a.nc; ++ic) {
        const int t0 = ic * L;
        if (xs) {
          const int s = ic % kXStages, ph = ic / kXStages & 1;
          mbar_wait(&xempty[s], ph ^ 1);
          mbar_expect_tx(&xfull[s], (two ? 2 : 1) * L * 2 * kBox);
          tma_load_4d(xring(s, 0), &a.mx, &xfull[s], p0, h * a.xh, t0,
                      bz * a.xb, keep);
          if (two)
            tma_load_4d(xring(s, 1), &a.mx, &xfull[s], p0 + kBox, h * a.xh,
                        t0, bz * a.xb, keep);
        } else {
          const int s = ic % kBStages, ph = ic / kBStages & 1;
          mbar_wait(&bempty[s], ph ^ 1);
          mbar_expect_tx(&bfull[s], L * 2 * kBox);
          tma_load_4d(bring(s), &a.mb, &bfull[s], n0, h * a.bh, t0,
                      bz * a.bb, keep);
        }
      }
    }
    return;
  }

  if (wg > 0) {  // the stagers: half hf of each chunk's steps
    const int hf = wg - 1, t = threadIdx.x & 127;
    // the ldmatrix row of this lane in b's swizzled box: step
    // (lane & 7) + 8 (lane >> 4) of a k16 block, 16-byte column block
    // 2 warp + ((lane >> 3) & 1) (the warp's 16 state rows)
    const int lrow = (lane & 7) + 8 * (lane >> 4);
    const int lcol = ((2 * warp + ((lane >> 3) & 1)) ^ (lane & 7)) * 16;
    const int srow = 16 * warp + 8 * ((lane >> 3) & 1) + (lane & 7);
    for (int ic = 0; ic < a.nc; ++ic) {
      const int s = ic % kBStages, u = ic & 1, ph = ic >> 1 & 1;
      const float* w = wbuf + 128 * u;
      mbar_wait(&wfull[u], ph);
      mbar_wait(&aempty[u], ph ^ 1);
      mbar_wait(&bfull[s], ic / kBStages & 1);
      const unsigned char* bt = bring(s);
      unsigned char* hi = abuf(u, hf);
      unsigned char* lo = abuf(u, 2 + hf);
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        const int kk = 4 * hf + k4;
        unsigned af[4], ah[4], al[4];
        ldsm_x4_trans(smem_addr(bt + (16 * kk + lrow) * 2 * kBox + lcol),
                      af);
        const float2 w0 =
            *reinterpret_cast<const float2*>(w + 16 * kk + 2 * tq);
        const float2 w1 =
            *reinterpret_cast<const float2*>(w + 16 * kk + 2 * tq + 8);
        scale_split(af[0], w0, ah[0], al[0]);
        scale_split(af[1], w0, ah[1], al[1]);
        scale_split(af[2], w1, ah[2], al[2]);
        scale_split(af[3], w1, ah[3], al[3]);
        // the k16 block's A fragment is four 8x8 matrices (rows 0-7 and
        // 8-15 of the warp's 16, by k 0-7 and 8-15: 16-byte column blocks
        // 2 k4 and 2 k4 + 1 of the half's box); lane 8 m + r addresses
        // row r of matrix m
        const int off =
            srow * 128 + (((2 * k4 + (lane >> 4)) ^ (lane & 7)) << 4);
        stsm_x4(smem_addr(hi + off), ah[0], ah[1], ah[2], ah[3]);
        stsm_x4(smem_addr(lo + off), al[0], al[1], al[2], al[3]);
      }
      if (hf == 0 && t == 0) atot[u] = wtot[u];
      mbar_arrive(&wempty[u]);
      mbar_arrive(&bempty[s]);
      fence_proxy_async();
      mbar_arrive(&afull[u]);
    }
    return;
  }

  // the MMA warpgroup: S_in[c] leaves the accumulators as high and low
  // bf16 pairs and goes to sout while the chunk's products run
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kMmaRegs));
  float acc[64];
  unsigned sh[32], sl[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int ic = 0; ic < a.nc; ++ic) {
    const int s = ic % kXStages, u = ic & 1;
    mbar_wait(&afull[u], ic >> 1 & 1);
    const float decay = expf(atot[u]);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      split_pack(acc[2 * i], acc[2 * i + 1], sh[i], sl[i]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= decay;
    mbar_wait(&xfull[s], ic / kXStages & 1);
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kWideMaxChunk / 16; ++kk) {
      const uint64_t dx =
          sw128_desc(xring(s, 0) + kk * 16 * 2 * kBox, kBoxBytes, 1024);
      const int k = kk >> 2, o = 32 * (kk & 3);
      wgmma_ss_n128<1>(acc, sw128_desc(abuf(u, k) + o, 16, 1024), dx);
      wgmma_ss_n128<1>(acc, sw128_desc(abuf(u, 2 + k) + o, 16, 1024), dx);
    }
    wgmma_commit();
    if (ic > 0) {  // S_in[ic] (the state before this chunk) to sout
      mbar_wait(sempty, ((ic - 1) & 1) ^ 1);  // the last one has left it
      // n8 tiles 2 v and 2 v + 1, rows 0-7 and 8-15 of the warp's 16, are
      // the four matrices of one stmatrix; lane 8 m + r addresses row r of
      // matrix m
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const int m = lane >> 3, row = 16 * warp + 8 * (m & 1) + (lane & 7);
        const int nt = 2 * v + (m >> 1);  // the n8 tile, 0 .. 15
        unsigned char* at = sout + (nt >> 3) * kSBoxBytes + row * 128 +
                            (((nt & 7) ^ (lane & 7)) << 4);
        stsm_x4(smem_addr(at), sh[4 * v], sh[4 * v + 1], sh[4 * v + 2],
                sh[4 * v + 3]);
        stsm_x4(smem_addr(at + 2 * kSBoxBytes), sl[4 * v], sl[4 * v + 1],
                sl[4 * v + 2], sl[4 * v + 3]);
      }
      fence_proxy_async();
      mbar_arrive(sfull);
    }
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(&aempty[u]);
    mbar_arrive(&xempty[s]);
  }

  float* fo = a.fin + (bhs * a.N + n0) * a.P + p0;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int row = r0 + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * tq;
    if (n0 + row >= a.N) continue;
    if (p0 + col < a.P) fo[(size_t)row * a.P + col] = acc[i];
    if (p0 + col + 1 < a.P) fo[(size_t)row * a.P + col + 1] = acc[i + 1];
  }
}

// Pass B: the output columns p0 .. p0 + kScanTP - 1 of one (chunk, head,
// batch).  Two consumer warpgroups take 64 rows of the chunk each; one
// thread of a producer warpgroup brings x's tile once and, per slab of
// kWideTN state rows, c's and b's boxes and S_in[c]'s slab by TMA into a
// ring.  Per slab each warpgroup adds c b^T (the scores of its rows
// against the chunk's 128 steps) and c . S_in, both on wgmma with A and B
// in shared memory.  Then y = exp(seg_i) (c . S_in) + G x, with the
// decay-masked scores G in registers as the A operand (FA3's hand-on of
// P), G and S_in each in a high and a low bf16 part (two products each),
// so y keeps about 16 bits of every term as the narrow route's does.
// Branches around a wgmma depend on the warpgroup alone, which the
// compiler can see (chunk 0's S_in slab is zeros, multiplied all the same;
// the first warpgroup's scores past its rows are computed and masked).
template <class A>
__global__ void __launch_bounds__(kScanThreads, 1)
    ssd_wide_scan(const __grid_constant__ WideArgs a) {
  extern __shared__ __align__(16) unsigned char wide_raw[];
  unsigned char* sm = align1024(wide_raw);
  const int L = a.L;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + wide_scan_tiles());
  uint64_t* empty = full + kScanStages;
  uint64_t* xbar = empty + kScanStages;
  float* seg = reinterpret_cast<float*>(xbar + 1);  // log2 units
  float* eseg = seg + 128;
  float* tot = eseg + 128;
  const int ptiles = (a.P + kScanTP - 1) / kScanTP;
  const int ic = blockIdx.x / ptiles, h = blockIdx.y, bz = blockIdx.z;
  const int p0 = blockIdx.x % ptiles * kScanTP;
  const int t0 = ic * L, rows = min(L, a.S - t0);
  // x's and S_in's boxes that hold columns, the rest stay zero
  const int boxes = min(3, (a.P - p0 + kBox - 1) / kBox);
  const bool has_s = ic > 0;
  const int slabs = (a.N + kWideTN - 1) / kWideTN;
  auto xbox = [&](int k) { return sm + k * kBoxBytes; };
  auto st = [&](int s) { return sm + 3 * kBoxBytes + s * wide_scan_stage(); };
  // S_in's boxes of stage s: k 0-2 the high part, 3-5 the low part
  auto sbox = [&](int s, int k) {
    return st(s) + 2 * kBoxBytes + k * kSBoxBytes;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kScanStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init(xbar, 1);
    mbar_fence_init();
  }
  const size_t rows_l = (size_t)L * 2 * kBox;
  for (int k = 0; k < 3; ++k)
    zero_bytes(xbox(k), k < boxes ? rows_l : 0, kBoxBytes);
  for (int s = 0; s < kScanStages; ++s) {
    zero_bytes(st(s), rows_l, kBoxBytes);
    zero_bytes(st(s) + kBoxBytes, rows_l, kBoxBytes);
    for (int k = 0; k < 3; ++k)
      if (!has_s || k >= boxes) {
        zero_bytes(sbox(s, k), 0, kSBoxBytes);
        zero_bytes(sbox(s, 3 + k), 0, kSBoxBytes);
      }
  }
  fence_proxy_async();
  __syncthreads();

  const int wid = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  if (wid >= 8) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      // x and S_in are read here for the last time, c and b again by the
      // chunk's other P tiles
      const uint64_t last = l2_evict_first(), again = l2_evict_last();
      const int slot = ((int)((size_t)bz * a.H + h) * (a.nc - 1)) + ic - 1;
      const int pre = min(slabs, kScanStages);
      auto load_cb = [&](int sl) {  // c's and b's boxes of a slab
        const int s = sl % kScanStages;
        mbar_wait(&empty[s], (sl / kScanStages & 1) ^ 1);
        mbar_expect_tx(&full[s],
                       2 * L * 2 * kBox +
                           (has_s ? 2 * boxes * (int)kSBoxBytes : 0));
        tma_load_4d(st(s), &a.mc, &full[s], sl * kWideTN, h * a.ch, t0,
                    bz * a.cb, again);
        tma_load_4d(st(s) + kBoxBytes, &a.mb, &full[s], sl * kWideTN,
                    h * a.bh, t0, bz * a.bb, again);
      };
      auto load_s = [&](int sl) {  // the S_in slab's boxes, both parts
        if (has_s)
          for (int k = 0; k < 2 * boxes; ++k)
            tma_load_3d(sbox(sl % kScanStages, k < boxes ? k : 3 + k - boxes),
                        &a.ms, &full[sl % kScanStages],
                        p0 + (k < boxes ? k : k - boxes) * kBox,
                        sl * kWideTN, 2 * slot + (k >= boxes), last);
      };
      // the first slabs' c and b, and x, need nothing of ssd_wide_state:
      // they are asked for before it has finished (the launch lets this
      // kernel start while it runs), S_in only after
      for (int sl = 0; sl < pre; ++sl) load_cb(sl);
      mbar_expect_tx(xbar, boxes * L * 2 * kBox);
      for (int k = 0; k < boxes; ++k)
        tma_load_4d(xbox(k), &a.mx, xbar, p0 + k * kBox, h * a.xh, t0,
                    bz * a.xb, last);
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      for (int sl = 0; sl < slabs; ++sl) {
        if (sl >= pre) load_cb(sl);
        load_s(sl);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = wid >> 2, warp = wid & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  if (wg == 0) {  // seg and exp(seg) of the chunk's steps, in log2 units
    const int t = threadIdx.x;
    const A* la = static_cast<const A*>(a.la) + bz * a.as.b + h * a.as.h;
    const float v =
        t < rows ? to_float(la[(long long)(t0 + t) * a.as.s]) : 0.f;
    float total;
    const float sg = wg_cumsum(v, tot, 2, &total) * kLog2e;
    seg[t] = sg;
    eseg[t] = exp2_approx(sg);
  }
  named_sync(1, 256);

  float yacc[96], sacc[64];
#pragma unroll
  for (int i = 0; i < 96; ++i) yacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) sacc[i] = 0.f;
  for (int sl = 0; sl < slabs; ++sl) {
    const int s = sl % kScanStages;
    mbar_wait(&full[s], sl / kScanStages & 1);
    const unsigned char* cs = st(s) + wg * 64 * 2 * kBox;
    wgmma_fence();
    fence_regs(sacc);
    fence_regs(yacc);
#pragma unroll
    for (int kk = 0; kk < kWideTN / 16; ++kk) {
      const uint64_t dc = sw128_desc(cs + 32 * kk, 16, 1024);
      wgmma_ss_n128<0>(sacc, dc,
                       sw128_desc(st(s) + kBoxBytes + 32 * kk, 16, 1024));
      wgmma_ss_n192<1>(yacc, dc,
                       sw128_desc(sbox(s, 0) + kk * 16 * 2 * kBox,
                                  kSBoxBytes, 1024));
      wgmma_ss_n192<1>(yacc, dc,
                       sw128_desc(sbox(s, 3) + kk * 16 * 2 * kBox,
                                  kSBoxBytes, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);
    fence_regs(yacc);
    mbar_arrive(&empty[s]);
  }
  mbar_wait(xbar, 0);

  const int r0 = 64 * wg + 16 * warp + g;  // rows r0 and r0 + 8
  const float si[2] = {seg[r0], seg[r0 + 8]};
  const float ei[2] = {eseg[r0], eseg[r0 + 8]};
#pragma unroll
  for (int i = 0; i < 96; ++i) yacc[i] *= ei[(i >> 1) & 1];
  // G = scores exp(seg_i - seg_j) for j <= i, else 0, as A fragments:
  // the C fragments of n8 tiles 2 kk and 2 kk + 1 are k16 step kk's A
  // (the k16 blocks wholly above the warp's rows are zeros, and those
  // above the warpgroup's are left out of the product)
  unsigned ah[8][4], al[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    float gv[8] = {};
    if (16 * kk <= 64 * wg + 16 * warp + 15) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = 16 * kk + 8 * (e >> 2) + 2 * tq + (e & 1);
        const int i = r0 + 8 * ((e >> 1) & 1);
        if (j <= i)
          gv[e] = sacc[8 * kk + e] * exp2_approx(si[(e >> 1) & 1] - seg[j]);
      }
    }
    split_pack(gv[0], gv[1], ah[kk][0], al[kk][0]);
    split_pack(gv[2], gv[3], ah[kk][1], al[kk][1]);
    split_pack(gv[4], gv[5], ah[kk][2], al[kk][2]);
    split_pack(gv[6], gv[7], ah[kk][3], al[kk][3]);
  }
  wgmma_fence();
  fence_regs(yacc);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (kk >= 4 * (wg + 1)) break;
    const uint64_t dx = sw128_desc(xbox(0) + kk * 16 * 2 * kBox, kBoxBytes,
                                   1024);
    wgmma_rs_n192<1>(yacc, ah[kk], dx);
    wgmma_rs_n192<1>(yacc, al[kk], dx);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(yacc);

  bf16* yb = a.y + bz * a.ys.b + h * a.ys.h + p0;
  const bool pairs = (a.P & 1) == 0;
#pragma unroll
  for (int i = 0; i < 96; i += 2) {
    const int row = r0 + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * tq;
    if (row >= rows) continue;
    bf16* yrow = yb + (long long)(t0 + row) * a.ys.s;
    if (pairs && p0 + col + 1 < a.P) {
      *reinterpret_cast<unsigned*>(yrow + col) =
          pack_bf16(yacc[i], yacc[i + 1]);
    } else {
      if (p0 + col < a.P) yrow[col] = __float2bfloat16(yacc[i]);
      if (p0 + col + 1 < a.P) yrow[col + 1] = __float2bfloat16(yacc[i + 1]);
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

// the three passes of the narrow route
template <class A, int PT>
int launch_chunked(const ChunkArgs& a, int B, float* fin,
                   cudaStream_t stream) {
  const size_t s1 = state_layout(a.L, a.Pp, a.Np, a.bx).total;
  const size_t s3 = scan_layout(a.L, a.Pp, a.Np, a.bx, a.cb).total;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_state<A, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_chunk_scan<A, PT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s3);
  if (e != cudaSuccess) return (int)e;
  ssd_chunk_state<A, PT><<<dim3(a.nc, a.H, B), kMmaThreads, s1, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int NP = a.N * a.P;
  ssd_state_pass<<<dim3((NP + kPassThreads - 1) / kPassThreads, a.H, B),
                   kPassThreads, 0, stream>>>(a.ws, a.decay, fin, a.H, a.nc,
                                              NP);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_chunk_scan<A, PT>
      <<<dim3(a.nc, a.H, B), kMmaThreads, s3, stream>>>(a);
  return (int)cudaGetLastError();
}

// The instance for P: PT n8 tiles, P rounded up to 16 at most 8 PT; the
// paths' and the GPU tests' widths (P = 80 on the main path).
template <class A>
int launch_chunked_p(const ChunkArgs& a, int B, float* fin,
                     cudaStream_t stream) {
  if (a.Pp <= 32) return launch_chunked<A, 4>(a, B, fin, stream);
  if (a.Pp <= 64) return launch_chunked<A, 8>(a, B, fin, stream);
  if (a.Pp <= 80) return launch_chunked<A, 10>(a, B, fin, stream);
  return launch_chunked<A, kMaxPT>(a, B, fin, stream);
}

int launch_chunked_all(const void* x, const void* la, const void* bm,
                       const void* cm, void* y, float* fin, float* ws,
                       int la_dtype, int B, int S, int H, int P, int N,
                       int hpg, const long long* st, int L,
                       cudaStream_t stream) {
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
  a.hpg = hpg;
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
  a.bx = hpg == 1 && bm == x && same(a.bs, a.xs) && N % 16 == 0 && N <= P;
  a.cb = cm == bm && same(a.cs, a.bs);
  return la_dtype == kFloat32 ? launch_chunked_p<float>(a, B, fin, stream)
                              : launch_chunked_p<bf16>(a, B, fin, stream);
}

// cuTensorMapEncodeTiled, from the driver the runtime has loaded (the
// library links the runtime only)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 map of `rank` dimensions (at most 4) with 128-byte swizzled boxes
bool encode_map(CUtensorMap* m, const void* p, cuuint32_t rank,
                const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box) {
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode_tiled() &&
         encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                        const_cast<void*>(p), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a map of a (B, S, H, width) bf16 tensor with element strides st, boxes
// of kBox columns by L steps at (column, head, step, batch); a head or
// batch stride of 0 (a broadcast view) becomes a map of one head or batch
// that every CTA reads at coordinate 0 (*hm, *bm = 0)
bool encode_rows(CUtensorMap* m, const void* p, int B, int S, int H,
                 int width, Strides st, int L, int* hm, int* bm) {
  const cuuint64_t step = 2 * (cuuint64_t)st.s;
  const cuuint64_t dims[4] = {(cuuint64_t)width, st.h ? (cuuint64_t)H : 1,
                              (cuuint64_t)S, st.b ? (cuuint64_t)B : 1};
  const cuuint64_t strides[3] = {st.h ? 2 * (cuuint64_t)st.h : step, step,
                                 st.b ? 2 * (cuuint64_t)st.b : step};
  const cuuint32_t box[4] = {kBox, 1, (cuuint32_t)L, 1};
  *hm = st.h != 0;
  *bm = st.b != 0;
  return encode_map(m, p, 4, dims, strides, box);
}

// the wide route's two passes: the tensor maps, then pass A over the
// (state tile, head, batch) grid and pass B over (chunk, P tile, head,
// batch); ws holds B H (nc - 1) 2 N Pw bf16
template <class A>
int launch_wide(WideArgs& a, const void* x, const void* bm, const void* cm,
                int B, const long long* st, cudaStream_t stream) {
  const Strides xs{st[0], st[1], st[2]}, bs{st[6], st[7], st[8]},
      cs{st[9], st[10], st[11]};
  if (!encode_rows(&a.mx, x, B, a.S, a.H, a.P, xs, a.L, &a.xh, &a.xb) ||
      !encode_rows(&a.mb, bm, B, a.S, a.H, a.N, bs, a.L, &a.bh, &a.bb) ||
      !encode_rows(&a.mc, cm, B, a.S, a.H, a.N, cs, a.L, &a.ch, &a.cb))
    return (int)cudaErrorInvalidValue;
  if (a.nc > 1) {  // a slot per part of each S_in
    const cuuint64_t dims[3] = {(cuuint64_t)a.P, (cuuint64_t)a.N,
                                (cuuint64_t)B * a.H * (a.nc - 1) * 2};
    const cuuint64_t strides[2] = {2 * (cuuint64_t)a.Pw,
                                   2 * (cuuint64_t)a.Pw * a.N};
    const cuuint32_t box[3] = {kBox, kWideTN, 1};
    if (!encode_map(&a.ms, a.ws, 3, dims, strides, box))
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaFuncSetAttribute(
      ssd_wide_state<A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kWideStateSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_wide_scan<A>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kWideScanSmem);
  if (e != cudaSuccess) return (int)e;
  const int ntiles = (a.N + kWideTN - 1) / kWideTN;
  ssd_wide_state<A><<<dim3(ntiles * ((a.P + kStateTP - 1) / kStateTP), a.H,
                           B),
                      kStateThreads, kWideStateSmem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // programmatic dependent launch: pass B's CTAs may start once every CTA
  // of pass A has started, and wait in griddepcontrol.wait for its end
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.nc * ((a.P + kScanTP - 1) / kScanTP), a.H, B);
  cfg.blockDim = dim3(kScanThreads);
  cfg.dynamicSmemBytes = kWideScanSmem;
  cfg.stream = stream;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, ssd_wide_scan<A>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int launch_wide_all(const void* x, const void* la, const void* bm,
                    const void* cm, void* y, float* fin, void* ws,
                    int la_dtype, int B, int S, int H, int P, int N,
                    const long long* st, int L, cudaStream_t stream) {
  WideArgs a{};
  a.la = la;
  a.y = static_cast<bf16*>(y);
  a.ws = static_cast<bf16*>(ws);
  a.fin = fin;
  a.S = S;
  a.H = H;
  a.P = P;
  a.N = N;
  a.L = L;
  a.nc = (S + L - 1) / L;
  a.Pw = (P + 7) / 8 * 8;
  a.as = Strides{st[3], st[4], st[5]};
  a.ys = Strides{st[12], st[13], st[14]};
  return la_dtype == kFloat32
             ? launch_wide<float>(a, x, bm, cm, B, st, stream)
             : launch_wide<bf16>(a, x, bm, cm, B, st, stream);
}

// ---------------------------------------------------------------------------
// One-token decode: the recurrence's single step, in place
// ---------------------------------------------------------------------------
//
// Replaces no TPU kernel: the JAX reference's ssd_decode_step
// (src/repro/models/ssm.py:118) is plain jnp, left to XLA.  Per (row, head):
//   st = state * exp(log_a) + b x^T,   y = c . st,
// b and c of the head's group, the state (N, P) fp32.  What bounds it is
// bytes: the state read once and written once, 2 B H N P 4 bytes a call
// (124.8 MB at a 34-row zamba2-7b tick, 37.2 us at 3.35 TB/s), against
// 4 N P FLOPs a head.  One CTA per (row, head, tile of P columns): lanes
// run along the tile, 4 columns a lane by 16-byte loads and stores, and
// the row groups of lanes split N; a thread issues the loads of a batch of
// its rows (state, b, c) before its arithmetic, and writes st where it read
// the state, so the output may alias the input.  The state streams past
// the caches (ld/st .cs): nothing reads it again within the call.  Each
// thread's partial y over its rows goes to shared memory, and a thread per
// column sums the groups in order.  st takes the plain version's roundings
// (a product, a product, their sum: no contraction into an FMA), so it
// equals it where expf does; y sums N in another order.  The tile (all of
// P up to 128, fewer columns where the grid would be short) is the
// caller's, from the shape (kernels/ssd_scan.py decode_tile).

constexpr int kDecodeThreads = 256;
constexpr int kDecodeBatch = 4;  // state rows a thread loads before its arithmetic
constexpr int kDecodeMaxTile = 128;

// (batch, head) element strides of the decode's operands
struct DecodeStrides {
  long long b, h;
};

template <class T>
__global__ void __launch_bounds__(kDecodeThreads)
    ssd_decode_kernel(const float* state, const T* __restrict__ x,
                      const float* __restrict__ la, const T* __restrict__ bm,
                      const T* __restrict__ cm, float* out,
                      T* __restrict__ y, int N, int P, int hpg, int tile,
                      DecodeStrides ss, DecodeStrides xs, DecodeStrides as,
                      DecodeStrides bs, DecodeStrides cs, DecodeStrides os,
                      DecodeStrides ys) {
  __shared__ float4 part[kDecodeThreads];  // each thread's 4 columns of y
  const int quads = tile / 4;              // lanes across the tile
  const int groups = kDecodeThreads / quads;  // row groups: they split N
  const int q = threadIdx.x % quads, g = threadIdx.x / quads;
  const int h = blockIdx.y, b = blockIdx.z;
  const int p = blockIdx.x * tile + 4 * q;
  const float a = expf(la[b * as.b + h * as.h]);
  const T* bb = bm + b * bs.b + (h / hpg) * bs.h;
  const T* cb = cm + b * cs.b + (h / hpg) * cs.h;
  const float* sb = state + b * ss.b + h * ss.h + p;
  float* ob = out + b * os.b + h * os.h + p;

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (g < groups && p < P) {
    const T* xb = x + b * xs.b + h * xs.h + p;
    const float x0 = to_float(xb[0]), x1 = to_float(xb[1]),
                x2 = to_float(xb[2]), x3 = to_float(xb[3]);
    for (int n0 = g; n0 < N; n0 += groups * kDecodeBatch) {
      float4 sv[kDecodeBatch];
      float bv[kDecodeBatch], cv[kDecodeBatch];
#pragma unroll
      for (int k = 0; k < kDecodeBatch; ++k) {
        const int n = n0 + k * groups;
        if (n < N) {
          sv[k] = __ldcs(reinterpret_cast<const float4*>(sb + (size_t)n * P));
          bv[k] = to_float(bb[n]);
          cv[k] = to_float(cb[n]);
        }
      }
#pragma unroll
      for (int k = 0; k < kDecodeBatch; ++k) {
        const int n = n0 + k * groups;
        if (n < N) {
          float4 o;
          o.x = __fadd_rn(__fmul_rn(sv[k].x, a), __fmul_rn(bv[k], x0));
          o.y = __fadd_rn(__fmul_rn(sv[k].y, a), __fmul_rn(bv[k], x1));
          o.z = __fadd_rn(__fmul_rn(sv[k].z, a), __fmul_rn(bv[k], x2));
          o.w = __fadd_rn(__fmul_rn(sv[k].w, a), __fmul_rn(bv[k], x3));
          __stcs(reinterpret_cast<float4*>(ob + (size_t)n * P), o);
          acc.x = fmaf(cv[k], o.x, acc.x);
          acc.y = fmaf(cv[k], o.y, acc.y);
          acc.z = fmaf(cv[k], o.z, acc.z);
          acc.w = fmaf(cv[k], o.w, acc.w);
        }
      }
    }
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  // thread t < tile sums column t of the tile over the row groups: column t
  // of group gg is float gg * tile + t of part
  const int col = blockIdx.x * tile + threadIdx.x;
  if (threadIdx.x < tile && col < P) {
    const float* pf = reinterpret_cast<const float*>(part);
    float sum = 0.f;
    for (int gg = 0; gg < groups; ++gg) sum += pf[gg * tile + threadIdx.x];
    y[b * ys.b + h * ys.h + col] = from_float<T>(sum);
  }
}

}  // namespace
}  // namespace repro_torch

// x: (B, S, H, P); log_a: (B, S, H); b, c: (B, S, H / hpg, N), head h
// reading group h / hpg (hpg 1 on the wide route); y: (B, S, H, P)
// in x's dtype; final_state: (B, H, N, P) fp32, contiguous.  x, b, c, y
// share the dtype code `dtype` and have a contiguous last axis; log_a has
// the dtype code `la_dtype`.  strides: 15 element strides, (batch,
// sequence, head) for x, log_a, b, c, y in that order; y is contiguous.
// chunk is the chunk length L: for float32 at least 1; for bfloat16 a
// multiple of 16 up to 256 with P <= 128 and N <= 64, where workspace
// holds B * H * nc * (N * P + 1) floats, nc = ceil(S / L), or up to 128
// with P and N up to 384 (the wide route), where it holds
// B * H * (nc - 1) * 2 * N * Pw bf16, Pw = P rounded up to 8, and x, b, c
// start at 16-byte boundaries with strides that are multiples of 8
// elements or 0 (head and batch only), as TMA reads them (float32 reads
// no workspace).
// smem_bytes is the caller's footprint figure and must equal this file's.
// Returns a cudaError_t code (0 on success).
extern "C" int ssd_forward(const void* x, const void* log_a, const void* b,
                           const void* c, void* y, void* final_state,
                           void* workspace, int dtype, int la_dtype, int B,
                           int S, int H, int P, int N, int hpg,
                           const long long* strides, int L,
                           long long smem_bytes, void* stream) {
  using namespace repro_torch;
  if ((dtype != kFloat32 && dtype != kBFloat16) ||
      (la_dtype != kFloat32 && la_dtype != kBFloat16) || L < 1 || S < 1 ||
      P < 1 || N < 1 || H > 65535 || B > 65535 || hpg < 1 || H % hpg)
    return (int)cudaErrorInvalidValue;
  float* fin = static_cast<float*>(final_state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    const size_t smem = ssd_smem_floats(L, P, N) * sizeof(float);
    if ((long long)smem != smem_bytes) return (int)cudaErrorInvalidValue;
    return la_dtype == kFloat32
               ? launch_simt<float>(x, log_a, b, c, y, fin, B, S, H, P, N,
                                    hpg, strides, L, smem, s)
               : launch_simt<bf16>(x, log_a, b, c, y, fin, B, S, H, P, N,
                                   hpg, strides, L, smem, s);
  }
  if (L % 16 || L > kMaxChunk || P > kMaxWidth || N > kMaxWidth ||
      (wide_route(P, N) && L > kWideMaxChunk) ||
      (long long)chunked_smem(L, P, N) != smem_bytes)
    return (int)cudaErrorInvalidValue;
  if (wide_route(P, N)) {
    if (hpg != 1) return (int)cudaErrorInvalidValue;
    return launch_wide_all(x, log_a, b, c, y, fin, workspace, la_dtype, B, S,
                           H, P, N, strides, L, s);
  }
  return launch_chunked_all(x, log_a, b, c, y, fin,
                            static_cast<float*>(workspace), la_dtype, B, S, H,
                            P, N, hpg, strides, L, s);
}

// One token of the recurrence: state and out (B, H, N, P) fp32, each (N, P)
// contiguous, 16-byte aligned, out == state allowed (updated in place); x
// (B, H, P) and y (B, H, P) of the dtype code `dtype`; log_a (B, H) fp32;
// b, c (B, H / hpg, N) of x's dtype, head h reading group h / hpg; the last
// axis of each contiguous.  strides: 14 element strides, (batch, head) of
// state, x, log_a, b, c, out, y in that order.  P is a multiple of 4, tile
// (the P columns of a CTA) a multiple of 4 up to 128.  Returns a
// cudaError_t code (0 on success).
extern "C" int ssd_decode(const void* state, const void* x, const void* log_a,
                          const void* b, const void* c, void* out, void* y,
                          int dtype, int B, int H, int N, int P, int hpg,
                          const long long* strides, int tile, void* stream) {
  using namespace repro_torch;
  const long long* st = strides;
  if ((dtype != kFloat32 && dtype != kBFloat16) || B < 1 || H < 1 ||
      N < 1 || P < 1 || P % 4 || B > 65535 || H > 65535 || hpg < 1 ||
      H % hpg || tile < 4 || tile % 4 || tile > kDecodeMaxTile ||
      reinterpret_cast<uintptr_t>(state) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 || st[0] % 4 || st[1] % 4 ||
      st[10] % 4 || st[11] % 4)
    return (int)cudaErrorInvalidValue;
  const DecodeStrides ss{st[0], st[1]}, xs{st[2], st[3]}, as{st[4], st[5]},
      bs{st[6], st[7]}, cs{st[8], st[9]}, os{st[10], st[11]},
      ys{st[12], st[13]};
  const dim3 grid((P + tile - 1) / tile, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* la = static_cast<const float*>(log_a);
  float* o = static_cast<float*>(out);
  const float* sv = static_cast<const float*>(state);
  if (dtype == kFloat32)
    ssd_decode_kernel<float><<<grid, kDecodeThreads, 0, s>>>(
        sv, static_cast<const float*>(x), la, static_cast<const float*>(b),
        static_cast<const float*>(c), o, static_cast<float*>(y), N, P, hpg,
        tile, ss, xs, as, bs, cs, os, ys);
  else
    ssd_decode_kernel<bf16><<<grid, kDecodeThreads, 0, s>>>(
        sv, static_cast<const bf16*>(x), la, static_cast<const bf16*>(b),
        static_cast<const bf16*>(c), o, static_cast<bf16*>(y), N, P, hpg,
        tile, ss, xs, as, bs, cs, os, ys);
  return (int)cudaGetLastError();
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
