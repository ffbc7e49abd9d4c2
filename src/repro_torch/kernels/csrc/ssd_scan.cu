// Mamba-2 SSD chunked scan for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (_kernel at :25,
// wrapper ssd_scan at :71, pl.pallas_call at :93).  Per chunk of L steps:
// the decay-masked scores G = (c b^T) * exp(seg_i - seg_j) for j <= i, the
// intra-chunk output G x, the inter-chunk output exp(seg_i) c_i . state, and
// the state update state * exp(total) + sum_j exp(total - seg_j) b_j x_j^T.
// The (N, P) fp32 state is carried across chunks; the final state is an
// output.  Steps past S behave as padding with log_a = 0 and x = b = c = 0.
//
// What bounds it on this card: at the main path's shapes (S = 4096, 32
// heads, P = 80, N = 64, chunk 128) the work is ~7.5 GFLOP against ~43 MB
// moved (x, log_a, y and the fp32 final state; the node's b = c are views of
// x), so the ideal kernel is bound by bytes.  This first kernel runs its
// products as fp32 FMA on the CUDA cores and, with one CTA per (batch,
// head), has only B*H = 32 CTAs in flight on 132 SMs: it is bound by the
// FMA rate of the 32 SMs it occupies.
//
// What the design does about it: the TPU grid's sequential chunk axis
// becomes a loop inside the CTA, so the state never leaves shared memory
// (64 x 80 x 4 B = 20 KB at zamba2 widths) and every input is read from
// device memory once.  The chunk length is the autotuner's parameter; a
// chunk whose tiles exceed the per-block shared-memory limit is refused
// before launch.  exp(seg_i - seg_j) is formed only for j <= i: above the
// diagonal the exponent is positive and can overflow to inf, and inf * 0
// would be NaN.  Splitting the chunk loop across CTAs (a second pass for
// the state hand-off) to fill the card is left for later work.

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

template <class T, class A>
int launch(const void* x, const void* la, const void* bm, const void* cm,
           void* y, float* fin, int B, int S, int H, int P, int N,
           const long long* st, int L, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel<T, A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const Strides xs{st[0], st[1], st[2]}, as{st[3], st[4], st[5]},
      bs{st[6], st[7], st[8]}, cs{st[9], st[10], st[11]},
      ys{st[12], st[13], st[14]};
  const dim3 grid(H, B);
  ssd_kernel<T, A><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const A*>(la),
      static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<T*>(y), fin, S, H, P, N, xs, as,
      bs, cs, ys, L);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// x: (B, S, H, P); log_a: (B, S, H); b, c: (B, S, H, N); y: (B, S, H, P)
// in x's dtype; final_state: (B, H, N, P) fp32, contiguous.  x, b, c, y
// share the dtype code `dtype` and have a contiguous last axis; log_a has
// the dtype code `la_dtype`.  strides: 15 element strides, (batch,
// sequence, head) for x, log_a, b, c, y in that order.
// smem_bytes is the caller's footprint figure and must equal this file's.
// Returns a cudaError_t code (0 on success).
extern "C" int ssd_forward(const void* x, const void* log_a, const void* b,
                           const void* c, void* y, void* final_state,
                           int dtype, int la_dtype, int B, int S, int H,
                           int P, int N, const long long* strides, int L,
                           long long smem_bytes, void* stream) {
  using namespace repro_torch;
  const size_t smem = ssd_smem_floats(L, P, N) * sizeof(float);
  if ((long long)smem != smem_bytes) return (int)cudaErrorInvalidValue;
  float* fin = static_cast<float*>(final_state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if ((dtype != kFloat32 && dtype != kBFloat16) ||
      (la_dtype != kFloat32 && la_dtype != kBFloat16))
    return (int)cudaErrorInvalidValue;
  switch (dtype * 2 + la_dtype) {
    case kFloat32 * 2 + kFloat32:
      return launch<float, float>(x, log_a, b, c, y, fin, B, S, H, P, N,
                                  strides, L, smem, s);
    case kFloat32 * 2 + kBFloat16:
      return launch<float, bf16>(x, log_a, b, c, y, fin, B, S, H, P, N,
                                 strides, L, smem, s);
    case kBFloat16 * 2 + kFloat32:
      return launch<bf16, float>(x, log_a, b, c, y, fin, B, S, H, P, N,
                                 strides, L, smem, s);
    case kBFloat16 * 2 + kBFloat16:
      return launch<bf16, bf16>(x, log_a, b, c, y, fin, B, S, H, P, N,
                                strides, L, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
