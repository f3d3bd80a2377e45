// Pointwise convolution as an output-stationary tiled GEMM:
// out (G, Co) = act(x (G, Ci) @ w (Ci, Co) + bias), fp32 accumulation.
//
// Replaces repro/kernels/pwconv.py::pwconv_pallas (body _rtrd_kernel), the
// paper's RTRD PWConv: the output tile stays in registers across the whole
// reduction over Ci and is stored exactly once, with bias and activation
// applied in the epilogue.
//
// What bounds it on the H100: at the main-path shapes (G = B*H*W up to
// 8*112*112, Ci/Co 32..1024) the product does 2*Ci*Co/(Ci+Co) operations
// per element moved, 43..1024, so the wide layers are bound by operations
// on the CUDA cores (67 TFLOP/s fp32) and the narrow early layers by
// bytes.  This first kernel is the plain shared-memory GEMM:
//   * one CTA of 256 threads per BM x BN output tile (64 or 128 each way);
//     each thread keeps a (BM/16) x (BN/16) register micro-tile;
//   * per K step of bk (8..32) the CTA stages the A tile (x rows, padded
//     stride to avoid bank conflicts) and the B tile (w rows) in shared
//     memory as fp32, converted once on load;
//   * ragged edges of G, Ci and Co are masked on load and store: no padded
//     copies of x or w are made.
// wgmma, TMA and a pipelined ring of stages are work for a later PR.
#include "common.cuh"

namespace {

using namespace repro;

template <typename T, typename O, int BM, int BN>
__global__ void __launch_bounds__(256) pw_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                                 const T* __restrict__ bias, O* __restrict__ out,
                                                 int G, int Ci, int Co, int bk, int act) {
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  extern __shared__ float smem[];
  const int astride = bk + 1;
  float* as = smem;                 // [BM][bk + 1]
  float* bs = smem + BM * astride;  // [bk][BN]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long g0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Ci; k0 += bk) {
    for (int e = tid; e < BM * bk; e += 256) {
      const int r = e / bk;
      const int k = e % bk;
      const long long g = g0 + r;
      as[r * astride + k] = (g < G && k0 + k < Ci) ? to_f(x[g * Ci + k0 + k]) : 0.f;
    }
    for (int e = tid; e < bk * BN; e += 256) {
      const int k = e / BN;
      const int n = e % BN;
      bs[e] = (k0 + k < Ci && n0 + n < Co) ? to_f(w[(long long)(k0 + k) * Co + n0 + n]) : 0.f;
    }
    __syncthreads();
    const int kk = min(bk, Ci - k0);
    for (int k = 0; k < kk; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = as[(ty + 16 * i) * astride + k];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = bs[k * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long g = g0 + ty + 16 * i;
    if (g >= G) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= Co) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += to_f(bias[n]);
      out[g * Co + n] = from_f<O>(activate(v, act));
    }
  }
}

template <typename T, typename O, int BM, int BN>
int launch_tile(const void* x, const void* w, const void* bias, void* out, int G, int Ci, int Co,
                int bk, int act, cudaStream_t stream) {
  const size_t smem = (size_t)(BM * (bk + 1) + bk * BN) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(pw_kernel<T, O, BM, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((G + BM - 1) / BM), (unsigned)((Co + BN - 1) / BN));
  pw_kernel<T, O, BM, BN><<<grid, 256, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<O*>(out), G, Ci, Co, bk, act);
  return (int)cudaGetLastError();
}

template <typename T, typename O>
int launch_io(const void* x, const void* w, const void* bias, void* out, int G, int Ci, int Co,
              int bg, int bco, int bk, int act, cudaStream_t stream) {
  if (bk < 1 || bk > 32) return (int)cudaErrorInvalidValue;
  if (bg == 64 && bco == 64) return launch_tile<T, O, 64, 64>(x, w, bias, out, G, Ci, Co, bk, act, stream);
  if (bg == 64 && bco == 128) return launch_tile<T, O, 64, 128>(x, w, bias, out, G, Ci, Co, bk, act, stream);
  if (bg == 128 && bco == 64) return launch_tile<T, O, 128, 64>(x, w, bias, out, G, Ci, Co, bk, act, stream);
  if (bg == 128 && bco == 128) return launch_tile<T, O, 128, 128>(x, w, bias, out, G, Ci, Co, bk, act, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

REPRO_EXPORT_ERROR_STRING(pwconv)

// x (G, Ci), w (Ci, Co), bias (Co) or null, at the stream type; out (G, Co)
// at the store type.  (bg, bco) is one of the compiled tiles, 1 <= bk <= 32.
extern "C" int pwconv_launch(const void* x, const void* w, const void* bias, void* out, int G,
                             int Ci, int Co, int bg, int bco, int bk, int act, int in_dtype,
                             int out_dtype, void* stream) {
  REPRO_DISPATCH_IO(in_dtype, out_dtype, launch_io, x, w, bias, out, G, Ci, Co, bg, bco, bk, act,
                    static_cast<cudaStream_t>(stream));
}
