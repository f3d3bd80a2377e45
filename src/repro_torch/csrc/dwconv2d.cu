// Depthwise 2-D convolution, NHWC, VALID geometry (the wrapper pads SAME).
//
// Replaces repro/kernels/dwconv2d.py::dwconv2d_pallas (body _dw2d_kernel).
//
// What bounds it on the H100: bytes.  At the main-path shapes (3x3 taps,
// 112x112x32 s1 .. 7x7x1024) it does 9 multiply-adds per input element,
// about 2-4.5 operations per byte in fp32 and twice that in bf16, far
// below the card's ~20 fp32 operations per byte of device memory.  So the
// design moves every byte once, in wide coalesced transactions:
//   * one thread per output (b, ho, wo, group of V channels); neighbouring
//     threads own neighbouring channel groups, so a warp reads a contiguous
//     run of C and the V channels of a thread are one vector load
//     (16 bytes for fp32 when C % 4 == 0);
//   * the Hf x Wf taps of the thread's channels are held in registers
//     (the filter is tiny and shared by every thread, so it stays in L1);
//   * fp32 accumulation and one store per output at the store type O.
// The input rows of neighbouring output pixels overlap (Hf/stride times),
// and L1/L2 serve those re-reads; device memory sees each input once.
#include "common.cuh"

namespace {

using namespace repro;

template <typename T, typename O, int K, int V>
__global__ void __launch_bounds__(256) dw2d_kernel(
    const T* __restrict__ x, const T* __restrict__ f, O* __restrict__ out,
    int B, int Hi, int Wi, int C, int Ho, int Wo, int hf, int wf, int stride) {
  const int cgroups = C / V;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)B * Ho * Wo * cgroups;
  if (idx >= total) return;
  const int cg = (int)(idx % cgroups);
  long long t = idx / cgroups;
  const int wo = (int)(t % Wo);
  t /= Wo;
  const int ho = (int)(t % Ho);
  const int b = (int)(t / Ho);
  const int c0 = cg * V;

  float taps[K][K][V];
#pragma unroll
  for (int n = 0; n < K; ++n) {
#pragma unroll
    for (int m = 0; m < K; ++m) {
      if (n < hf && m < wf) {
        const Vec<T, V> fv = *reinterpret_cast<const Vec<T, V>*>(f + (n * wf + m) * C + c0);
#pragma unroll
        for (int v = 0; v < V; ++v) taps[n][m][v] = to_f(fv.v[v]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) taps[n][m][v] = 0.f;
      }
    }
  }

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  const T* xb = x + (((long long)b * Hi + (long long)ho * stride) * Wi + (long long)wo * stride) * C + c0;
#pragma unroll
  for (int n = 0; n < K; ++n) {
    if (n < hf) {
#pragma unroll
      for (int m = 0; m < K; ++m) {
        if (m < wf) {
          const Vec<T, V> xv = *reinterpret_cast<const Vec<T, V>*>(xb + ((long long)n * Wi + m) * C);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = fmaf(to_f(xv.v[v]), taps[n][m][v], acc[v]);
        }
      }
    }
  }

  Vec<O, V> o;
#pragma unroll
  for (int v = 0; v < V; ++v) o.v[v] = from_f<O>(acc[v]);
  *reinterpret_cast<Vec<O, V>*>(out + (((long long)b * Ho + ho) * Wo + wo) * C + c0) = o;
}

template <typename T, typename O, int K, int V>
int launch_kv(const void* x, const void* f, void* out, int B, int Hi, int Wi, int C, int Ho,
              int Wo, int hf, int wf, int stride, cudaStream_t stream) {
  const long long total = (long long)B * Ho * Wo * (C / V);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  dw2d_kernel<T, O, K, V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(f), static_cast<O*>(out), B, Hi, Wi, C,
      Ho, Wo, hf, wf, stride);
  return (int)cudaGetLastError();
}

template <typename T, typename O>
int launch_io(const void* x, const void* f, void* out, int B, int Hi, int Wi, int C, int Ho,
              int Wo, int hf, int wf, int stride, int vec, cudaStream_t stream) {
  const int k = hf > wf ? hf : wf;
#define REPRO_DW_CASE(KK, VV)                                                                \
  if (k <= KK && vec == VV)                                                                  \
    return launch_kv<T, O, KK, VV>(x, f, out, B, Hi, Wi, C, Ho, Wo, hf, wf, stride, stream);
  REPRO_DW_CASE(3, 4)
  REPRO_DW_CASE(3, 1)
  REPRO_DW_CASE(5, 4)
  REPRO_DW_CASE(5, 1)
  REPRO_DW_CASE(7, 4)
  REPRO_DW_CASE(7, 1)
#undef REPRO_DW_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

REPRO_EXPORT_ERROR_STRING(dwconv2d)

// x (B, Hi, Wi, C) and f (Hf, Wf, C) at the stream type; out (B, Ho, Wo, C)
// at the store type.  vec (1 or 4) channels per thread; C % vec == 0.
extern "C" int dwconv2d_launch(const void* x, const void* f, void* out, int B, int Hi, int Wi,
                               int C, int Ho, int Wo, int hf, int wf, int stride, int vec,
                               int in_dtype, int out_dtype, void* stream) {
  if (C % vec != 0 || hf < 1 || wf < 1) return (int)cudaErrorInvalidValue;
  REPRO_DISPATCH_IO(in_dtype, out_dtype, launch_io, x, f, out, B, Hi, Wi, C, Ho, Wo, hf, wf,
                    stride, vec, static_cast<cudaStream_t>(stream));
}
