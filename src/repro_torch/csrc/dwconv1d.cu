// Causal depthwise 1-D convolution: out[b, l, d] = sum_k x[b, l-(K-1)+k, d] * f[k, d],
// zero left padding.  x (B, L, D), f (K, D) at the stream type, out at the store type.
//
// Replaces repro/kernels/dwconv1d.py::dwconv1d_causal_pallas (body _dw1d_kernel).
//
// What bounds it on the H100: bytes.  K = 3..5 multiply-adds per element
// is under one fp32 operation per byte, against the card's ~20 operations
// per byte of device memory.  The TPU kernel walks L in sequential grid
// steps and carries the last K-1 input rows in a VMEM scratch, because its
// blocks cannot overlap.  Here nothing is carried between blocks:
//   * one thread per (b, vector of V channels, run of `rows` sequence rows);
//     neighbouring threads own neighbouring channel vectors, so a warp reads
//     a contiguous stretch of one row (16 bytes a thread when D % V == 0);
//   * the thread reads its K-1 halo rows straight from global memory (the
//     previous run's rows, already in L1/L2), then slides a window of the
//     last K-1 input rows along its run in registers, so every input row is
//     loaded once per thread;
//   * the K taps sit in registers; fp32 accumulation, one store per output.
// Ragged L ends a run early; ragged or misaligned D takes V = 1.  Exact-K
// loops for K = 2..5 (the window is a fixed set of registers); any other K,
// K = 1 included, takes a runtime tap loop that reads its inputs from L1.
#include "common.cuh"

namespace {

using namespace repro;

template <typename T, int V>
__device__ __forceinline__ void load_f(const T* p, float (&r)[V]) {
  const Vec<T, V> v = *reinterpret_cast<const Vec<T, V>*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) r[i] = to_f(v.v[i]);
}

// K > 0: the exact-K sliding window; K == 0: the runtime tap loop (k_rt taps).
template <typename T, typename O, int K, int V>
__global__ void __launch_bounds__(256) dw1d_kernel(
    const T* __restrict__ x, const T* __restrict__ f, O* __restrict__ out, int B, int L, int D,
    int k_rt, int rows) {
  const int dvecs = D / V;
  const int runs = (L + rows - 1) / rows;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * runs * dvecs) return;
  const int d0 = (int)(idx % dvecs) * V;
  const long long t = idx / dvecs;
  const int l0 = (int)(t % runs) * rows;
  const int b = (int)(t / runs);
  const int l1 = min(l0 + rows, L);
  const T* xb = x + (long long)b * L * D + d0;
  O* ob = out + (long long)b * L * D + d0;

  if constexpr (K > 0) {
    constexpr int W = K > 1 ? K - 1 : 1;
    float taps[K][V];
#pragma unroll
    for (int k = 0; k < K; ++k) load_f<T, V>(f + (long long)k * D + d0, taps[k]);
    float win[W][V];  // win[j] = x[l - (K-1) + j] for the row l about to be computed
#pragma unroll
    for (int j = 0; j < K - 1; ++j) {
      const int l = l0 - (K - 1) + j;
      if (l >= 0) {
        load_f<T, V>(xb + (long long)l * D, win[j]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) win[j][v] = 0.f;
      }
    }
    for (int l = l0; l < l1; ++l) {
      float cur[V];
      load_f<T, V>(xb + (long long)l * D, cur);
      Vec<O, V> o;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < K - 1; ++j) acc = fmaf(win[j][v], taps[j][v], acc);
        acc = fmaf(cur[v], taps[K - 1][v], acc);
        o.v[v] = from_f<O>(acc);
      }
      *reinterpret_cast<Vec<O, V>*>(ob + (long long)l * D) = o;
#pragma unroll
      for (int j = 0; j + 1 < K - 1; ++j) {
#pragma unroll
        for (int v = 0; v < V; ++v) win[j][v] = win[j + 1][v];
      }
      if (K > 1) {
#pragma unroll
        for (int v = 0; v < V; ++v) win[W - 1][v] = cur[v];
      }
    }
  } else {
    for (int l = l0; l < l1; ++l) {
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.f;
      for (int k = 0; k < k_rt; ++k) {
        const int li = l - (k_rt - 1) + k;
        if (li < 0) continue;
        float xv[V], fv[V];
        load_f<T, V>(xb + (long long)li * D, xv);
        load_f<T, V>(f + (long long)k * D + d0, fv);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = fmaf(xv[v], fv[v], acc[v]);
      }
      Vec<O, V> o;
#pragma unroll
      for (int v = 0; v < V; ++v) o.v[v] = from_f<O>(acc[v]);
      *reinterpret_cast<Vec<O, V>*>(ob + (long long)l * D) = o;
    }
  }
}

template <typename T, typename O, int K, int V>
int launch_kv(const void* x, const void* f, void* out, int B, int L, int D, int k, int rows,
              cudaStream_t stream) {
  const long long total = (long long)B * ((L + rows - 1) / rows) * (D / V);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  dw1d_kernel<T, O, K, V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(f), static_cast<O*>(out), B, L, D, k,
      rows);
  return (int)cudaGetLastError();
}

template <typename T, typename O, int V>
int launch_v(const void* x, const void* f, void* out, int B, int L, int D, int k, int rows,
             cudaStream_t stream) {
  switch (k) {
    case 2: return launch_kv<T, O, 2, V>(x, f, out, B, L, D, k, rows, stream);
    case 3: return launch_kv<T, O, 3, V>(x, f, out, B, L, D, k, rows, stream);
    case 4: return launch_kv<T, O, 4, V>(x, f, out, B, L, D, k, rows, stream);
    case 5: return launch_kv<T, O, 5, V>(x, f, out, B, L, D, k, rows, stream);
    default: return launch_kv<T, O, 0, V>(x, f, out, B, L, D, k, rows, stream);
  }
}

template <typename T, typename O>
int launch_io(const void* x, const void* f, void* out, int B, int L, int D, int k, int vec,
              int rows, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);  // one 16-byte vector of the stream type
  if (vec == kVec) return launch_v<T, O, kVec>(x, f, out, B, L, D, k, rows, stream);
  if (vec == 1) return launch_v<T, O, 1>(x, f, out, B, L, D, k, rows, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

REPRO_EXPORT_ERROR_STRING(dwconv1d)

// x (B, L, D) and f (K, D) at the stream type; out (B, L, D) at the store type.
// vec: channels per thread, 1 or 16 / sizeof(stream type), dividing D; rows:
// sequence rows per thread.
extern "C" int dwconv1d_launch(const void* x, const void* f, void* out, int B, int L, int D,
                               int K, int vec, int rows, int in_dtype, int out_dtype,
                               void* stream) {
  if (K < 1 || rows < 1 || vec < 1 || D % vec != 0) return (int)cudaErrorInvalidValue;
  REPRO_DISPATCH_IO(in_dtype, out_dtype, launch_io, x, f, out, B, L, D, K, vec, rows,
                    static_cast<cudaStream_t>(stream));
}
