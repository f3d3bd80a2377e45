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
//
// The backward (training), which the TPU kernel never had: the reference
// differentiates its XLA oracle (repro/kernels/ref.py::dwconv1d_causal_ref).
// From dy (B, L, D), x and f:
//   dx[b, m, d] = sum_i f[i, d] * dy[b, m + (K-1) - i, d]   (anti-causal, zero right pad)
//   df[i, d]    = sum_{b, l} x[b, l - (K-1) + i, d] * dy[b, l, d]
// Bound on the H100: bytes (read x and dy once, write dx; df is K x D).
//   * dw1d_bwd_kernel: one pass.  A CTA is 32 channel vectors x 8 runs of
//     `rows` rows of one batch row; each thread slides two register windows
//     down its run (from its last row to its first): dy's K-1 rows to the
//     right for dx, x's K-1 rows to the left for df, so it reads each row of
//     x and dy once, writes dx, and keeps df's K taps in fp32 registers.  The
//     CTA sums its 8 runs' taps in shared memory in a fixed order and writes
//     one fp32 partial per tap and channel into a workspace (one slot per CTA
//     along the rows: no atomics).
//   * dw1d_df_reduce_kernel: sums the partials in slot order in fp32 and
//     rounds once to f's type, so df has the same bits at every call (the
//     training loop's bit-exact recovery runs with deterministic algorithms).
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

// --------------------------------------------------------------------------
// Backward
// --------------------------------------------------------------------------

// Runs of one CTA along the sequence (threadIdx.y); channel vectors along x.
constexpr int kBwdRuns = 8;
constexpr int kBwdLanes = 32;

// The CTA's tap sums: each thread's a[V] for its channel vector, summed over
// threadIdx.y in order through shared memory, stored to out[0 .. 32*V) (the
// CTA's channel vectors; those at or past D skipped).
template <int V>
__device__ __forceinline__ void cta_tap_sum(const float (&a)[V], float* red, float* out, int d0,
                                           int D) {
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int v = 0; v < V; ++v) red[ty * kBwdLanes * V + tx * V + v] = a[v];
  __syncthreads();
  const int tid = ty * kBwdLanes + tx;
  for (int c = tid; c < kBwdLanes * V; c += kBwdLanes * kBwdRuns) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kBwdRuns; ++r) s += red[r * kBwdLanes * V + c];
    if (d0 + c < D) out[c] = s;
  }
  __syncthreads();
}

// K > 0: exact-K register windows; K == 0: a runtime tap loop (k_rt taps).
// grid.x: B * spans (a span = kBwdRuns runs of `rows` rows), grid.y: channel
// tiles of 32 vectors.  ws (grid.x, K, D) fp32.
template <typename T, int K, int V>
__global__ void __launch_bounds__(kBwdLanes * kBwdRuns) dw1d_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ f, const T* __restrict__ dy, T* __restrict__ dx,
    float* __restrict__ ws, int L, int D, int k_rt, int rows) {
  __shared__ float red[kBwdRuns * kBwdLanes * V];
  const int taps = K > 0 ? K : k_rt;
  const int dvecs = D / V;
  const int spans = (L + kBwdRuns * rows - 1) / (kBwdRuns * rows);
  const int b = blockIdx.x / spans;
  const int l0 = (blockIdx.x % spans) * kBwdRuns * rows + threadIdx.y * rows;
  const int l1 = min(l0 + rows, L);
  const int tile0 = blockIdx.y * kBwdLanes * V;  // first channel of the CTA
  const int dv = blockIdx.y * kBwdLanes + threadIdx.x;
  const bool live = dv < dvecs && l0 < l1;
  const int d0 = dv * V;
  const long long base = (long long)b * L * D + d0;
  const T* xb = x + base;
  const T* gb = dy + base;
  T* ob = dx + base;
  float* wsb = ws + (long long)blockIdx.x * taps * D + tile0;

  if constexpr (K > 0) {
    constexpr int W = K > 1 ? K - 1 : 1;
    float acc[K][V];
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[i][v] = 0.f;
    if (live) {
      float taps_f[K][V];
#pragma unroll
      for (int i = 0; i < K; ++i) load_f<T, V>(f + (long long)i * D + d0, taps_f[i]);
      // gw[j] = dy[l + 1 + j], xw[j] = x[l - (K-1) + j] for the row l about
      // to be computed (walking l down from l1 - 1)
      float gw[W][V], xw[W][V];
#pragma unroll
      for (int j = 0; j < K - 1; ++j) {
        const int lg = l1 + j;
        const int lx = l1 - 1 - (K - 1) + j;
        if (lg < L) {
          load_f<T, V>(gb + (long long)lg * D, gw[j]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) gw[j][v] = 0.f;
        }
        if (lx >= 0) {
          load_f<T, V>(xb + (long long)lx * D, xw[j]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) xw[j][v] = 0.f;
        }
      }
      for (int l = l1 - 1; l >= l0; --l) {
        float g[V], xc[V];
        load_f<T, V>(gb + (long long)l * D, g);
        load_f<T, V>(xb + (long long)l * D, xc);
        Vec<T, V> o;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          // dx[l] = f[K-1] dy[l] + sum_j f[K-2-j] dy[l+1+j]
          float s = g[v] * taps_f[K - 1][v];
#pragma unroll
          for (int j = 0; j < K - 1; ++j) s = fmaf(gw[j][v], taps_f[K - 2 - j][v], s);
          o.v[v] = from_f<T>(s);
          // df[i] += x[l - (K-1) + i] dy[l]
#pragma unroll
          for (int i = 0; i < K - 1; ++i) acc[i][v] = fmaf(xw[i][v], g[v], acc[i][v]);
          acc[K - 1][v] = fmaf(xc[v], g[v], acc[K - 1][v]);
        }
        *reinterpret_cast<Vec<T, V>*>(ob + (long long)l * D) = o;
        if (K > 1) {
          // slide both windows one row down
#pragma unroll
          for (int j = K - 2; j > 0; --j)
#pragma unroll
            for (int v = 0; v < V; ++v) {
              gw[j][v] = gw[j - 1][v];
              xw[j][v] = xw[j - 1][v];
            }
#pragma unroll
          for (int v = 0; v < V; ++v) gw[0][v] = g[v];
          const int lx = l - K;
          if (lx >= 0) {
            load_f<T, V>(xb + (long long)lx * D, xw[0]);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) xw[0][v] = 0.f;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < K; ++i) cta_tap_sum<V>(acc[i], red, wsb + (long long)i * D, tile0, D);
  } else {
    if (live) {
      for (int l = l0; l < l1; ++l) {
        float s[V];
#pragma unroll
        for (int v = 0; v < V; ++v) s[v] = 0.f;
        for (int i = 0; i < taps; ++i) {
          const int lg = l + (taps - 1) - i;
          if (lg >= L) continue;
          float g[V], fv[V];
          load_f<T, V>(gb + (long long)lg * D, g);
          load_f<T, V>(f + (long long)i * D + d0, fv);
#pragma unroll
          for (int v = 0; v < V; ++v) s[v] = fmaf(g[v], fv[v], s[v]);
        }
        Vec<T, V> o;
#pragma unroll
        for (int v = 0; v < V; ++v) o.v[v] = from_f<T>(s[v]);
        *reinterpret_cast<Vec<T, V>*>(ob + (long long)l * D) = o;
      }
    }
    for (int i = 0; i < taps; ++i) {
      float a[V];
#pragma unroll
      for (int v = 0; v < V; ++v) a[v] = 0.f;
      if (live) {
        for (int l = l1 - 1; l >= l0; --l) {
          const int lx = l - (taps - 1) + i;
          if (lx < 0) break;
          float g[V], xv[V];
          load_f<T, V>(gb + (long long)l * D, g);
          load_f<T, V>(xb + (long long)lx * D, xv);
#pragma unroll
          for (int v = 0; v < V; ++v) a[v] = fmaf(xv[v], g[v], a[v]);
        }
      }
      cta_tap_sum<V>(a, red, wsb + (long long)i * D, tile0, D);
    }
  }
}

// df[i, d] = sum over the slots s = 0 .. splits-1, in order, of ws[s, i, d].
template <typename T>
__global__ void __launch_bounds__(256) dw1d_df_reduce_kernel(const float* __restrict__ ws,
                                                             T* __restrict__ df, int splits,
                                                             int kd) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= kd) return;
  float s = 0.f;
  for (int r = 0; r < splits; ++r) s += ws[(long long)r * kd + idx];
  df[idx] = from_f<T>(s);
}

// The backward's launch configuration: (grid x: CTAs along the rows, grid y:
// channel tiles), kBwdLanes x kBwdRuns threads.
inline LaunchDims bwd_dims(int B, int L, int D, int vec, int rows) {
  const long long spans = (L + (long long)kBwdRuns * rows - 1) / ((long long)kBwdRuns * rows);
  const long long tiles = (D / vec + kBwdLanes - 1) / kBwdLanes;
  LaunchDims d = launch_dims(B * spans, tiles, 1, kBwdLanes, 1, 0);
  d.block[1] = kBwdRuns;
  return d;
}

template <typename T, int K, int V>
int launch_bwd_kv(const void* x, const void* f, const void* dy, void* dx, float* ws, int B, int L,
                  int D, int k, int rows, cudaStream_t stream) {
  const LaunchDims d = bwd_dims(B, L, D, V, rows);
  if (d.grid[0] > 2147483647LL || d.grid[1] > 65535) return (int)cudaErrorInvalidConfiguration;
  dw1d_bwd_kernel<T, K, V><<<d.grid_dim(), d.block_dim(), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(f), static_cast<const T*>(dy),
      static_cast<T*>(dx), ws, L, D, k, rows);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_bwd_v(const void* x, const void* f, const void* dy, void* dx, float* ws, int B, int L,
                 int D, int k, int rows, cudaStream_t stream) {
  switch (k) {
    case 2: return launch_bwd_kv<T, 2, V>(x, f, dy, dx, ws, B, L, D, k, rows, stream);
    case 3: return launch_bwd_kv<T, 3, V>(x, f, dy, dx, ws, B, L, D, k, rows, stream);
    case 4: return launch_bwd_kv<T, 4, V>(x, f, dy, dx, ws, B, L, D, k, rows, stream);
    case 5: return launch_bwd_kv<T, 5, V>(x, f, dy, dx, ws, B, L, D, k, rows, stream);
    default: return launch_bwd_kv<T, 0, V>(x, f, dy, dx, ws, B, L, D, k, rows, stream);
  }
}

template <typename T>
int launch_bwd(const void* x, const void* f, const void* dy, void* dx, float* ws, int B, int L,
               int D, int k, int vec, int rows, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec) return launch_bwd_v<T, kVec>(x, f, dy, dx, ws, B, L, D, k, rows, stream);
  if (vec == 1) return launch_bwd_v<T, 1>(x, f, dy, dx, ws, B, L, D, k, rows, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_reduce(const float* ws, void* df, int splits, int kd, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = ((long long)kd + threads - 1) / threads;
  dw1d_df_reduce_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(ws, static_cast<T*>(df),
                                                                     splits, kd);
  return (int)cudaGetLastError();
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

// The backward's first pass: x, f, dy (B, L, D) / (K, D) and dx (B, L, D) at
// one type (dtype code), ws (splits, K, D) fp32 with splits =
// dwconv1d_bwd_splits(B, L, rows).  vec and rows as dwconv1d_launch's.
extern "C" int dwconv1d_bwd_launch(const void* x, const void* f, const void* dy, void* dx,
                                   void* ws, int B, int L, int D, int K, int vec, int rows,
                                   int dtype, void* stream) {
  using namespace repro;
  if (K < 1 || rows < 1 || vec < 1 || D % vec != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (dtype == kF32) return launch_status(launch_bwd<float>(x, f, dy, dx, w, B, L, D, K, vec, rows, s));
  if (dtype == kBF16)
    return launch_status(launch_bwd<__nv_bfloat16>(x, f, dy, dx, w, B, L, D, K, vec, rows, s));
  if (dtype == kF16)
    return launch_status(launch_bwd<__half>(x, f, dy, dx, w, B, L, D, K, vec, rows, s));
  return (int)cudaErrorInvalidValue;
}

// Workspace slots of the backward's first pass: its CTAs along the rows.
extern "C" long long dwconv1d_bwd_splits(int B, int L, int rows) {
  return bwd_dims(B, L, kBwdLanes, 1, rows).grid[0];
}

// The backward's second pass: df (K, D) at the dtype code from ws (splits, K, D).
extern "C" int dwconv1d_bwd_reduce_launch(const void* ws, void* df, int splits, int K, int D,
                                          int dtype, void* stream) {
  using namespace repro;
  if (splits < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(ws);
  const int kd = K * D;
  if (dtype == kF32) return launch_status(launch_reduce<float>(w, df, splits, kd, s));
  if (dtype == kBF16) return launch_status(launch_reduce<__nv_bfloat16>(w, df, splits, kd, s));
  if (dtype == kF16) return launch_status(launch_reduce<__half>(w, df, splits, kd, s));
  return (int)cudaErrorInvalidValue;
}
