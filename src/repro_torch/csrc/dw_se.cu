// Depthwise conv with the squeeze-excite gate as its epilogue:
//   y    = act_dw(DW(x) + dw_bias)                   (fp32, never stored)
//   gate = sigmoid(act_se(mean_hw(y) @ w1 + b1) @ w2 + b2)
//   out  = y * gate
// NHWC; the kernels read x as it lies and apply the zero padding
// themselves (pad_t rows above, pad_l columns left, zeros past the far
// edges).
//
// Replaces repro/kernels/se_epilogue.py::dw_se_pallas (body _dw_se_kernel).
//
// The gate of an image needs the pooled mean of every channel of its DW
// output over the whole image.  The TPU kernel holds that output in VMEM.
// On the H100 a reduction across CTAs needs a second pass, so an image is
// spread over many CTAs, each a tile of dw_tile.cuh (tile_h x tile_w
// output pixels by cg channels; blocking.py::plan_dw_se), in two passes
// over the same grid (spatial tiles, channel groups, images):
//   1. the pooling pass stages its tile's padded window (and its channels'
//      rows of w1), computes DW + bias + act in fp32 with dw_tile.cuh's
//      sliding register window and sums its in-image outputs to one fp32
//      sum per channel (outputs past Ho x Wo are masked out: act(0 + bias)
//      is not 0).  Its share of the reduce FC, sums @ w1[its channels],
//      goes to hpart[b][cta][:cse];
//   2. the scaling pass stages the window again (and w2's columns of its
//      channels), sums the image's hpart rows in CTA order into hid =
//      act_se(sum / (Ho * Wo) + b1) (every CTA of the image in the same
//      order, so all get the same bits), computes its channels' gates,
//      sigmoid(hid @ w2 + b2), computes the DW again by the same inlined
//      code in the same tap order (the same bits as pass 1 pooled),
//      multiplies it by the gate and stores it once at the store type.
// So the gate's two FCs are spread over the CTAs that own the channels:
// no CTA runs a C x Cse product on its own.  No float atomics, and every
// sum in an order fixed by the shapes alone: every call gives the same
// bits, and a CUDA graph replays it.  (Summing the hidden vector once an
// image instead needs a third launch between the passes, or the image's
// last pooling CTA found by an arrival counter, which on the H100 was no
// faster than the third launch at batch 1: PERF.md.  Each scaling CTA
// reads only CTAs-per-image x cse floats of hpart.)
//
// What bounds it on the H100: bytes (Hf*Wf multiply-adds per output against
// one input read and one output write; the gate's FCs are tiny).  The two
// passes read the input twice, the second time mostly from L2 (the largest
// MnasNet input, 28.9 MB at 224 and batch 8, fits the 50 MB L2), and do the
// DW's multiply-adds twice.  What they buy: every SM busy at batch 1, and
// no DW output in device memory between the DW, the pool and the scale.
#include <initializer_list>

#include "dw_tile.cuh"

namespace {

using namespace repro;

struct SeShape {
  int cse, npix, act_dw, act_se;
};

// Floats of the column-sum scratch: a partial sum per slice and hidden
// unit (256), or one per hidden unit where there are more of those.
inline int red_floats(int cse) { return cse > 256 ? cse : 256; }

// Shared memory of the two passes: the tile, then the pooling pass's
// channel sums, rows of w1 (fp32) and column-sum scratch; the scaling
// pass's columns of w2 (fp32), hidden vector, gates and column-sum
// scratch.  repro_torch/kernels/blocking.py::dw_se_smem_bytes models the
// same regions.
struct PoolLayout {
  DwLayout tile;
  size_t csum, w1s, red, total;
};
struct ScaleLayout {
  DwLayout tile;
  size_t w2s, hid, gate, red, total;
};

template <typename T>
PoolLayout pool_layout(const DwGeometry& g, int cse) {
  PoolLayout p{};
  p.tile = dw_tile_layout<T>(g);
  size_t off = p.tile.total;
  p.csum = off; off += align16((size_t)g.cg * 4);
  p.w1s = off; off += align16((size_t)g.cg * cse * 4);
  p.red = off; off += align16((size_t)red_floats(cse) * 4);
  p.total = off;
  return p;
}

template <typename T>
ScaleLayout scale_layout(const DwGeometry& g, int cse) {
  ScaleLayout p{};
  p.tile = dw_tile_layout<T>(g);
  size_t off = p.tile.total;
  p.w2s = off; off += align16((size_t)cse * g.cg * 4);
  p.hid = off; off += align16((size_t)cse * 4);
  p.gate = off; off += align16((size_t)g.cg * 4);
  p.red = off; off += align16((size_t)red_floats(cse) * 4);
  p.total = off;
  return p;
}

// sum_{i < n} v(i) in four accumulators (i mod 4), then combined: a fixed
// order with a quarter of the dependent adds.
template <typename V>
__device__ __forceinline__ float sum4(int n, V v) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int i = 0;
  for (; i + 3 < n; i += 4) {
    a0 += v(i);
    a1 += v(i + 1);
    a2 += v(i + 2);
    a3 += v(i + 3);
  }
  for (; i < n; ++i) a0 += v(i);
  return (a0 + a1) + (a2 + a3);
}

// done(j, sum_{i < n} at(i, j)) for each j < cols, by all threads of the
// CTA: S slices (about four rows each, at most 256 / cols), slice s summing
// rows s, s + S, ..., then the slices summed.  The order depends only on n
// and cols, neither on the CTA's threads nor on the call: every call, in
// any kernel, gives the same bits.  red holds red_floats(cols) floats.
template <typename At, typename Done>
__device__ __forceinline__ void column_sums(int n, int cols, At at, float* red, Done done) {
  const int nthr = blockDim.x;
  const int S = max(1, min(256 / cols, (n + 3) / 4));
  for (int e = threadIdx.x; e < S * cols; e += nthr) {
    const int s = e / cols, j = e - s * cols;
    red[e] = sum4((n - s + S - 1) / S, [&](int i) { return at(s + i * S, j); });
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cols; j += nthr) done(j, sum4(S, [&](int s) { return red[s * cols + j]; }));
}

// hid[j] = act_se(sum of the image's nk hpart rows / npix + b1[j]).
template <typename T>
__device__ __forceinline__ void se_hidden(const float* hpart, int nk, const T* __restrict__ b1,
                                          float* __restrict__ hid, const SeShape& se, float* red) {
  column_sums(
      nk, se.cse, [&](int i, int j) { return hpart[(size_t)i * se.cse + j]; }, red,
      [&](int j, float h) { hid[j] = activate(h / (float)se.npix + to_f(b1[j]), se.act_se); });
}

// Pass 1.
template <typename T, int V, int KT, int S>
__global__ void __launch_bounds__(256)
    dw_se_pool_kernel(const T* __restrict__ x, const T* __restrict__ f, const T* __restrict__ dwb,
                      const T* __restrict__ w1, float* __restrict__ hpart, DwGeometry g, PoolLayout l,
                      SeShape se) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem + l.tile.win);          // [hw][ww][cg]
  float* taps = reinterpret_cast<float*>(smem + l.tile.taps);  // [hf * wf][cg]
  float* csum = reinterpret_cast<float*>(smem + l.csum);       // [cg]
  float* w1s = reinterpret_cast<float*>(smem + l.w1s);         // [cg][cse]
  float* red = reinterpret_cast<float*>(smem + l.red);
  const DwTile t = dw_tile(g);
  const long long b = blockIdx.z;
  const int cn = min(g.cg, g.C - t.c0);  // this CTA's real channels
  dw_stage_issue<T, V>(x, f, g, l.tile, win, taps, t, b);
  // w1's rows of these channels lie together
  for (int e = threadIdx.x; e < cn * se.cse; e += blockDim.x) w1s[e] = to_f(w1[(size_t)t.c0 * se.cse + e]);
  dw_stage_wait<V>();
  const DwThread th = dw_thread<V>(g, t);
  float part[V];
#pragma unroll
  for (int c = 0; c < V; ++c) part[c] = 0.f;
  if (th.live) {
    float acc[kDwRun][V], bias[V];
    dw_run<T, V, KT, S>(win, taps, g, l.tile, th, acc);
#pragma unroll
    for (int c = 0; c < V; ++c) bias[c] = dwb != nullptr ? to_f(dwb[th.ch + c]) : 0.f;
    dw_bias_act<V>(acc, bias, se.act_dw);
#pragma unroll
    for (int u = 0; u < kDwRun; ++u)
      if (th.ow + u < g.Wo) {
#pragma unroll
        for (int c = 0; c < V; ++c) part[c] = __fadd_rn(part[c], acc[u][c]);
      }
  }
  // the window has been read: its space takes each run's sums, [run][cg]
  __syncthreads();
  float* runs = reinterpret_cast<float*>(smem + l.tile.win);
  const int nrr = g.tile_h * (g.tile_w / kDwRun);
  if (th.rr < nrr) {
#pragma unroll
    for (int c = 0; c < V; ++c) runs[th.rr * g.cg + th.v * V + c] = part[c];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cn; j += blockDim.x) csum[j] = sum4(nrr, [&](int r) { return runs[r * g.cg + j]; });
  __syncthreads();
  // this CTA's share of the reduce FC
  float* hp = hpart + ((size_t)b * gridDim.x * gridDim.y + blockIdx.y * gridDim.x + blockIdx.x) * se.cse;
  column_sums(
      cn, se.cse, [&](int i, int j) { return csum[i] * w1s[i * se.cse + j]; }, red,
      [&](int j, float h) { hp[j] = h; });
}

// Pass 2: the image's hidden vector and the gates of the tile's channels,
// then the DW again, by the same code, times its gate, stored once.
template <typename T, typename O, int V, int KT, int S>
__global__ void __launch_bounds__(256)
    dw_se_scale_kernel(const T* __restrict__ x, const T* __restrict__ f, const T* __restrict__ dwb,
                       const T* __restrict__ b1, const T* __restrict__ w2, const T* __restrict__ b2,
                       const float* __restrict__ hpart, O* __restrict__ out, DwGeometry g, ScaleLayout l,
                       SeShape se) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem + l.tile.win);
  float* taps = reinterpret_cast<float*>(smem + l.tile.taps);
  float* w2s = reinterpret_cast<float*>(smem + l.w2s);  // [cse][cg]
  float* hs = reinterpret_cast<float*>(smem + l.hid);   // [cse]
  float* gs = reinterpret_cast<float*>(smem + l.gate);  // [cg]
  float* red = reinterpret_cast<float*>(smem + l.red);
  const DwTile t = dw_tile(g);
  const long long b = blockIdx.z;
  const int cn = min(g.cg, g.C - t.c0);
  dw_stage_issue<T, V>(x, f, g, l.tile, win, taps, t, b);
  for (int e = threadIdx.x; e < se.cse * cn; e += blockDim.x) {
    const int j = e / cn, cc = e - j * cn;
    w2s[j * g.cg + cc] = to_f(w2[(size_t)j * g.C + t.c0 + cc]);
  }
  const int nk = gridDim.x * gridDim.y;
  se_hidden<T>(hpart + (size_t)b * nk * se.cse, nk, b1, hs, se, red);
  dw_stage_wait<V>();
  for (int cc = threadIdx.x; cc < cn; cc += blockDim.x) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    int j = 0;
    for (; j + 3 < se.cse; j += 4) {
      a0 = fmaf(hs[j], w2s[j * g.cg + cc], a0);
      a1 = fmaf(hs[j + 1], w2s[(j + 1) * g.cg + cc], a1);
      a2 = fmaf(hs[j + 2], w2s[(j + 2) * g.cg + cc], a2);
      a3 = fmaf(hs[j + 3], w2s[(j + 3) * g.cg + cc], a3);
    }
    for (; j < se.cse; ++j) a0 = fmaf(hs[j], w2s[j * g.cg + cc], a0);
    gs[cc] = 1.f / (1.f + expf(-((a0 + a1) + (a2 + a3) + to_f(b2[t.c0 + cc]))));
  }
  __syncthreads();
  const DwThread th = dw_thread<V>(g, t);
  if (!th.live) return;
  float acc[kDwRun][V], bias[V];
  dw_run<T, V, KT, S>(win, taps, g, l.tile, th, acc);
#pragma unroll
  for (int c = 0; c < V; ++c) bias[c] = dwb != nullptr ? to_f(dwb[th.ch + c]) : 0.f;
  dw_bias_act<V>(acc, bias, se.act_dw);
#pragma unroll
  for (int u = 0; u < kDwRun; ++u)
#pragma unroll
    for (int c = 0; c < V; ++c) acc[u][c] *= gs[th.v * V + c];
  dw_store<O, V>(out, g, th, b, acc);
}

struct Operands {
  const void *x, *f, *dwb, *w1, *b1, *w2, *b2;
  void* out;
  float* hpart;
};

// The launch of pass 1 (pooling) or 2 (scaling) over B images: both on
// dw_tile.cuh's grid, each with its own layout's shared memory.
template <typename T>
LaunchDims dw_se_dims(int pass, int B, const DwGeometry& g, int cse, int V) {
  return dw_tile_dims(B, g, V, pass == 1 ? pool_layout<T>(g, cse).total : scale_layout<T>(g, cse).total);
}

template <typename T, typename O, int V, int KT, int S>
int launch_k(const Operands& a, int B, const DwGeometry& g, const SeShape& se, cudaStream_t stream) {
  static bool allowed = false;
  const PoolLayout pl = pool_layout<T>(g, se.cse);
  const ScaleLayout sl = scale_layout<T>(g, se.cse);
  const LaunchDims dp = dw_se_dims<T>(1, B, g, se.cse, V);
  const LaunchDims ds = dw_se_dims<T>(2, B, g, se.cse, V);
  if (dp.smem > (size_t)kMaxSmem || ds.smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  auto pool = dw_se_pool_kernel<T, V, KT, S>;
  auto scale = dw_se_scale_kernel<T, O, V, KT, S>;
  if (!allowed) {
    for (const void* k : {(const void*)pool, (const void*)scale}) {
      cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (e != cudaSuccess) return (int)e;
    }
    allowed = true;
  }
  if (dp.block[0] < 1 || dp.block[0] > 256 || dp.grid[0] * dp.grid[1] > 0x7fffffffLL || dp.grid[1] > 65535 ||
      dp.grid[2] > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const T* x = static_cast<const T*>(a.x);
  const T* f = static_cast<const T*>(a.f);
  const T* dwb = static_cast<const T*>(a.dwb);
  pool<<<dp.grid_dim(), dp.block_dim(), dp.smem, stream>>>(x, f, dwb, static_cast<const T*>(a.w1), a.hpart, g, pl,
                                                           se);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scale<<<ds.grid_dim(), ds.block_dim(), ds.smem, stream>>>(x, f, dwb, static_cast<const T*>(a.b1),
                                                            static_cast<const T*>(a.w2), static_cast<const T*>(a.b2),
                                                            a.hpart, static_cast<O*>(a.out), g, sl, se);
  return (int)cudaGetLastError();
}

template <typename T, typename O, int V>
int launch_v(const Operands& a, int B, const DwGeometry& g, const SeShape& se, cudaStream_t stream) {
  const bool square = g.hf == g.wf;
#define REPRO_DW_SE_CASE(KK, SS)                \
  if (square && g.hf == KK && g.stride == SS) \
    return launch_k<T, O, V, KK, SS>(a, B, g, se, stream);
  REPRO_DW_SE_CASE(3, 1)
  REPRO_DW_SE_CASE(3, 2)
  REPRO_DW_SE_CASE(5, 1)
  REPRO_DW_SE_CASE(5, 2)
  REPRO_DW_SE_CASE(7, 1)
  REPRO_DW_SE_CASE(7, 2)
#undef REPRO_DW_SE_CASE
  return launch_k<T, O, V, 0, 0>(a, B, g, se, stream);
}

template <typename T, typename O>
int launch_io(const Operands& a, int B, const DwGeometry& g, const SeShape& se, int vec, cudaStream_t stream) {
  constexpr int VV = 16 / sizeof(T);
  if (vec == VV) {
    auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
    if (g.C % VV != 0 || g.cg % VV != 0 || !aligned(a.x) || !aligned(a.f) || !aligned(a.out))
      return (int)cudaErrorInvalidValue;
    return launch_v<T, O, VV>(a, B, g, se, stream);
  }
  if (vec == 1) return launch_v<T, O, 1>(a, B, g, se, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

REPRO_EXPORT_ERROR_STRING(dw_se)

// x (B, Hi, Wi, C), read as zero-padded by pad_t rows above and pad_l
// columns left (and zeros past its far edges) to give an (Ho, Wo) VALID
// output; f (hf, wf, C); dw_bias (C) or null; w1 (C, cse); b1 (cse); w2
// (cse, C); b2 (C): all at the stream type.  out (B, Ho, Wo, C) at the store
// type.  Workspace: hpart (B, CTAs of a pass per image, cse) fp32, any
// contents.  A CTA takes tile_h x tile_w outputs (tile_w a multiple of 4)
// by cg channels, vec (1, or a 16-byte vector) channels a thread.  Two
// launches: the pooling pass, then the scaling pass.
extern "C" int dw_se_launch(const void* x, const void* f, const void* dw_bias, const void* w1,
                            const void* b1, const void* w2, const void* b2, void* out, float* hpart, int B, int Hi, int Wi, int C, int Ho, int Wo, int hf, int wf,
                            int stride, int pad_t, int pad_l, int tile_h, int tile_w, int cg, int vec, int cse,
                            int act_dw, int act_se, int in_dtype, int out_dtype, void* stream) {
  if (B < 1 || C < 1 || Ho < 1 || Wo < 1 || hf < 1 || wf < 1 || stride < 1 || pad_t < 0 || pad_l < 0 ||
      tile_h < 1 || tile_w < kDwRun || tile_w % kDwRun != 0 || cg < 1 || vec < 1 || cg % vec != 0 ||
      cse < 1)
    return (int)cudaErrorInvalidValue;
  const DwGeometry g{Hi, Wi, C, Ho, Wo, hf, wf, stride, pad_t, pad_l, tile_h, tile_w, cg};
  const SeShape se{cse, Ho * Wo, act_dw, act_se};
  const Operands a{x, f, dw_bias, w1, b1, w2, b2, out, hpart};
  REPRO_DISPATCH_IO(in_dtype, out_dtype, launch_io, a, B, g, se, vec, static_cast<cudaStream_t>(stream));
}

// The launch of pass 1 (pooling) or 2 (scaling) that dw_se_launch
// configures for this geometry over B images (vec channels a thread), as
// write_dims' ten numbers in out; cudaErrorInvalidValue for an unknown
// dtype or pass, or a tile that is not whole vectors.
extern "C" int dw_se_launch_dims(int pass, int B, int C, int Ho, int Wo, int hf, int wf, int stride, int tile_h,
                                 int tile_w, int cg, int vec, int cse, int in_dtype, long long* out) {
  if ((pass != 1 && pass != 2) || vec < 1 || cg % vec != 0) return (int)cudaErrorInvalidValue;
  const DwGeometry g{0, 0, C, Ho, Wo, hf, wf, stride, 0, 0, tile_h, tile_w, cg};
  if (in_dtype == kF32) return write_dims(dw_se_dims<float>(pass, B, g, cse, vec), out);
  if (in_dtype == kBF16 || in_dtype == kF16) return write_dims(dw_se_dims<__half>(pass, B, g, cse, vec), out);
  return (int)cudaErrorInvalidValue;
}

// Shared memory one CTA of a pass needs, in bytes (0 for an unknown dtype
// or pass): 1 the pooling pass, 2 the scaling pass.  Lets the wrapper check
// the planner's model against the kernel.
extern "C" long long dw_se_smem_bytes(int pass, int tile_h, int tile_w, int cg, int hf, int wf, int stride,
                                      int cse, int in_dtype) {
  const DwGeometry g{0, 0, 0, 0, 0, hf, wf, stride, 0, 0, tile_h, tile_w, cg};
  if (in_dtype != kF32 && in_dtype != kBF16 && in_dtype != kF16) return 0;
  const bool wide = in_dtype == kF32;
  if (pass == 1) return (long long)(wide ? pool_layout<float>(g, cse) : pool_layout<__half>(g, cse)).total;
  if (pass == 2) return (long long)(wide ? scale_layout<float>(g, cse) : scale_layout<__half>(g, cse)).total;
  return 0;
}
