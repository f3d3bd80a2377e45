#pragma once

// The depthwise tile that dwconv2d.cu and dw_se.cu's two passes share.
//
// A CTA owns tile_h x tile_w output pixels by cg channels of one image
// (grid: spatial tiles, channel groups, images).  dw_stage copies the
// tile's padded input window, (tile_h - 1) * stride + hf rows by
// (tile_w - 1) * stride + wf columns of cg channels, into shared memory
// with 16-byte cp.async copies that zero-fill outside the image (pad_t rows
// above, pad_l columns left, and whatever lies past the far edges), so the
// kernels pad as they read; and the tile's taps as fp32.  A thread owns one
// 16-byte channel vector (V = 4 fp32, 8 bf16 or fp16 channels; V = 1 where
// C or a base is not a whole vector) and a run of kDwRun adjacent output
// columns of one row (dw_thread).  dw_run slides a register window over
// the run: for each tap row it holds that row's taps in registers and reads
// each of the (kDwRun - 1) * stride + wf inputs of the run's window once,
// feeding every output of the run that it touches (KT x KT taps at stride
// S, compiled for 3x3, 5x5 and 7x7 at strides 1 and 2); KT = 0 reads the
// taps from shared memory per output, for any filter and stride (the
// runtime-K path).  Both paths sum each output's taps in fp32, row by row,
// column by column, with explicit fmaf, so two kernels that call dw_run on
// the same window get the same bits.
#include "tile_gemm.cuh"

namespace repro {

// Output columns a thread computes from one sliding register window
// (blocking.py::DW_RUN).
constexpr int kDwRun = 4;

struct DwGeometry {
  int Hi, Wi, C, Ho, Wo, hf, wf, stride, pad_t, pad_l, tile_h, tile_w, cg;
};

// Shared-memory layout of the tile; repro_torch/kernels/blocking.py
// ::dwconv2d_smem_bytes models the same regions.
struct DwLayout {
  size_t win, taps, total;
  int hw, ww;
};

template <typename T>
inline DwLayout dw_tile_layout(const DwGeometry& g) {
  DwLayout l{};
  l.hw = (g.tile_h - 1) * g.stride + g.hf;
  l.ww = (g.tile_w - 1) * g.stride + g.wf;
  size_t off = 0;
  l.win = off; off += align16((size_t)l.hw * l.ww * g.cg * sizeof(T));
  l.taps = off; off += align16((size_t)g.hf * g.wf * g.cg * 4);
  l.total = off;
  return l;
}

// Threads of one tile: a channel vector by a run of each tile row.
inline int dw_tile_threads(const DwGeometry& g, int V) { return g.cg / V * g.tile_h * (g.tile_w / kDwRun); }

inline long long dw_spatial_tiles(const DwGeometry& g) {
  return (long long)((g.Ho + g.tile_h - 1) / g.tile_h) * ((g.Wo + g.tile_w - 1) / g.tile_w);
}

// The launch of a tile kernel over B images: grid (spatial tiles, channel
// groups, images), dw_tile_threads threads, smem bytes of shared memory.
inline LaunchDims dw_tile_dims(int B, const DwGeometry& g, int V, size_t smem) {
  return launch_dims(dw_spatial_tiles(g), (g.C + g.cg - 1) / g.cg, B, dw_tile_threads(g, V), 1, smem);
}

// V consecutive elements at p, widened to fp32.
template <int V, typename T>
__device__ __forceinline__ void load_f(const T* p, float (&o)[V]) {
  if constexpr (V > 1) {
    const Vec<T, V> v = *reinterpret_cast<const Vec<T, V>*>(p);
#pragma unroll
    for (int u = 0; u < V; ++u) o[u] = to_f(v.v[u]);
  } else {
    o[0] = to_f(*p);
  }
}

// This CTA's tile: its first output row and column and its first channel.
struct DwTile {
  int oh0, ow0, c0;
};

__device__ __forceinline__ DwTile dw_tile(const DwGeometry& g) {
  const int tiles_w = (g.Wo + g.tile_w - 1) / g.tile_w;
  return DwTile{(int)(blockIdx.x / tiles_w) * g.tile_h, (int)(blockIdx.x % tiles_w) * g.tile_w,
                (int)blockIdx.y * g.cg};
}

// Start staging image b's padded input window of tile t (zeros outside the
// image and past C) and the tile's fp32 taps; dw_stage_wait ends it.
template <typename T, int V>
__device__ __forceinline__ void dw_stage_issue(const T* __restrict__ x, const T* __restrict__ f,
                                               const DwGeometry& g, const DwLayout& l, T* win, float* taps,
                                               DwTile t, long long b) {
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int nv = g.cg / V;  // channel vectors of a tile pixel
  const int ih0 = t.oh0 * g.stride - g.pad_t, iw0 = t.ow0 * g.stride - g.pad_l;
  const int nwin = l.hw * l.ww;
  for (int e = tid; e < nwin * nv; e += nthr) {
    const int p = e / nv, v = e - p * nv;
    const int r = p / l.ww, q = p - r * l.ww;
    const int ih = ih0 + r, iw = iw0 + q, ch = t.c0 + v * V;
    const bool ok = ih >= 0 && ih < g.Hi && iw >= 0 && iw < g.Wi && ch < g.C;
    const T* src = x + ((b * g.Hi + ih) * g.Wi + iw) * g.C + ch;
    if constexpr (V > 1) {
      cp16(win + (size_t)e * V, ok ? src : x, ok);
    } else {
      win[e] = ok ? *src : from_f<T>(0.f);
    }
  }
  for (int e = tid; e < g.hf * g.wf * g.cg; e += nthr) {
    const int tp = e / g.cg, j = e - tp * g.cg;
    taps[e] = t.c0 + j < g.C ? to_f(f[(long long)tp * g.C + t.c0 + j]) : 0.f;
  }
}

// Returns when every thread of the CTA may read what it staged.
template <int V>
__device__ __forceinline__ void dw_stage_wait() {
  if constexpr (V > 1) cp_wait_all();
  __syncthreads();
}

template <typename T, int V>
__device__ __forceinline__ void dw_stage(const T* __restrict__ x, const T* __restrict__ f, const DwGeometry& g,
                                         const DwLayout& l, T* win, float* taps, DwTile t, long long b) {
  dw_stage_issue<T, V>(x, f, g, l, win, taps, t, b);
  dw_stage_wait<V>();
}

// What this thread computes: channel vector v (channels ch .. ch + V - 1),
// run rr of the tile (output row oh, columns ow .. ow + kDwRun - 1); live
// when the run has outputs inside the image and real channels.
struct DwThread {
  int v, rr, oh, ow, ch;
  bool live;
};

template <int V>
__device__ __forceinline__ DwThread dw_thread(const DwGeometry& g, DwTile t) {
  const int runs = g.tile_w / kDwRun;
  const int nv = g.cg / V;
  DwThread th;
  th.v = threadIdx.x % nv;
  th.rr = threadIdx.x / nv;
  th.oh = t.oh0 + th.rr / runs;
  th.ow = t.ow0 + th.rr % runs * kDwRun;
  th.ch = t.c0 + th.v * V;
  th.live = th.rr / runs < g.tile_h && th.oh < g.Ho && th.ow < g.Wo && th.ch < g.C;
  return th;
}

// acc[u][c]: the DW output at column ow + u of channel ch + c, from the
// staged window, in fp32.
template <typename T, int V, int KT, int S>
__device__ __forceinline__ void dw_run(const T* win, const float* taps, const DwGeometry& g, const DwLayout& l,
                                       const DwThread& th, float (&acc)[kDwRun][V]) {
  const int runs = g.tile_w / kDwRun;
  const int s = g.stride;
  const T* src = win + ((size_t)(th.rr / runs) * s * l.ww + (size_t)(th.rr % runs) * kDwRun * s) * g.cg + th.v * V;
  const float* tv = taps + th.v * V;

#pragma unroll
  for (int u = 0; u < kDwRun; ++u)
#pragma unroll
    for (int c = 0; c < V; ++c) acc[u][c] = 0.f;

  if constexpr (KT > 0) {
    constexpr int kIn = (kDwRun - 1) * S + KT;
#pragma unroll 1
    for (int n = 0; n < KT; ++n) {
      float tp[KT][V];
#pragma unroll
      for (int m = 0; m < KT; ++m) load_f<V>(tv + (size_t)(n * KT + m) * g.cg, tp[m]);
      const T* row = src + (size_t)n * l.ww * g.cg;
#pragma unroll
      for (int j = 0; j < kIn; ++j) {
        float in[V];
        load_f<V>(row + (size_t)j * g.cg, in);
#pragma unroll
        for (int u = 0; u < kDwRun; ++u) {
          const int m = j - u * S;
          if (m >= 0 && m < KT) {
#pragma unroll
            for (int c = 0; c < V; ++c) acc[u][c] = fmaf(in[c], tp[m][c], acc[u][c]);
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < kDwRun; ++u) {
      const T* su = src + (size_t)u * s * g.cg;
      for (int n = 0; n < g.hf; ++n) {
        for (int m = 0; m < g.wf; ++m) {
          float in[V], tp[V];
          load_f<V>(su + ((size_t)n * l.ww + m) * g.cg, in);
          load_f<V>(tv + (size_t)(n * g.wf + m) * g.cg, tp);
#pragma unroll
          for (int c = 0; c < V; ++c) acc[u][c] = fmaf(in[c], tp[c], acc[u][c]);
        }
      }
    }
  }
}

// The epilogue: DW + bias, then the activation (code as in common.cuh).
// bias holds V fp32 values, zeros where the layer has none.
template <int V>
__device__ __forceinline__ void dw_bias_act(float (&acc)[kDwRun][V], const float (&bias)[V], int act) {
#pragma unroll
  for (int u = 0; u < kDwRun; ++u)
#pragma unroll
    for (int c = 0; c < V; ++c) acc[u][c] = activate(acc[u][c] + bias[c], act);
}

// Store the run's in-image outputs once, at the store type O.
template <typename O, int V>
__device__ __forceinline__ void dw_store(O* __restrict__ out, const DwGeometry& g, const DwThread& th, long long b,
                                         const float (&acc)[kDwRun][V]) {
  O* o = out + ((b * g.Ho + th.oh) * g.Wo + th.ow) * g.C + th.ch;
#pragma unroll
  for (int u = 0; u < kDwRun; ++u) {
    if (th.ow + u >= g.Wo) break;
    if constexpr (V > 1) {
      Vec<O, V> r;
#pragma unroll
      for (int c = 0; c < V; ++c) r.v[c] = from_f<O>(acc[u][c]);
      *reinterpret_cast<Vec<O, V>*>(o + (size_t)u * g.C) = r;
    } else {
      o[(size_t)u * g.C] = from_f<O>(acc[u][0]);
    }
  }
}

}  // namespace repro
