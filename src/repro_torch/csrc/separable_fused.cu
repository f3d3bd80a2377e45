// Fused depthwise-separable block in one pass, in two modes:
//   fused2: out = act_pw(DW(x) -> +dw_bias -> act_dw  @ pw_w + pw_bias) [+ residual]
//   fused3: the same after a bias-free PW-expand of the raw input
//           (x @ expand_w -> act_exp), computed on the fly per tile.
// NHWC, VALID geometry (the wrapper pads SAME with zeros).
//
// Replaces repro/kernels/separable_fused.py::separable_fused_pallas (body
// _fused_kernel), both its 2-stage mode and its 3-stage mode (expand_w).
//
// What bounds it on the H100: at the main-path shapes the fused block moves
// only its input, its weights and its output, so it does 2*C*Co operations
// per output pixel (plus 2*Ci*C for the expand) against a few bytes; it is
// bound by operations on the CUDA cores, and the point of fusing is that
// neither the expanded tensor (6x the input in MobileNetV2) nor the DW
// output ever reaches device memory.  The design:
//   * one CTA of 256 threads per (batch, slab_h x tile_w output pixels, Co
//     panel of cob <= 64); slab_h * tile_w <= 64;
//   * the CTA loops over the DW channels in chunks of cb.  In fused3 it
//     first loads the raw (tile + halo) x Ci input window into shared
//     memory once, and per chunk computes the expanded chunk of that window
//     (halo included: it is recomputed per tile, never stored).  In fused2
//     it loads the (tile + halo) window of the chunk's input channels;
//   * in the load, expand and DW phases a thread owns one channel of the
//     chunk (tid % 64) and every fourth pixel, so its taps (3x3 or 5x5) and
//     DW bias sit in registers, global loads run along C, and pixel
//     coordinates advance without a division per element.  The fused3 raw window is
//     kept transposed in fp32, so the expand reads four adjacent pixels as
//     one vector per expand weight;
//   * it runs the DW over the chunk, adds the DW bias and applies the DW
//     activation into a shared fp32 tile stored channel-major (cb x pixels);
//   * it accumulates tile @ pw_w[chunk, panel] in a 4x4 register
//     micro-tile per thread (pixels 4ty.., channels 4tx..), reading four
//     pixels and four weights as two 16-byte vectors per step;
//   * the epilogue adds the PW bias, applies the activation, adds the
//     residual and stores once.  Channel, Co and image edges are masked.
// Zero SAME padding is sound because the expand is bias-free and every
// activation maps 0 to 0.  The products run on the CUDA cores in fp32, so
// the intermediates keep the reference's fp32 rounding; wgmma and TMA are
// work for a later PR.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;
constexpr int kLanes = 64;                 // a thread owns channel tid % 64 of a chunk
constexpr int kRows = kThreads / kLanes;   // and pixels tid / 64, + 4, + 8, ...
constexpr int kMaxPixels = 64;
constexpr int kMaxCo = 64;
constexpr int kMaxCb = kLanes;
constexpr int kQuad = 4;                   // pixels (or channels) per 16-byte vector
// Row strides (floats) of the DW tile, stored channel-major [cb][pixels],
// and of the PW weight chunk [cb][Co panel]: multiples of 4 so a thread
// reads four pixels or four channels as one 16-byte vector.
constexpr int kPixStride = kMaxPixels + kQuad;
constexpr int kCoStride = kMaxCo;

struct Geometry {
  int Hi, Wi, ci, c, co, Ho, Wo, hf, wf, stride, slab_h, tile_w, cb, cob;
  int act_exp, act_dw, act_pw;
};

// Shared-memory layout of one CTA; repro_torch/kernels/blocking.py
// ::fused_smem_bytes models the same regions in the same order.
struct Layout {
  size_t dw, pw, xwin, ew, xexp, total;
};

// The raw window of the 3-stage kernel is stored transposed, [ci][pixels]
// in fp32, each row padded to a multiple of four pixels.
__host__ __device__ inline size_t padded_window(size_t nwin) { return (nwin + kQuad - 1) / kQuad * kQuad; }

template <typename T>
Layout fused_layout(const Geometry& g, bool expand) {
  const size_t hin = (size_t)(g.slab_h - 1) * g.stride + g.hf;
  const size_t win = (size_t)(g.tile_w - 1) * g.stride + g.wf;
  Layout l{};
  size_t off = 0;
  l.dw = off; off += align16((size_t)g.cb * kPixStride * 4);
  l.pw = off; off += align16((size_t)g.cb * kCoStride * 4);
  if (expand) {
    l.xwin = off; off += align16(padded_window(hin * win) * g.ci * 4);
    l.ew = off; off += align16((size_t)g.ci * g.cb * 4);
    l.xexp = off; off += align16(hin * win * g.cb * 4);
  } else {
    l.xwin = off; off += align16(hin * win * g.cb * sizeof(T));
  }
  l.total = off;
  return l;
}

// Walks the pixels start, start + step, ... of a row-major grid `width`
// wide, keeping (row r, column q) without a division per step.
struct PixelWalk {
  int p, r, q;
  __device__ PixelWalk(int start, int width) : p(start), r(start / width), q(start % width) {}
  __device__ void advance(int step, int width) {
    p += step;
    q += step;
    while (q >= width) {
      q -= width;
      ++r;
    }
  }
};

// KT is 3 or 5 for a 3x3 or 5x5 filter, whose taps are held in registers;
// 0 for any other filter, whose taps are read from device memory per pixel.
template <typename T, typename O, bool EXPAND, int KT>
__global__ void __launch_bounds__(kThreads) fused_kernel(
    const T* __restrict__ x, const T* __restrict__ ew, const T* __restrict__ f,
    const T* __restrict__ dwb, const T* __restrict__ pw, const T* __restrict__ pwb,
    const T* __restrict__ res, O* __restrict__ out, Geometry g, Layout l) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ds = reinterpret_cast<float*>(smem + l.dw);     // [cb][kPixStride]
  float* ws = reinterpret_cast<float*>(smem + l.pw);     // [cb][kCoStride]
  T* xs = reinterpret_cast<T*>(smem + l.xwin);           // [hin*win][cb]  (fused2)
  float* xt = reinterpret_cast<float*>(smem + l.xwin);   // [ci][nwp]      (fused3)
  float* es = reinterpret_cast<float*>(smem + l.ew);     // [ci][cb]      (fused3)
  float* xe = reinterpret_cast<float*>(smem + l.xexp);   // [hin*win][cb] (fused3)

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // PW micro-tile: channels 4tx .. 4tx + 3
  const int ty = tid / 16;  //                pixels   4ty .. 4ty + 3
  const int lane = tid % kLanes;
  const int row = tid / kLanes;
  const int s = g.stride;
  const int hin = (g.slab_h - 1) * s + g.hf;
  const int win = (g.tile_w - 1) * s + g.wf;
  const int nwin = hin * win;
  const int nwp = (int)padded_window(nwin);
  const int npx = g.slab_h * g.tile_w;
  const int tiles_w = (g.Wo + g.tile_w - 1) / g.tile_w;
  const int oh0 = (blockIdx.x / tiles_w) * g.slab_h;
  const int ow0 = (blockIdx.x % tiles_w) * g.tile_w;
  const int ih0 = oh0 * s;
  const int iw0 = ow0 * s;
  const int n0 = blockIdx.y * g.cob;
  const long long b = blockIdx.z;
  const int cin = EXPAND ? g.ci : g.c;  // channels of x

  if (EXPAND) {
    // the raw (tile + halo) x Ci window, once per CTA, transposed to fp32
    for (int e = tid; e < nwin * g.ci; e += kThreads) {
      const int pix = e / g.ci;
      const int k = e % g.ci;
      const int ih = ih0 + pix / win;
      const int iw = iw0 + pix % win;
      xt[k * nwp + pix] =
          (ih < g.Hi && iw < g.Wi) ? to_f(x[((b * g.Hi + ih) * g.Wi + iw) * cin + k]) : 0.f;
    }
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < g.c; c0 += g.cb) {
    const int cc = min(g.cb, g.c - c0);
    const bool active = lane < cc;  // this thread's channel is in the chunk
    const int ch = c0 + lane;
    for (int k = row; k < cc; k += kRows)
      ws[k * kCoStride + lane] = lane < g.cob && n0 + lane < g.co
                                     ? to_f(pw[(long long)(c0 + k) * g.co + n0 + lane])
                                     : 0.f;
    if (EXPAND) {
      if (active)
        for (int k = row; k < g.ci; k += kRows) es[k * g.cb + lane] = to_f(ew[(long long)k * g.c + ch]);
      __syncthreads();
      // expanded chunk of the whole window, halo included, four adjacent
      // pixels at a time: one vector read of the window and one weight read
      // per four multiply-adds (the padding pixels are computed, never stored)
      if (active) {
        for (int p0 = row * kQuad; p0 < nwin; p0 += kRows * kQuad) {
          float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int k = 0; k < g.ci; ++k) {
            const float e = es[k * g.cb + lane];
            const float4 xv = *reinterpret_cast<const float4*>(xt + k * nwp + p0);
            sum.x = fmaf(xv.x, e, sum.x);
            sum.y = fmaf(xv.y, e, sum.y);
            sum.z = fmaf(xv.z, e, sum.z);
            sum.w = fmaf(xv.w, e, sum.w);
          }
          const float r4[kQuad] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
          for (int u = 0; u < kQuad; ++u)
            if (p0 + u < nwin) xe[(p0 + u) * g.cb + lane] = activate(r4[u], g.act_exp);
        }
      }
    } else if (active) {
      for (PixelWalk w(row, win); w.p < nwin; w.advance(kRows, win)) {
        const int ih = ih0 + w.r;
        const int iw = iw0 + w.q;
        xs[w.p * g.cb + lane] = (ih < g.Hi && iw < g.Wi)
                                    ? x[((b * g.Hi + ih) * g.Wi + iw) * cin + ch]
                                    : from_f<T>(0.f);
      }
    }
    __syncthreads();

    // DW over the chunk, + bias, activation -> ds (fp32); the thread's
    // channel is fixed, so its taps and bias sit in registers
    if (active) {
      const float bias = dwb != nullptr ? to_f(dwb[ch]) : 0.f;
      float taps[KT > 0 ? KT * KT : 1];
      if (KT > 0) {
#pragma unroll
        for (int n = 0; n < KT; ++n)
#pragma unroll
          for (int m = 0; m < KT; ++m)
            taps[n * KT + m] = to_f(f[(long long)(n * KT + m) * g.c + ch]);
      }
      auto src = [&](int pix) -> float {
        return EXPAND ? xe[pix * g.cb + lane] : to_f(xs[pix * g.cb + lane]);
      };
      for (PixelWalk w(row, g.tile_w); w.p < npx; w.advance(kRows, g.tile_w)) {
        const int base = w.r * s * win + w.q * s;
        float sum = 0.f;
        if (KT > 0) {
#pragma unroll
          for (int n = 0; n < KT; ++n)
#pragma unroll
            for (int m = 0; m < KT; ++m) sum = fmaf(src(base + n * win + m), taps[n * KT + m], sum);
        } else {
          for (int n = 0; n < g.hf; ++n)
            for (int m = 0; m < g.wf; ++m)
              sum = fmaf(src(base + n * win + m), to_f(f[(long long)(n * g.wf + m) * g.c + ch]), sum);
        }
        ds[lane * kPixStride + w.p] = activate(sum + bias, g.act_dw);
      }
    }
    __syncthreads();

    // PW: acc += ds[pixels, chunk] @ ws[chunk, panel], two 16-byte shared
    // reads per 16 multiply-adds.  Pixels past the tile and channels past
    // the panel compute on padding and are never stored.
    for (int k = 0; k < cc; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(ds + k * kPixStride + ty * kQuad);
      const float4 wv = *reinterpret_cast<const float4*>(ws + k * kCoStride + tx * kQuad);
      const float a[4] = {av.x, av.y, av.z, av.w};
      const float w4[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w4[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ty * kQuad + i;
    if (p >= npx) continue;
    const int oh = oh0 + p / g.tile_w;
    const int ow = ow0 + p % g.tile_w;
    if (oh >= g.Ho || ow >= g.Wo) continue;
    const long long obase = ((b * g.Ho + oh) * g.Wo + ow) * g.co;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nl = tx * kQuad + j;
      const int n = n0 + nl;
      if (nl >= g.cob || n >= g.co) continue;
      float v = acc[i][j];
      if (pwb != nullptr) v += to_f(pwb[n]);
      v = activate(v, g.act_pw);
      if (res != nullptr) v += to_f(res[obase + n]);
      out[obase + n] = from_f<O>(v);
    }
  }
}

template <typename T, typename O, bool EXPAND, int KT>
int launch_mode(const void* x, const void* ew, const void* f, const void* dwb, const void* pw,
                const void* pwb, const void* res, void* out, int B, const Geometry& g,
                cudaStream_t stream) {
  const Layout l = fused_layout<T>(g, EXPAND);
  if (l.total > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(fused_kernel<T, O, EXPAND, KT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.total);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((g.Ho + g.slab_h - 1) / g.slab_h) * ((g.Wo + g.tile_w - 1) / g.tile_w);
  const dim3 grid((unsigned)tiles, (unsigned)((g.co + g.cob - 1) / g.cob), (unsigned)B);
  fused_kernel<T, O, EXPAND, KT><<<grid, kThreads, l.total, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ew), static_cast<const T*>(f),
      static_cast<const T*>(dwb), static_cast<const T*>(pw), static_cast<const T*>(pwb),
      static_cast<const T*>(res), static_cast<O*>(out), g, l);
  return (int)cudaGetLastError();
}

template <typename T, typename O>
int launch_io(const void* x, const void* ew, const void* f, const void* dwb, const void* pw,
              const void* pwb, const void* res, void* out, int B, const Geometry& g,
              cudaStream_t stream) {
  const int kt = g.hf == g.wf && (g.hf == 3 || g.hf == 5) ? g.hf : 0;
#define REPRO_FUSED_CASE(E, KT)                                                          \
  if ((ew != nullptr) == E && kt == KT)                                                \
    return launch_mode<T, O, E, KT>(x, ew, f, dwb, pw, pwb, res, out, B, g, stream);
  REPRO_FUSED_CASE(true, 3)
  REPRO_FUSED_CASE(true, 5)
  REPRO_FUSED_CASE(true, 0)
  REPRO_FUSED_CASE(false, 3)
  REPRO_FUSED_CASE(false, 5)
  REPRO_FUSED_CASE(false, 0)
#undef REPRO_FUSED_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T>
size_t smem_of(const Geometry& g, bool expand) {
  return fused_layout<T>(g, expand).total;
}

}  // namespace

REPRO_EXPORT_ERROR_STRING(separable_fused)

// x (B, Hi, Wi, ci if expand_w else c); expand_w (ci, c) or null;
// f (hf, wf, c); dw_bias (c) or null; pw_w (c, co); pw_bias (co) or null;
// residual (B, Ho, Wo, co) or null: all at the stream type.  out
// (B, Ho, Wo, co) at the store type.  slab_h * tile_w <= 64, cob <= 64,
// cb <= 64.
extern "C" int separable_fused_launch(const void* x, const void* expand_w, const void* f,
                                      const void* dw_bias, const void* pw_w, const void* pw_bias,
                                      const void* residual, void* out, int B, int Hi, int Wi,
                                      int ci, int c, int co, int Ho, int Wo, int hf, int wf,
                                      int stride, int slab_h, int tile_w, int cb, int cob,
                                      int act_exp, int act_dw, int act_pw, int in_dtype,
                                      int out_dtype, void* stream) {
  if (slab_h < 1 || tile_w < 1 || slab_h * tile_w > kMaxPixels || cob < 1 || cob > kMaxCo ||
      cb < 1 || cb > kMaxCb || B < 1)
    return (int)cudaErrorInvalidValue;
  const Geometry g{Hi, Wi, ci, c, co, Ho, Wo, hf, wf, stride, slab_h, tile_w, cb, cob,
                   act_exp, act_dw, act_pw};
  REPRO_DISPATCH_IO(in_dtype, out_dtype, launch_io, x, expand_w, f, dw_bias, pw_w, pw_bias,
                    residual, out, B, g, static_cast<cudaStream_t>(stream));
}

// Shared memory one CTA of this geometry needs, in bytes (0 for an unknown
// dtype): lets the wrapper check the planner's model against the kernel.
extern "C" long long separable_fused_smem_bytes(int ci, int c, int hf, int wf, int stride,
                                                int slab_h, int tile_w, int cb, int cob,
                                                int expand, int in_dtype) {
  const Geometry g{0, 0, ci, c, 0, 0, 0, hf, wf, stride, slab_h, tile_w, cb, cob, 0, 0, 0};
  if (in_dtype == repro::kF32) return (long long)smem_of<float>(g, expand != 0);
  if (in_dtype == repro::kBF16) return (long long)smem_of<__nv_bfloat16>(g, expand != 0);
  if (in_dtype == repro::kF16) return (long long)smem_of<__half>(g, expand != 0);
  return 0;
}
