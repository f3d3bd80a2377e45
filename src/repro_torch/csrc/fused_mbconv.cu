// Fused-MBConv block in one pass:
//   out = act_pw(act_mb(conv(x, f) + mb_bias) @ pw_w + pw_bias) [+ residual]
// where conv is a dense Hf x Wf convolution Ci -> C at the given stride.
// NHWC, VALID geometry (the wrapper pads SAME with zeros).
//
// Replaces repro/kernels/fused_mbconv.py::fused_mbconv_pallas (body
// _fused_mb_kernel).
//
// What bounds it on the H100: operations.  At EfficientNet-Lite0's four
// fused-MBConv blocks the conv does 2*Hf*Wf*Ci*C operations per output
// pixel (144..2160 per input byte), so it is bound by fp32 operations on
// the CUDA cores, and the point of fusing is that the expanded tensor (6x
// the input) never reaches device memory.  The design follows the 3-stage
// mode of separable_fused.cu with the dense conv in place of expand + DW:
//   * one CTA of 256 threads per (batch, slab_h x tile_w output pixels, Co
//     panel of cob <= 64); slab_h * tile_w <= 64;
//   * the CTA loads the raw (tile + halo) x Ci input window once, transposed
//     to fp32 ([ci][pixels]);
//   * it loops over the conv-output channels in chunks of cb <= 64.  Per
//     chunk it stages the fp32 filter chunk (Hf*Wf*Ci rows of cb channels)
//     and the PW weight chunk, then computes the chunk as a small GEMM,
//     (tile pixels) x (Hf*Wf*Ci) x (cb), in a 4x4 register micro-tile per
//     thread (pixels 4ty.., channels 4tx..): four scalar window reads and
//     one 16-byte filter read per 16 multiply-adds;
//   * it adds the conv bias, applies the activation and stores the chunk
//     channel-major in shared memory as fp32; the chunk never leaves the CTA;
//   * it accumulates chunk @ pw_w[chunk, panel] in a second 4x4 register
//     micro-tile, reading four pixels and four weights as 16-byte vectors;
//   * the epilogue adds the PW bias, applies the activation, adds the
//     residual and stores once.  Channel, Co and image edges are masked.
// The products run on the CUDA cores in fp32, so the conv output keeps the
// reference's fp32 rounding; an implicit-GEMM conv on wgmma is later work.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;
constexpr int kMaxPixels = 64;
constexpr int kMaxCo = 64;
constexpr int kMaxCb = 64;
constexpr int kQuad = 4;
// Row strides (floats) of the conv chunk, stored channel-major [cb][pixels],
// and of the PW weight chunk [cb][Co panel].
constexpr int kPixStride = kMaxPixels + kQuad;
constexpr int kCoStride = kMaxCo;

struct Geometry {
  int Hi, Wi, ci, c, co, Ho, Wo, hf, wf, stride, slab_h, tile_w, cb, cob;
  int act_mb, act_pw;
};

__host__ __device__ inline int round4(int n) { return (n + kQuad - 1) / kQuad * kQuad; }

// Shared-memory layout of one CTA; repro_torch/kernels/blocking.py
// ::fused_mb_smem_bytes models the same regions in the same order.
struct Layout {
  size_t conv, pw, xwin, filt, total;
};

Layout mb_layout(const Geometry& g) {
  const int hin = (g.slab_h - 1) * g.stride + g.hf;
  const int win = (g.tile_w - 1) * g.stride + g.wf;
  Layout l{};
  size_t off = 0;
  l.conv = off; off += align16((size_t)g.cb * kPixStride * 4);
  l.pw = off; off += align16((size_t)g.cb * kCoStride * 4);
  l.xwin = off; off += align16((size_t)round4(hin * win) * g.ci * 4);
  l.filt = off; off += align16((size_t)g.hf * g.wf * g.ci * round4(g.cb) * 4);
  l.total = off;
  return l;
}

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads) fused_mb_kernel(
    const T* __restrict__ x, const T* __restrict__ f, const T* __restrict__ mbb,
    const T* __restrict__ pw, const T* __restrict__ pwb, const T* __restrict__ res,
    O* __restrict__ out, Geometry g, Layout l) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* cs = reinterpret_cast<float*>(smem + l.conv);  // [cb][kPixStride]
  float* ws = reinterpret_cast<float*>(smem + l.pw);    // [cb][kCoStride]
  float* xt = reinterpret_cast<float*>(smem + l.xwin);  // [ci][nwp]
  float* fs = reinterpret_cast<float*>(smem + l.filt);  // [hf*wf*ci][cbs]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // channels 4tx .. 4tx + 3 (conv chunk, PW panel)
  const int ty = tid / 16;  // pixels   4ty .. 4ty + 3
  const int s = g.stride;
  const int hin = (g.slab_h - 1) * s + g.hf;
  const int win = (g.tile_w - 1) * s + g.wf;
  const int nwin = hin * win;
  const int nwp = round4(nwin);
  const int npx = g.slab_h * g.tile_w;
  const int cbs = round4(g.cb);
  const int ktot = g.hf * g.wf * g.ci;
  const int tiles_w = (g.Wo + g.tile_w - 1) / g.tile_w;
  const int oh0 = (blockIdx.x / tiles_w) * g.slab_h;
  const int ow0 = (blockIdx.x % tiles_w) * g.tile_w;
  const int ih0 = oh0 * s;
  const int iw0 = ow0 * s;
  const int n0 = blockIdx.y * g.cob;
  const long long b = blockIdx.z;

  // the raw (tile + halo) x Ci window, once per CTA, transposed to fp32
  for (int e = tid; e < nwin * g.ci; e += kThreads) {
    const int pix = e / g.ci;
    const int k = e % g.ci;
    const int ih = ih0 + pix / win;
    const int iw = iw0 + pix % win;
    xt[k * nwp + pix] =
        (ih < g.Hi && iw < g.Wi) ? to_f(x[((b * g.Hi + ih) * g.Wi + iw) * g.ci + k]) : 0.f;
  }

  // window offset of the (0, 0) tap of this thread's four pixels (pixels
  // past the tile repeat the last one and are never stored)
  int pb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = min(ty * kQuad + i, npx - 1);
    pb[i] = (p / g.tile_w) * s * win + (p % g.tile_w) * s;
  }
  const bool conv_px = ty * kQuad < npx;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < g.c; c0 += g.cb) {
    const int cc = min(g.cb, g.c - c0);
    for (int e = tid; e < cc * kCoStride; e += kThreads) {
      const int k = e / kCoStride;
      const int nl = e % kCoStride;
      ws[e] = nl < g.cob && n0 + nl < g.co ? to_f(pw[(long long)(c0 + k) * g.co + n0 + nl]) : 0.f;
    }
    for (int e = tid; e < ktot * cbs; e += kThreads) {
      const int r = e / cbs;
      const int k = e % cbs;
      fs[e] = k < cc ? to_f(f[(long long)r * g.c + c0 + k]) : 0.f;
    }
    __syncthreads();

    // conv chunk: (tile pixels) x (taps * ci) x (chunk channels)
    if (conv_px && tx * kQuad < cc) {
      float cv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cv[i][j] = 0.f;
      for (int n = 0; n < g.hf; ++n) {
        for (int m = 0; m < g.wf; ++m) {
          const float* xk = xt + n * win + m;
          const float* fk = fs + (size_t)(n * g.wf + m) * g.ci * cbs + tx * kQuad;
          for (int k = 0; k < g.ci; ++k, xk += nwp, fk += cbs) {
            const float a[4] = {xk[pb[0]], xk[pb[1]], xk[pb[2]], xk[pb[3]]};
            const float4 wv = *reinterpret_cast<const float4*>(fk);
            const float w4[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) cv[i][j] = fmaf(a[i], w4[j], cv[i][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ch = tx * kQuad + j;
        if (ch >= cc) continue;
        const float bias = mbb != nullptr ? to_f(mbb[c0 + ch]) : 0.f;
        float4 v;
        v.x = activate(cv[0][j] + bias, g.act_mb);
        v.y = activate(cv[1][j] + bias, g.act_mb);
        v.z = activate(cv[2][j] + bias, g.act_mb);
        v.w = activate(cv[3][j] + bias, g.act_mb);
        *reinterpret_cast<float4*>(cs + ch * kPixStride + ty * kQuad) = v;
      }
    }
    __syncthreads();

    // PW: acc += cs[pixels, chunk] @ ws[chunk, panel].  Pixels past the
    // tile and channels past the panel compute on padding, never stored.
    for (int k = 0; k < cc; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(cs + k * kPixStride + ty * kQuad);
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

template <typename T, typename O>
int launch_io(const void* x, const void* f, const void* mbb, const void* pw, const void* pwb,
              const void* res, void* out, int B, const Geometry& g, cudaStream_t stream) {
  const Layout l = mb_layout(g);
  if (l.total > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(fused_mb_kernel<T, O>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.total);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((g.Ho + g.slab_h - 1) / g.slab_h) * ((g.Wo + g.tile_w - 1) / g.tile_w);
  const dim3 grid((unsigned)tiles, (unsigned)((g.co + g.cob - 1) / g.cob), (unsigned)B);
  fused_mb_kernel<T, O><<<grid, kThreads, l.total, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(f), static_cast<const T*>(mbb),
      static_cast<const T*>(pw), static_cast<const T*>(pwb), static_cast<const T*>(res),
      static_cast<O*>(out), g, l);
  return (int)cudaGetLastError();
}

}  // namespace

REPRO_EXPORT_ERROR_STRING(fused_mbconv)

// x (B, Hi, Wi, ci); f (hf, wf, ci, c); mb_bias (c) or null; pw_w (c, co);
// pw_bias (co) or null; residual (B, Ho, Wo, co) or null: all at the stream
// type.  out (B, Ho, Wo, co) at the store type.  slab_h * tile_w <= 64,
// cob <= 64, cb <= 64.
extern "C" int fused_mbconv_launch(const void* x, const void* f, const void* mb_bias,
                                   const void* pw_w, const void* pw_bias, const void* residual,
                                   void* out, int B, int Hi, int Wi, int ci, int c, int co,
                                   int Ho, int Wo, int hf, int wf, int stride, int slab_h,
                                   int tile_w, int cb, int cob, int act_mb, int act_pw,
                                   int in_dtype, int out_dtype, void* stream) {
  if (slab_h < 1 || tile_w < 1 || slab_h * tile_w > kMaxPixels || cob < 1 || cob > kMaxCo ||
      cb < 1 || cb > kMaxCb || B < 1 || ci < 1)
    return (int)cudaErrorInvalidValue;
  const Geometry g{Hi, Wi, ci, c, co, Ho, Wo, hf, wf, stride, slab_h, tile_w, cb, cob,
                   act_mb, act_pw};
  REPRO_DISPATCH_IO(in_dtype, out_dtype, launch_io, x, f, mb_bias, pw_w, pw_bias, residual, out,
                    B, g, static_cast<cudaStream_t>(stream));
}

// Shared memory one CTA of this geometry needs, in bytes: lets the wrapper
// check the planner's model against the kernel.
extern "C" long long fused_mbconv_smem_bytes(int ci, int hf, int wf, int stride, int slab_h,
                                             int tile_w, int cb, int cob) {
  const Geometry g{0, 0, ci, 0, 0, 0, 0, hf, wf, stride, slab_h, tile_w, cb, cob, 0, 0};
  return (long long)mb_layout(g).total;
}
