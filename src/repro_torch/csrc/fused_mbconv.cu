// Fused-MBConv block in one pass:
//   out = act_pw(act_mb(conv(x, f) + mb_bias) @ pw_w + pw_bias) [+ residual]
// where conv is a dense Hf x Wf convolution Ci -> C at the given stride.
// NHWC.  The kernel reads x as it lies and applies the zero padding itself
// (pad_t rows above, pad_l columns left; whatever lies past the input's far
// edges is zero too), so the wrapper's VALID geometry is pad 0.
//
// Replaces repro/kernels/fused_mbconv.py::fused_mbconv_pallas (body
// _fused_mb_kernel).
//
// What bounds it on the H100: operations.  At EfficientNet-Lite0's four
// fused-MBConv blocks the conv does 2*Hf*Wf*Ci*C operations per output
// pixel (144..2160 per input byte) and the project 2*C*Co more; the point
// of fusing is that the conv output (6x the input) never reaches device
// memory.  The design is separable_fused.cuh's with the dense conv, an
// implicit GEMM, in place of expand + DW:
//   * a CTA owns a tile of slab_h output rows by tile_w columns (full-width
//     rows wherever the window fits) of one image and a slice of cs
//     conv-output channels; a thread-block cluster of up to 8 CTAs splits
//     C, so each conv value is computed once, and the cluster sums its
//     partial projections through distributed shared memory in rank order
//     (tile_gemm.cuh::project_store: bit-for-bit repeatable).  Grid
//     (cluster, slabs, batch); blocking.py::plan_fused_mb sizes the slabs
//     and the cluster to fill the card's 132 SMs;
//   * the CTA stages its tile's padded input window once, pixel-major at
//     the stream type's width of work (16-byte cp.async copies that
//     zero-fill outside the image), and loops over chunks of cb channels of
//     its slice.  Each chunk's filter columns are copied as they lie in
//     device memory (hf*wf*Ci rows, 16 bytes a thread, no per-element
//     division), double-buffered: the next chunk's copy is in flight while
//     the current chunk multiplies;
//   * the conv chunk is an M x K x N product: M = the tile's pixels, K =
//     Hf*Wf*Ci (each tap's Ci-row of the window), N = the chunk.  Bias and
//     activation are applied in registers and the chunk is stored into the
//     CTA's resident tile of its slice, which then feeds the project;
//   * bf16: both products on the tensor cores (mma.sync m16n8k16, fp32
//     accumulators, a warp's 32x32 block sharing its fragments, loaded with
//     ldmatrix).  The conv's operands
//     are bf16 as given (exact products); the conv output is stored as
//     hi = bf16(a) and lo = bf16(a - hi) and the project runs hi @ w +
//     lo @ w, so the output still rounds once, at its store;
//   * fp32 (and fp16): exact fp32 FMAs on the CUDA cores, 8x8 register
//     tiles (4x4 when too few), each thread reading its pixels' window rows
//     as 16-byte vectors along Ci and the filter as 16-byte vectors along C.
#include "tile_gemm.cuh"

namespace {

using namespace repro;

struct Geometry {
  int Hi, Wi, pad_t, pad_l, ci, c, co, Ho, Wo, hf, wf, stride, slab_h, tile_w, cb, cs, np, cluster;
  int act_mb, act_pw, vec_x, vec_f, vec_w, out_f32;
};

// Shared-memory layout of one CTA; repro_torch/kernels/blocking.py
// ::fused_mb_smem_bytes models the same regions.  The resident tile (dw,
// and dw_lo for bf16) stays through both phases; the window and the filter
// buffers (phase A) and the project's weights, bias and partial tile
// (phase B) share the rest.  pm: pixel rows of the tile; sa: its 16-bit K
// rows; cip: Ci padded to the product's K step; sk: a window pixel's row;
// lf: a filter row; lw: a 16-bit project-weight row.
struct Layout {
  size_t dw, dw_lo, win, filt, w, bs, part, total;
  int pm, sa, cip, sk, lf, lw, nbuf;
  size_t filt_bytes;
};

template <bool TC>
Layout mb_layout(const Geometry& g) {
  const int p = g.slab_h * g.tile_w;
  const int hwin = (g.slab_h - 1) * g.stride + g.hf;
  const int wwin = (g.tile_w - 1) * g.stride + g.wf;
  Layout l{};
  l.nbuf = (g.cs + g.cb - 1) / g.cb > 1 ? 2 : 1;
  l.sa = up(g.cs, 16) + 8;
  l.lw = g.np + 8;
  size_t off = 0;
  if (TC) {
    l.pm = up(p, 16);
    l.cip = up(g.ci, 16);
    l.sk = l.cip + 8;
    l.lf = up(g.cb, 8) + 8;
    l.dw = off; off += align16((size_t)l.pm * l.sa * 2);
    l.dw_lo = off; off += align16((size_t)l.pm * l.sa * 2);
  } else {
    l.pm = up(p, 8);
    l.cip = up(g.ci, 4);
    l.sk = (l.cip / 4 | 1) * 4;  // an odd number of 16-byte columns
    l.lf = up(g.cb, 8);
    l.dw = off; off += align16((size_t)g.cs * l.pm * 4);
  }
  const int eb = TC ? 2 : 4;
  const size_t base = off;
  l.win = off; off += align16((size_t)hwin * wwin * l.sk * eb);
  l.filt_bytes = align16((size_t)g.hf * g.wf * l.cip * l.lf * eb);
  l.filt = off; off += l.nbuf * l.filt_bytes;
  const size_t end_a = off;
  off = base;
  l.w = off; off += TC ? align16((size_t)up(g.cs, 16) * l.lw * 2) : align16((size_t)g.cs * g.np * 4);
  l.bs = off; off += align16((size_t)g.np * 4);
  l.part = off; off += align16((size_t)l.pm * g.np * 4);
  l.total = end_a > off ? end_a : off;
  return l;
}

// Conv of one chunk on the CUDA cores: M pixels of a tile tw wide, whose
// window is wwin wide (strided over the m-tiles:
// m-tile mt owns pixels mt, mt + MT, ..., so neighbouring threads read
// neighbouring window pixels) by N channels; put(p, n, v) takes each result.
template <int TM, int TN, typename F>
__device__ __forceinline__ void conv_simt(const float* __restrict__ win, const float* __restrict__ filt, int sk,
                                          int lf, int cip, int hf, int wf, int wwin, int s, int tw, int M, int N,
                                          F&& put) {
  const int MT = (M + TM - 1) / TM;
  const int tn = (N + TN - 1) / TN;
  for (int t = threadIdx.x; t < MT * tn; t += kThreads) {
    const int mt = t % MT, n0 = t / MT * TN;
    int off[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int p = min(mt + i * MT, M - 1);
      off[i] = ((p / tw) * s * wwin + (p % tw) * s) * sk;
    }
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (int kh = 0; kh < hf; ++kh) {
      for (int kw = 0; kw < wf; ++kw) {
        const float* a = win + (kh * wwin + kw) * sk;
        const float* bm = filt + (size_t)(kh * wf + kw) * cip * lf + n0;
        for (int ci = 0; ci < cip; ci += 4) {
          float4 av[TM];
#pragma unroll
          for (int i = 0; i < TM; ++i) av[i] = *reinterpret_cast<const float4*>(a + off[i] + ci);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float bv[TN];
#pragma unroll
            for (int j = 0; j < TN; j += 4) {
              const float4 v = *reinterpret_cast<const float4*>(bm + (size_t)(ci + u) * lf + j);
              bv[j] = v.x; bv[j + 1] = v.y; bv[j + 2] = v.z; bv[j + 3] = v.w;
            }
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              const float ai = u == 0 ? av[i].x : u == 1 ? av[i].y : u == 2 ? av[i].z : av[i].w;
#pragma unroll
              for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int p = mt + i * MT;
      if (p >= M) break;
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (n0 + j < N) put(p, n0 + j, acc[i][j]);
    }
  }
}

// Conv of one chunk on the tensor cores (M pixels of a tile tw wide, whose
// window is wwin wide): a warp owns a 32-pixel x 32-channel block at a time
// (two m16 rows of four m16n8k16 accumulators, sharing each B fragment), A
// from the bf16 window (rows = pixels, ldmatrix), B from the filter chunk
// (rows = k, ldmatrix.trans); put(m, n, v0, v1) takes the results of
// columns n (even) and n + 1 (v1 past N is not used).
template <typename F>
__device__ __forceinline__ void conv_tc(const __nv_bfloat16* __restrict__ win,
                                        const __nv_bfloat16* __restrict__ filt, int sk, int lf, int cip, int hf,
                                        int wf, int wwin, int s, int tw, int M, int N, F&& put) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int nchunks = (N + 31) / 32;
  const int items = (M + 31) / 32 * nchunks;
  // this lane's ldmatrix rows: A pixel m0 + ar (k + ak), B row k + br (n + bn)
  const int ar = lane % 8 + 8 * (lane / 8 % 2), ak = 8 * (lane / 16);
  const int br = ar, bn = ak;
  for (int it = warp; it < items; it += kWarps) {
    const int m0 = it / nchunks * 32, n0 = it % nchunks * 32;
    const int nb = min(4, (N - n0 + 7) / 8);
    const bool two = m0 + 16 < M;
    const __nv_bfloat16* a[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = min(m0 + 16 * h + ar, M - 1);
      a[h] = win + (size_t)((p / tw) * s * wwin + (p % tw) * s) * sk + ak;
    }
    float acc[2][4][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[h][j][i] = 0.f;
    for (int kh = 0; kh < hf; ++kh) {
      for (int kw = 0; kw < wf; ++kw) {
        const size_t tap = (size_t)(kh * wwin + kw) * sk;
        const __nv_bfloat16* bt = filt + ((size_t)(kh * wf + kw) * cip + br) * lf + n0 + bn;
        for (int k0 = 0; k0 < cip; k0 += 16) {
          uint32_t a0[4], a1[4], b01[4], b23[4];
          ldsm_x4<true>(b01, bt + (size_t)k0 * lf);
          if (nb > 2) ldsm_x4<true>(b23, bt + (size_t)k0 * lf + 16);
          ldsm_x4<false>(a0, a[0] + tap + k0);
          mma_bf16(acc[0][0], a0, b01[0], b01[1]);
          mma_bf16(acc[0][1], a0, b01[2], b01[3]);
          if (nb > 2) {
            mma_bf16(acc[0][2], a0, b23[0], b23[1]);
            mma_bf16(acc[0][3], a0, b23[2], b23[3]);
          }
          if (two) {
            ldsm_x4<false>(a1, a[1] + tap + k0);
            mma_bf16(acc[1][0], a1, b01[0], b01[1]);
            mma_bf16(acc[1][1], a1, b01[2], b01[3]);
            if (nb > 2) {
              mma_bf16(acc[1][2], a1, b23[0], b23[1]);
              mma_bf16(acc[1][3], a1, b23[2], b23[3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= nb) continue;
        const int n = n0 + j * 8 + 2 * tq;
        if (n >= N) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = m0 + 16 * h + gq + 8 * r;
          if (m < M) put(m, n, acc[h][j][2 * r], acc[h][j][2 * r + 1]);
        }
      }
  }
}

// Grid (cluster, tiles, batch), clusters along x: rank r owns conv-output
// channels [r * cs, min(C, (r + 1) * cs)) of output tile y (slab y / ntw,
// column block y % ntw) of image z.  fp32's 8x8 register tiles take about
// 180 registers a thread, so one CTA an SM (faster on the card than two
// that spill); bf16's tensor-core tiles fit two.
template <typename T>
__global__ void __launch_bounds__(kThreads, std::is_same<T, __nv_bfloat16>::value ? 2 : 1) fused_mb_kernel(
    const T* __restrict__ x, const T* __restrict__ f, const T* __restrict__ mbb,
    const T* __restrict__ pw, const T* __restrict__ pwb, const T* __restrict__ res,
    void* __restrict__ out, Geometry g, Layout l) {
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  constexpr int V = 16 / sizeof(T);  // elements of a 16-byte vector
  using W = typename std::conditional<TC, __nv_bfloat16, float>::type;  // window / filter element
  extern __shared__ __align__(16) unsigned char smem[];
  float* dwt = reinterpret_cast<float*>(smem + l.dw);                     // [cs][pm]    (fp32)
  __nv_bfloat16* dhi = reinterpret_cast<__nv_bfloat16*>(smem + l.dw);     // [pm][sa]    (bf16)
  __nv_bfloat16* dlo = reinterpret_cast<__nv_bfloat16*>(smem + l.dw_lo);  // [pm][sa]    (bf16)
  W* win = reinterpret_cast<W*>(smem + l.win);                            // [window][sk]
  float* ws = reinterpret_cast<float*>(smem + l.w);                       // [cs][np]    (fp32)
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem + l.w);       // [c16][lw]   (bf16)
  float* bsm = reinterpret_cast<float*>(smem + l.bs);                     // [np]
  float* part = reinterpret_cast<float*>(smem + l.part);                  // [pm][np]
  auto filt = [&](int i) { return reinterpret_cast<W*>(smem + l.filt + (i % l.nbuf) * l.filt_bytes); };

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int s = g.stride;
  const int c_lo = rank * g.cs;
  const int c_n = min(g.cs, g.c - c_lo);
  const int ntw = (g.Wo + g.tile_w - 1) / g.tile_w;
  const int oh0 = blockIdx.y / ntw * g.slab_h, ow0 = blockIdx.y % ntw * g.tile_w;
  const int tw = min(g.tile_w, g.Wo - ow0);  // this tile's width
  const int P = min(g.slab_h, g.Ho - oh0) * tw;
  const long long b = blockIdx.z;
  const int hwin = (min(g.slab_h, g.Ho - oh0) - 1) * s + g.hf;
  const int wwin = (tw - 1) * s + g.wf;
  const int nwin = hwin * wwin;
  const int ih0 = oh0 * s - g.pad_t, iw0 = ow0 * s - g.pad_l;
  const int ntaps = g.hf * g.wf;

  // the 16-bit resident tile's K padding stays zero for the project
  if (TC) {
    uint4* z = reinterpret_cast<uint4*>(dhi);
    const int n16 = (int)((size_t)2 * l.pm * l.sa * 2 / 16);
    for (int i = tid; i < n16; i += kThreads) z[i] = make_uint4(0, 0, 0, 0);
  }
  // the tile's padded input window, pixel-major; channels past Ci are zero
  {
    const bool cp = g.vec_x && (TC || std::is_same<T, float>::value);
    if (cp) {
      const int civ = g.ci / V;
      for (int e = tid; e < nwin * civ; e += kThreads) {
        const int px = e / civ, v = e - px * civ;
        const int r = px / wwin, q = px - r * wwin;
        const int ih = ih0 + r, iw = iw0 + q;
        const bool ok = ih >= 0 && ih < g.Hi && iw >= 0 && iw < g.Wi;
        cp16(win + (size_t)px * l.sk + v * V, ok ? x + ((b * g.Hi + ih) * g.Wi + iw) * g.ci + v * V : x, ok);
      }
    } else {
      for (int e = tid; e < nwin * g.ci; e += kThreads) {
        const int px = e / g.ci, k = e - px * g.ci;
        const int r = px / wwin, q = px - r * wwin;
        const int ih = ih0 + r, iw = iw0 + q;
        const bool ok = ih >= 0 && ih < g.Hi && iw >= 0 && iw < g.Wi;
        const float v = ok ? to_f(x[((b * g.Hi + ih) * g.Wi + iw) * g.ci + k]) : 0.f;
        if constexpr (TC) win[(size_t)px * l.sk + k] = from_f<__nv_bfloat16>(v);
        else win[(size_t)px * l.sk + k] = v;
      }
    }
    const int pad = l.cip - g.ci;
    for (int e = tid; e < nwin * pad; e += kThreads) {
      const int px = e / pad;
      if constexpr (TC) win[(size_t)px * l.sk + g.ci + e - px * pad] = from_f<__nv_bfloat16>(0.f);
      else win[(size_t)px * l.sk + g.ci + e - px * pad] = 0.f;
    }
  }

  // chunk j0 of the slice's filter columns into buffer i: hf*wf*cip rows of
  // lf, rows past Ci and columns past the chunk zero
  auto stage = [&](int i, int j0) {
    W* fb = filt(i);
    const int cc = min(g.cb, c_n - j0);
    const int ch0 = c_lo + j0;
    if (g.vec_f && cc % V == 0 && ch0 % V == 0 && (TC || std::is_same<T, float>::value)) {
      const int ncv = l.lf / V;
      const int jv = tid % ncv, rstep = kThreads / ncv;
      if (tid < rstep * ncv) {
        const bool colok = jv * V < cc;
        for (int t = 0; t < ntaps; ++t)
          for (int k = tid / ncv; k < l.cip; k += rstep) {
            const bool ok = colok && k < g.ci;
            cp16(fb + ((size_t)t * l.cip + k) * l.lf + jv * V,
                 ok ? f + ((long long)t * g.ci + k) * g.c + ch0 + jv * V : f, ok);
          }
      }
    } else {
      for (int e = tid; e < ntaps * l.cip * l.lf; e += kThreads) {
        const int row = e / l.lf, n = e - row * l.lf;
        const int t = row / l.cip, k = row - t * l.cip;
        const float v = k < g.ci && n < cc ? to_f(f[((long long)t * g.ci + k) * g.c + ch0 + n]) : 0.f;
        if constexpr (TC) fb[e] = from_f<__nv_bfloat16>(v);
        else fb[e] = v;
      }
    }
    cp_commit();
  };

  // ---- phase A: per chunk of the slice, conv -> bias -> act into the tile
  const int nchunk = (c_n + g.cb - 1) / g.cb;
  stage(0, 0);
  for (int ic = 0; ic < nchunk; ++ic) {
    const int j0 = ic * g.cb;
    const int cc = min(g.cb, c_n - j0);
    if (ic + 1 < nchunk) {
      stage(ic + 1, j0 + g.cb);
      cp_wait_one();
    } else {
      cp_wait_all();
    }
    __syncthreads();
    const T* bias = mbb != nullptr ? mbb + c_lo + j0 : nullptr;
    if constexpr (TC) {
      // columns n and n + 1, as one 32-bit pair of the hi and of the lo tile
      // where the chunk starts on an even column (sa is even); a column past
      // the chunk stores a zero, which lies in the tile's K padding or is
      // overwritten by the next chunk
      auto put = [&](int p, int n, float v0, float v1) {
        const bool second = n + 1 < cc;
        v0 = activate(v0 + (bias != nullptr ? to_f(bias[n]) : 0.f), g.act_mb);
        v1 = second ? activate(v1 + (bias != nullptr ? to_f(bias[n + 1]) : 0.f), g.act_mb) : 0.f;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v0 - __low2float(hi), v1 - __high2float(hi));
        const size_t o = (size_t)p * l.sa + j0 + n;
        if ((j0 & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dhi + o) = hi;
          *reinterpret_cast<__nv_bfloat162*>(dlo + o) = lo;
        } else {
          dhi[o] = hi.x;
          dlo[o] = lo.x;
          if (second) {
            dhi[o + 1] = hi.y;
            dlo[o + 1] = lo.y;
          }
        }
      };
      conv_tc(win, filt(ic), l.sk, l.lf, l.cip, g.hf, g.wf, wwin, s, tw, P, cc, put);
    } else {
      auto put = [&](int p, int n, float v) {
        dwt[(size_t)(j0 + n) * l.pm + p] = activate(v + (bias != nullptr ? to_f(bias[n]) : 0.f), g.act_mb);
      };
      if ((P + 7) / 8 * ((cc + 7) / 8) >= kThreads / 2)
        conv_simt<8, 8>(win, filt(ic), l.sk, l.lf, l.cip, g.hf, g.wf, wwin, s, tw, P, cc, put);
      else
        conv_simt<4, 4>(win, filt(ic), l.sk, l.lf, l.cip, g.hf, g.wf, wwin, s, tw, P, cc, put);
    }
    __syncthreads();
  }

  // ---- phase B: per Co panel, project the slice, sum over the cluster, store
  const Project pj{c_lo, c_n, g.co, g.np, P, tw, g.Wo, g.cluster, l.pm, l.sa, l.lw, g.act_pw, g.out_f32,
                   g.vec_w, ((b * g.Ho + oh0) * g.Wo + ow0) * g.co};
  project_store<T>(cluster, rank, pj, dwt, dhi, dlo, ws, wt, bsm, part, pw, pwb, res, out);
}

// The launch of B images: grid (cluster, tiles, batch), clusters of
// g.cluster CTAs along x, the layout's shared memory.
template <bool TC>
LaunchDims mb_dims(int B, const Geometry& g) {
  const long long tiles = (long long)((g.Ho + g.slab_h - 1) / g.slab_h) * ((g.Wo + g.tile_w - 1) / g.tile_w);
  return launch_dims(g.cluster, tiles, B, kThreads, g.cluster, mb_layout<TC>(g).total);
}

template <typename T>
int launch_t(const void* x, const void* f, const void* mbb, const void* pw, const void* pwb,
             const void* res, void* out, int B, Geometry g, cudaStream_t stream) {
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  constexpr int V = 16 / sizeof(T);
  static bool allowed = false;
  static long long placed_key = -1;
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  g.vec_x = g.ci % V == 0 && aligned(x);
  g.vec_f = g.c % V == 0 && aligned(f);
  g.vec_w = g.co % V == 0 && aligned(pw);
  const Layout l = mb_layout<TC>(g);
  const LaunchDims d = mb_dims<TC>(B, g);
  if (d.smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  if (d.grid[1] > 65535 || d.grid[2] > 65535) return (int)cudaErrorInvalidConfiguration;
  return launch_clustered(fused_mb_kernel<T>, d, stream, allowed, placed_key, static_cast<const T*>(x),
                          static_cast<const T*>(f), static_cast<const T*>(mbb), static_cast<const T*>(pw),
                          static_cast<const T*>(pwb), static_cast<const T*>(res), out, g, l);
}

bool valid(const Geometry& g, int B) {
  return B >= 1 && g.Hi >= 1 && g.Wi >= 1 && g.pad_t >= 0 && g.pad_l >= 0 && g.ci >= 1 && g.c >= 1 &&
         g.co >= 1 && g.Ho >= 1 && g.Wo >= 1 && g.hf >= 1 && g.wf >= 1 && g.stride >= 1 && g.slab_h >= 1 &&
         g.tile_w >= 1 &&
         g.cluster >= 1 && g.cluster <= kMaxCluster && g.cs >= 1 && (long long)g.cs * g.cluster >= g.c &&
         (long long)g.cs * (g.cluster - 1) < g.c && g.cb >= 1 && g.cb <= g.cs && g.cb <= 256 && g.np >= 8 &&
         g.np % 8 == 0 && g.np <= 256;
}

Geometry make_geometry(int Hi, int Wi, int pad_t, int pad_l, int ci, int c, int co, int Ho, int Wo, int hf,
                       int wf, int stride, int slab_h, int tile_w, int cb, int cs, int np, int cluster,
                       int act_mb, int act_pw, int out_f32) {
  return Geometry{Hi, Wi, pad_t, pad_l, ci, c, co, Ho, Wo, hf, wf, stride, slab_h, tile_w, cb, cs, np, cluster,
                  act_mb, act_pw, 0, 0, 0, out_f32};
}

}  // namespace

REPRO_EXPORT_ERROR_STRING(fused_mbconv)

// x (B, Hi, Wi, ci), read as zero-padded by pad_t rows above and pad_l
// columns left (and zeros past its far edges) to give an (Ho, Wo) VALID
// output; f (hf, wf, ci, c); mb_bias (c) or null; pw_w (c, co); pw_bias (co)
// or null; residual (B, Ho, Wo, co) or null: all at the stream type.  out
// (B, Ho, Wo, co) at the stream type, or fp32.  A cluster of `cluster` CTAs
// splits c into slices of cs channels, each computed cb at a time; slab_h
// output rows by tile_w columns a CTA; Co in panels of np.
extern "C" int fused_mbconv_launch(const void* x, const void* f, const void* mb_bias,
                                   const void* pw_w, const void* pw_bias, const void* residual,
                                   void* out, int B, int Hi, int Wi, int pad_t, int pad_l, int ci,
                                   int c, int co, int Ho, int Wo, int hf, int wf, int stride,
                                   int slab_h, int tile_w, int cb, int cs, int np, int cluster, int act_mb,
                                   int act_pw, int in_dtype, int out_dtype, void* stream) {
  using namespace repro;
  if (in_dtype != out_dtype && out_dtype != kF32) return (int)cudaErrorInvalidValue;
  const Geometry g = make_geometry(Hi, Wi, pad_t, pad_l, ci, c, co, Ho, Wo, hf, wf, stride, slab_h, tile_w, cb,
                                   cs, np, cluster, act_mb, act_pw, out_dtype == kF32);
  if (!valid(g, B)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == kF32)
    return launch_status(launch_t<float>(x, f, mb_bias, pw_w, pw_bias, residual, out, B, g, st));
  if (in_dtype == kBF16)
    return launch_status(launch_t<__nv_bfloat16>(x, f, mb_bias, pw_w, pw_bias, residual, out, B, g, st));
  if (in_dtype == kF16)
    return launch_status(launch_t<__half>(x, f, mb_bias, pw_w, pw_bias, residual, out, B, g, st));
  return (int)cudaErrorInvalidValue;
}

// The launch fused_mbconv_launch configures for this geometry over B
// images, as write_dims' ten numbers in out; cudaErrorInvalidValue for an
// unknown dtype.
extern "C" int fused_mbconv_launch_dims(int B, int ci, int cs, int cb, int np, int cluster, int slab_h,
                                        int tile_w, int Ho, int Wo, int hf, int wf, int stride, int in_dtype,
                                        long long* out) {
  const Geometry g = make_geometry(0, 0, 0, 0, ci, 0, 0, Ho, Wo, hf, wf, stride, slab_h, tile_w, cb, cs, np,
                                   cluster, 0, 0, 0);
  if (in_dtype == repro::kBF16) return repro::write_dims(mb_dims<true>(B, g), out);
  if (in_dtype == repro::kF32 || in_dtype == repro::kF16) return repro::write_dims(mb_dims<false>(B, g), out);
  return (int)cudaErrorInvalidValue;
}

// Shared memory one CTA of this geometry needs, in bytes (0 for an unknown
// dtype): lets the wrapper check the planner's model against the kernel.
extern "C" long long fused_mbconv_smem_bytes(int ci, int cs, int cb, int np, int slab_h, int tile_w, int hf,
                                             int wf, int stride, int in_dtype) {
  const Geometry g = make_geometry(0, 0, 0, 0, ci, 0, 0, 0, 0, hf, wf, stride, slab_h, tile_w, cb, cs, np, 1, 0, 0,
                                   0);
  if (in_dtype == repro::kBF16) return (long long)mb_layout<true>(g).total;
  if (in_dtype == repro::kF32 || in_dtype == repro::kF16) return (long long)mb_layout<false>(g).total;
  return 0;
}
