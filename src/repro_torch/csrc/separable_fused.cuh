#pragma once

// Fused depthwise-separable block in one pass (the kernel; each of
// separable_fused{,_bf16,_f16}.cu compiles it for one stream type, so the
// three build in parallel), in two modes:
//   fused2: out = act_pw(DW(x) -> +dw_bias -> act_dw  @ pw_w + pw_bias) [+ residual]
//   fused3: the same after a bias-free PW-expand of the raw input
//           (x @ expand_w -> act_exp), computed on the fly.
// NHWC.  The kernel reads x as it lies and applies the zero padding itself
// (pad_t rows above, pad_l columns left; whatever lies past the input's far
// edges is zero too), so the wrapper's VALID geometry is pad 0.
//
// Replaces repro/kernels/separable_fused.py::separable_fused_pallas (body
// _fused_kernel), both its 2-stage mode and its 3-stage mode (expand_w).
//
// What bounds it on the H100: operations.  Only the input, the weights and
// the output reach device memory; per output pixel the block does C*Co
// multiply-adds of the project (+ Ci*C of the expand per input pixel, + C*k*k
// of the DW).  What the design does about it:
//   * each expand and DW value is computed once.  A CTA owns slab_h
//     full-width output rows of one image (the whole image at the 14x14 and
//     7x7 stages) and a slice of cs DW channels; a thread-block cluster of up
//     to 8 CTAs splits C, so every CTA expands, convolves and projects its own
//     channels for ALL of Co, and the cluster sums its partial output tiles
//     through distributed shared memory in rank order (no atomics: results
//     repeat bit for bit), each rank finishing a share of the tile with bias,
//     activation and residual.  Neighbouring slabs share only the window's
//     halo rows; the zero SAME padding is never expanded (the expand is
//     bias-free and every activation maps 0 to 0);
//   * the grid is (cluster, slabs, batch): blocking.py::plan_separable_fused
//     sizes the cluster and the slabs so a batch-8 launch puts >= 64 CTAs on
//     the card's 132 SMs, and prefers plans two of whose CTAs share an SM
//     (256 threads, at most 128 registers each);
//   * phase A loops over chunks of cb channels of the slice: [stage the
//     expand-weight chunk, expand the slab's raw window, which was loaded
//     once as 16-byte vectors] or load the chunk's window, then the DW (a warp
//     per channel; for 3x3 and 5x5 at strides 1 and 2 each lane computes runs
//     of four outputs of a row, reading each input of the run's window once,
//     taps in registers) into the CTA's DW tile, which stays resident;
//     phase B loops over Co panels: copy the panel's project weights as they
//     lie (cp.async, 16 bytes a thread), multiply, sum the cluster's
//     partials, and store with bias, activation and residual, four adjacent
//     output channels a thread;
//   * fp32 (and fp16): exact fp32 FMAs on the CUDA cores, both products
//     register-tiled (8x8 micro-tiles, 4x4 when a product has too few tiles
//     to occupy the CTA) from operands stored K-major in shared memory, read
//     as 16-byte vectors;
//   * bf16: both products on the tensor cores (mma.sync m16n8k16, fp32
//     accumulators).  The expand's operands are bf16 as given, so its
//     products are exact in fp32.  The project's A operand is the fp32 DW
//     tile: it is NOT rounded to bf16 once; each value a is stored as
//     hi = bf16(a) and lo = bf16(a - hi) and the project runs two MMAs,
//     hi @ w + lo @ w, which keeps a to about 2^-16 of its magnitude
//     (against bf16's 2^-9), so the output still rounds once, at its store.
// The expanded window and the DW tile are fp32 in shared memory, as the
// reference keeps them.
#include "tile_gemm.cuh"

namespace {

using namespace repro;

struct Geometry {
  int Hi, Wi, pad_t, pad_l, ci, c, co, Ho, Wo, hf, wf, stride, slab_h, cb, cs, np, cluster;
  int act_exp, act_dw, act_pw, vec_x, vec_e, vec_w, out_f32;
};

// Shared-memory layout of one CTA; repro_torch/kernels/blocking.py
// ::separable_smem_bytes models the same regions.  The DW tile (dw, and
// dw_lo for bf16) stays resident; phase A (xe, xr, e) and phase B (w, part)
// share the rest.  pm: pixel rows of the DW tile; rpm: raw-window rows;
// ecs: expand-weight chunk row (fp32); sk, sa: 16-bit K rows of the raw
// window / expand weights and of the DW tile / project weights.
struct Layout {
  size_t dw, dw_lo, wm, xe, tp, tb, xr, e, w, bs, part, total;
  int pm, rpm, ecs, sk, sa, le, lw;
};

template <bool TC>
Layout sep_layout(const Geometry& g, bool expand) {
  const int p = g.slab_h * g.Wo;
  const int hwin = (g.slab_h - 1) * g.stride + g.hf;
  const int wwin = (g.Wo - 1) * g.stride + g.wf;
  const int rp = (hwin < g.Hi ? hwin : g.Hi) * (wwin < g.Wi ? wwin : g.Wi);
  Layout l{};
  size_t off = 0;
  l.sk = up(g.ci, 16) + 8;
  l.sa = up(g.cs, 16) + 8;
  l.ecs = up(g.cb, 8);
  l.le = l.ecs + 8;  // 16-bit expand-weight rows [ci][le] and project-weight
  l.lw = g.np + 8;   // rows [cs][lw]: 16 bytes past a multiple of 128
  if (TC) {
    l.pm = up(p, 16);
    l.rpm = up(rp, 16);
    l.dw = off; off += align16((size_t)l.pm * l.sa * 2);
    l.dw_lo = off; off += align16((size_t)l.pm * l.sa * 2);
  } else {
    l.pm = up(p, 8);
    l.rpm = up(rp, 8);
    l.dw = off; off += align16((size_t)g.cs * l.pm * 4);
  }
  l.wm = off; off += align16((size_t)rp * 4);
  const size_t base = off;
  l.xe = off; off += align16((size_t)g.cb * hwin * wwin * 4);
  l.tp = off; off += align16((size_t)g.hf * g.wf * l.ecs * 4);
  l.tb = off; off += align16((size_t)l.ecs * 4);
  if (expand) {
    l.xr = off; off += TC ? align16((size_t)l.rpm * l.sk * 2) : align16((size_t)g.ci * l.rpm * 4);
    l.e = off; off += TC ? align16((size_t)up(g.ci, 16) * l.le * 2) : align16((size_t)g.ci * l.ecs * 4);
  }
  const size_t end_a = off;
  off = base;
  l.w = off; off += TC ? align16((size_t)up(g.cs, 16) * l.lw * 2) : align16((size_t)g.cs * g.np * 4);
  l.bs = off; off += align16((size_t)g.np * 4);
  l.part = off; off += align16((size_t)l.pm * g.np * 4);
  l.total = end_a > off ? end_a : off;
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

// DW outputs a lane computes together along a row.
constexpr int kRun = 4;

// kRun adjacent outputs of a KT x KT, stride-S depthwise filter from a
// channel's window sp (rows wwin apart): each tap row's (kRun - 1) * S + KT
// inputs are read once, and each output sums its taps row by row, column
// by column, as a lone output would.  Inputs past the window's right edge
// feed only outputs past it, which the caller drops.
template <int KT, int S>
__device__ __forceinline__ void dw_run(const float* sp, int wwin, const float (&taps)[KT * KT], float (&acc)[kRun]) {
  constexpr int kIn = (kRun - 1) * S + KT;
#pragma unroll
  for (int u = 0; u < kRun; ++u) acc[u] = 0.f;
#pragma unroll
  for (int n = 0; n < KT; ++n) {
    float in[kIn];
#pragma unroll
    for (int m = 0; m < kIn; ++m) in[m] = sp[n * wwin + m];
#pragma unroll
    for (int u = 0; u < kRun; ++u)
#pragma unroll
      for (int m = 0; m < KT; ++m) acc[u] = fmaf(in[u * S + m], taps[n * KT + m], acc[u]);
  }
}

// Grid (cluster, slabs, batch), clusters along x: rank r owns DW channels
// [r * cs, min(C, (r + 1) * cs)) of output rows [y * slab_h, ...) of image z.
template <typename T, bool EXPAND, int KT>
__global__ void __launch_bounds__(kThreads, 2) sep_fused_kernel(
    const T* __restrict__ x, const T* __restrict__ ew, const T* __restrict__ f,
    const T* __restrict__ dwb, const T* __restrict__ pw, const T* __restrict__ pwb,
    const T* __restrict__ res, void* __restrict__ out, Geometry g, Layout l) {
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  constexpr int V = 16 / sizeof(T);  // elements of a 16-byte vector
  extern __shared__ __align__(16) unsigned char smem[];
  float* dwt = reinterpret_cast<float*>(smem + l.dw);                     // [cs][pm]   (fp32)
  __nv_bfloat16* dhi = reinterpret_cast<__nv_bfloat16*>(smem + l.dw);     // [pm][sa]   (bf16)
  __nv_bfloat16* dlo = reinterpret_cast<__nv_bfloat16*>(smem + l.dw_lo);  // [pm][sa]   (bf16)
  int* wmap = reinterpret_cast<int*>(smem + l.wm);                        // [real pixels]
  float* xe = reinterpret_cast<float*>(smem + l.xe);                      // [cb][window]
  float* tp = reinterpret_cast<float*>(smem + l.tp);                      // [hf*wf][ecs]
  float* tb = reinterpret_cast<float*>(smem + l.tb);                      // [ecs]
  float* xt = reinterpret_cast<float*>(smem + l.xr);                      // [ci][rpm]  (fp32)
  __nv_bfloat16* xr = reinterpret_cast<__nv_bfloat16*>(smem + l.xr);      // [rpm][sk]  (bf16)
  float* es = reinterpret_cast<float*>(smem + l.e);                       // [ci][ecs]  (fp32)
  __nv_bfloat16* et = reinterpret_cast<__nv_bfloat16*>(smem + l.e);       // [k16][le]  (bf16)
  float* ws = reinterpret_cast<float*>(smem + l.w);                       // [cs][np]   (fp32)
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem + l.w);       // [c16][lw]  (bf16)
  float* bsm = reinterpret_cast<float*>(smem + l.bs);                     // [np]
  float* part = reinterpret_cast<float*>(smem + l.part);                  // [pm][np]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int s = g.stride;
  const int c_lo = rank * g.cs;
  const int c_n = min(g.cs, g.c - c_lo);
  const int oh0 = blockIdx.y * g.slab_h;
  const int P = min(g.slab_h, g.Ho - oh0) * g.Wo;
  const long long b = blockIdx.z;
  const int hwin = (min(g.slab_h, g.Ho - oh0) - 1) * s + g.hf;
  const int wwin = (g.Wo - 1) * s + g.wf;
  const int nwin = hwin * wwin;
  // the window's real pixels: rows [r_lo, r_hi), columns [q_lo, q_hi)
  const int ih0 = oh0 * s - g.pad_t;
  const int r_lo = max(0, -ih0), r_hi = min(hwin, g.Hi - ih0);
  const int q_lo = max(0, g.pad_l), q_hi = min(wwin, g.Wi + g.pad_l);
  const int nq = max(0, q_hi - q_lo);
  const int rp = max(0, r_hi - r_lo) * nq;
  const int cin = EXPAND ? g.ci : g.c;
  const int k16 = up(g.ci, 16);
  auto in_at = [&](int p) -> long long {  // x offset of real window pixel p, channel 0
    const int ih = ih0 + r_lo + p / nq, iw = q_lo + p % nq - g.pad_l;
    return ((b * g.Hi + ih) * g.Wi + iw) * cin;
  };
  // window index of each real pixel, once, so no store divides
  for (int p = tid; p < rp; p += kThreads) wmap[p] = (r_lo + p / nq) * wwin + q_lo + p % nq;

  // the padding of the window stays zero through every chunk; the 16-bit DW
  // tile's K padding stays zero for the project
  for (int i = tid; i < g.cb * nwin; i += kThreads) xe[i] = 0.f;
  if (TC) {
    uint4* z = reinterpret_cast<uint4*>(dhi);
    const int n16 = (int)((size_t)2 * l.pm * l.sa * 2 / 16);
    for (int i = tid; i < n16; i += kThreads) z[i] = make_uint4(0, 0, 0, 0);
  }
  if (EXPAND) {
    // the raw window's real pixels, once per CTA
    if (g.vec_x) {
      const int civ = g.ci / V;
      if constexpr (TC) {
        for (int e = tid; e < rp * civ; e += kThreads)
          cp16(xr + (size_t)(e / civ) * l.sk + e % civ * V, x + in_at(e / civ) + e % civ * V, true);
        cp_wait_all();
      } else {
        for (int e = tid; e < rp * civ; e += kThreads) {
          const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x + in_at(e / civ)) + e % civ);
          const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int u = 0; u < V; ++u) xt[(size_t)(e % civ * V + u) * l.rpm + e / civ] = to_f(v[u]);
        }
      }
    } else {
      for (int e = tid; e < rp * g.ci; e += kThreads) {
        const int p = e / g.ci, k = e % g.ci;
        const T v = x[in_at(p) + k];
        if constexpr (TC) xr[(size_t)p * l.sk + k] = v;
        else xt[(size_t)k * l.rpm + p] = to_f(v);
      }
    }
    if constexpr (TC)
      for (int e = tid; e < rp * (k16 - g.ci); e += kThreads)
        xr[(size_t)(e / (k16 - g.ci)) * l.sk + g.ci + e % (k16 - g.ci)] = from_f<T>(0.f);
  }

  __syncthreads();

  // ---- phase A: per chunk of the slice, [expand ->] DW into the DW tile
  for (int j0 = 0; j0 < c_n; j0 += g.cb) {
    const int cc = min(g.cb, c_n - j0);
    const int ch0 = c_lo + j0;
    // the chunk's DW taps and bias
    for (int e = tid; e < g.hf * g.wf * cc; e += kThreads)
      tp[(size_t)(e / cc) * l.ecs + e % cc] = to_f(f[(long long)(e / cc) * g.c + ch0 + e % cc]);
    for (int j = tid; j < cc; j += kThreads) tb[j] = dwb != nullptr ? to_f(dwb[ch0 + j]) : 0.f;
    if (EXPAND) {
      // the chunk's expand weights, as 16-byte vectors along C where they
      // allow it
      const bool ve = g.vec_e && ch0 % V == 0 && cc % V == 0;
      const int ccv = cc / V;
      if constexpr (TC) {
        // K-major [k16][le], rows past ci zero
        if (ve) {
          for (int e = tid; e < k16 * ccv; e += kThreads) {
            const int k = e / ccv, jv = e % ccv;
            cp16(et + (size_t)k * l.le + jv * V, ew + (long long)min(k, g.ci - 1) * g.c + ch0 + jv * V, k < g.ci);
          }
          cp_wait_all();
        } else {
          for (int e = tid; e < k16 * cc; e += kThreads) {
            const int k = e / cc, j = e % cc;
            et[(size_t)k * l.le + j] = k < g.ci ? ew[(long long)k * g.c + ch0 + j] : from_f<T>(0.f);
          }
        }
      } else if (std::is_same<T, float>::value && ve) {
        for (int e = tid; e < g.ci * ccv; e += kThreads)
          cp16(es + (size_t)(e / ccv) * l.ecs + e % ccv * V, ew + (long long)(e / ccv) * g.c + ch0 + e % ccv * V, true);
        cp_wait_all();
      } else {
        if (ve) {
          for (int e = tid; e < g.ci * ccv; e += kThreads) {
            const uint4 raw = __ldg(reinterpret_cast<const uint4*>(ew + (long long)(e / ccv) * g.c + ch0) + e % ccv);
            const T* v = reinterpret_cast<const T*>(&raw);
            float* dst = es + (size_t)(e / ccv) * l.ecs + e % ccv * V;
#pragma unroll
            for (int u = 0; u < V; u += 4)
              *reinterpret_cast<float4*>(dst + u) = make_float4(to_f(v[u]), to_f(v[u + 1]), to_f(v[u + 2]), to_f(v[u + 3]));
          }
        } else {
          for (int e = tid; e < g.ci * cc; e += kThreads) {
            const int k = e / cc, j = e % cc;
            es[(size_t)k * l.ecs + j] = to_f(ew[(long long)k * g.c + ch0 + j]);
          }
        }
      }
      __syncthreads();
      auto put = [&](int p, int j, float v) { xe[(size_t)j * nwin + wmap[p]] = activate(v, g.act_exp); };
      if constexpr (TC) gemm_tc<false>(xr, xr, l.sk, et, l.le, rp, cc, k16, put);
      else gemm_simt_any(xt, l.rpm, es, l.ecs, rp, cc, g.ci, put);
    } else {
      if (g.vec_x && ch0 % V == 0 && cc % V == 0) {
        const int ccv = cc / V;
        for (int e = tid; e < rp * ccv; e += kThreads) {
          const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x + in_at(e / ccv) + ch0) + e % ccv);
          const int jv = e % ccv, wp = wmap[e / ccv];
          const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int u = 0; u < V; ++u) xe[(size_t)(jv * V + u) * nwin + wp] = to_f(v[u]);
        }
      } else {
        for (int e = tid; e < rp * cc; e += kThreads)
          xe[(size_t)(e % cc) * nwin + wmap[e / cc]] = to_f(x[in_at(e / cc) + ch0 + e % cc]);
      }
    }
    __syncthreads();

    // DW: a warp per channel, lanes along runs of kRun outputs of a row
    // (3x3 and 5x5: each input of a run's window read once into registers)
    // or along the pixels (other filters)
    for (int jj = warp; jj < cc; jj += kWarps) {
      const float bias = tb[jj];
      const float* src = xe + (size_t)jj * nwin;
      auto put_dw = [&](int p, float sum) {
        const float v = activate(sum + bias, g.act_dw);
        if (TC) {
          const __nv_bfloat16 hi = __float2bfloat16_rn(v);
          dhi[(size_t)p * l.sa + j0 + jj] = hi;
          dlo[(size_t)p * l.sa + j0 + jj] = __float2bfloat16_rn(v - __bfloat162float(hi));
        } else {
          dwt[(size_t)(j0 + jj) * l.pm + p] = v;
        }
      };
      auto per_pixel = [&]() {
        for (PixelWalk w(lane, g.Wo); w.p < P; w.advance(32, g.Wo)) {
          const float* sp = src + w.r * s * wwin + w.q * s;
          float sum = 0.f;
          for (int n = 0; n < g.hf; ++n)
            for (int m = 0; m < g.wf; ++m) sum = fmaf(sp[n * wwin + m], tp[(n * g.wf + m) * l.ecs + jj], sum);
          put_dw(w.p, sum);
        }
      };
      if constexpr (KT > 0) {
        if (s <= 2) {
          float taps[KT * KT];
#pragma unroll
          for (int t = 0; t < KT * KT; ++t) taps[t] = tp[t * l.ecs + jj];
          const int rpr = (g.Wo + kRun - 1) / kRun;
          const int runs = P / g.Wo * rpr;
          for (int ri = lane; ri < runs; ri += 32) {
            const int row = ri / rpr, q0 = ri % rpr * kRun;
            float acc[kRun];
            const float* sp = src + row * s * wwin + q0 * s;
            if (s == 1) dw_run<KT, 1>(sp, wwin, taps, acc);
            else dw_run<KT, 2>(sp, wwin, taps, acc);
#pragma unroll
            for (int u = 0; u < kRun; ++u)
              if (q0 + u < g.Wo) put_dw(row * g.Wo + q0 + u, acc[u]);
          }
        } else {
          per_pixel();
        }
      } else {
        per_pixel();
      }
    }
    __syncthreads();
  }

  // ---- phase B: per Co panel, project the slice, sum over the cluster, store
  const Project pj{c_lo, c_n, g.co, g.np, P, g.Wo, g.Wo, g.cluster, l.pm, l.sa, l.lw, g.act_pw, g.out_f32,
                   g.vec_w, ((b * g.Ho + oh0) * g.Wo) * g.co};  // slabs span full rows
  project_store<T>(cluster, rank, pj, dwt, dhi, dlo, ws, wt, bsm, part, pw, pwb, res, out);
}

// The launch of B images: grid (cluster, slabs, batch), clusters of
// g.cluster CTAs along x, the layout's shared memory.
template <bool TC>
LaunchDims sep_dims(int B, const Geometry& g, bool expand) {
  return launch_dims(g.cluster, (g.Ho + g.slab_h - 1) / g.slab_h, B, kThreads, g.cluster,
                     sep_layout<TC>(g, expand).total);
}

template <typename T, bool EXPAND, int KT>
int launch_mode(const void* x, const void* ew, const void* f, const void* dwb, const void* pw,
                const void* pwb, const void* res, void* out, int B, const Geometry& g,
                cudaStream_t stream) {
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  static bool allowed = false;
  static long long placed_key = -1;
  const Layout l = sep_layout<TC>(g, EXPAND);
  const LaunchDims d = sep_dims<TC>(B, g, EXPAND);
  if (d.smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  return launch_clustered(sep_fused_kernel<T, EXPAND, KT>, d, stream, allowed, placed_key,
                          static_cast<const T*>(x),
                          static_cast<const T*>(ew), static_cast<const T*>(f), static_cast<const T*>(dwb),
                          static_cast<const T*>(pw), static_cast<const T*>(pwb), static_cast<const T*>(res),
                          out, g, l);
}

template <typename T>
int launch_t(const void* x, const void* ew, const void* f, const void* dwb, const void* pw,
             const void* pwb, const void* res, void* out, int B, Geometry g, cudaStream_t stream) {
  const int kt = g.hf == g.wf && (g.hf == 3 || g.hf == 5) ? g.hf : 0;
  constexpr int V = 16 / sizeof(T);
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  g.vec_x = (ew != nullptr ? g.ci : g.c) % V == 0 && aligned(x);
  g.vec_e = g.c % V == 0 && aligned(ew);
  g.vec_w = g.co % V == 0 && aligned(pw);
#define REPRO_FUSED_CASE(E, KT)                                                          \
  if ((ew != nullptr) == E && kt == KT)                                                \
    return launch_mode<T, E, KT>(x, ew, f, dwb, pw, pwb, res, out, B, g, stream);
  REPRO_FUSED_CASE(true, 3)
  REPRO_FUSED_CASE(true, 5)
  REPRO_FUSED_CASE(true, 0)
  REPRO_FUSED_CASE(false, 3)
  REPRO_FUSED_CASE(false, 5)
  REPRO_FUSED_CASE(false, 0)
#undef REPRO_FUSED_CASE
  return (int)cudaErrorInvalidValue;
}

bool valid(const Geometry& g, int B, bool expand) {
  return B >= 1 && g.Hi >= 1 && g.Wi >= 1 && g.pad_t >= 0 && g.pad_l >= 0 && g.c >= 1 &&
         g.co >= 1 && (!expand || g.ci >= 1) && g.Ho >= 1 && g.Wo >= 1 && g.hf >= 1 && g.wf >= 1 &&
         g.stride >= 1 && g.slab_h >= 1 && g.cluster >= 1 && g.cluster <= kMaxCluster &&
         g.cs >= 1 && (long long)g.cs * g.cluster >= g.c && (long long)g.cs * (g.cluster - 1) < g.c &&
         g.cb >= 1 && g.cb <= g.cs && g.np >= 8 && g.np % 8 == 0;
}

// Geometry from the C entry's arguments; a launch of stream type T
// storing at T, or at fp32 when out_f32.
template <typename T>
int sep_launch(const void* x, const void* expand_w, const void* f, const void* dw_bias, const void* pw_w,
               const void* pw_bias, const void* residual, void* out, int B, int Hi, int Wi, int pad_t,
               int pad_l, int ci, int c, int co, int Ho, int Wo, int hf, int wf, int stride, int slab_h,
               int cb, int cs, int np, int cluster, int act_exp, int act_dw, int act_pw, int out_f32,
               void* stream) {
  const Geometry g{Hi, Wi, pad_t, pad_l, ci, c, co, Ho, Wo, hf, wf, stride, slab_h, cb, cs, np, cluster,
                   act_exp, act_dw, act_pw, 0, 0, 0, out_f32};
  if (!valid(g, B, expand_w != nullptr)) return (int)cudaErrorInvalidValue;
  return launch_t<T>(x, expand_w, f, dw_bias, pw_w, pw_bias, residual, out, B, g,
                     static_cast<cudaStream_t>(stream));
}

}  // namespace

// Defines <prefix>_error_string and the C entry <prefix>_launch for stream
// type T (dtype code CODE), storing at T or at fp32:
// x (B, Hi, Wi, ci if expand_w else c), read as zero-padded by pad_t rows
// above and pad_l columns left (and zeros past its far edges) to give an
// (Ho, Wo) VALID output; expand_w (ci, c) or null; f (hf, wf, c); dw_bias
// (c) or null; pw_w (c, co); pw_bias (co) or null; residual (B, Ho, Wo, co)
// or null: all at the stream type.  out (B, Ho, Wo, co) at the store type.
// A cluster of `cluster` CTAs splits c into slices of cs channels, each
// staged cb at a time; slab_h output rows a CTA; Co in panels of np.
#define REPRO_SEPARABLE_FUSED_EXPORT(prefix, T, CODE)                                               \
  REPRO_EXPORT_ERROR_STRING(prefix)                                                                 \
  extern "C" int prefix##_launch(                                                                   \
      const void* x, const void* expand_w, const void* f, const void* dw_bias, const void* pw_w,     \
      const void* pw_bias, const void* residual, void* out, int B, int Hi, int Wi, int pad_t,        \
      int pad_l, int ci, int c, int co, int Ho, int Wo, int hf, int wf, int stride, int slab_h,      \
      int cb, int cs, int np, int cluster, int act_exp, int act_dw, int act_pw, int in_dtype,        \
      int out_dtype, void* stream) {                                                                \
    if (in_dtype != (CODE) || (out_dtype != (CODE) && out_dtype != repro::kF32))                    \
      return (int)cudaErrorInvalidValue;                                                            \
    return repro::launch_status(sep_launch<T>(                                                      \
        x, expand_w, f, dw_bias, pw_w, pw_bias, residual, out, B, Hi, Wi, pad_t, pad_l, ci, c, co,  \
        Ho, Wo, hf, wf, stride, slab_h, cb, cs, np, cluster, act_exp, act_dw, act_pw,               \
        out_dtype == repro::kF32, stream));                                                         \
  }
