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
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace repro;

constexpr int kThreads = 256;

constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;

__host__ __device__ inline int up(int n, int m) { return (n + m - 1) / m * m; }

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

// C (M x N) = A (M x K) @ B (K x N) on the CUDA cores in fp32: A stored
// K-major (at[k * lda + m]), B row-major (b[k * ldb + n]), both with rows of
// 16-byte multiples covering M and N rounded up to the tile.  Each thread
// owns TM x TN micro-tiles in turn and reads each k's TM + TN operands as
// 16-byte vectors; store(m, n, v) takes the in-range results.
template <int TM, int TN, typename F>
__device__ __forceinline__ void gemm_simt(const float* __restrict__ at, int lda, const float* __restrict__ bm,
                                          int ldb, int M, int N, int K, F&& store) {
  const int tn = (N + TN - 1) / TN;
  const int tiles = (M + TM - 1) / TM * tn;
  for (int t = threadIdx.x; t < tiles; t += kThreads) {
    const int m0 = t / tn * TM, n0 = t % tn * TN;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    const float* a = at + m0;
    const float* b = bm + n0;
    // register double buffering: step k + 1's operands load while step
    // k's FMAs run
    float a0[TM], b0[TN], a1[TM], b1[TN];
    auto load = [&](int k, float (&av)[TM], float (&bv)[TN]) {
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(a + (size_t)k * lda + i);
        av[i] = v.x; av[i + 1] = v.y; av[i + 2] = v.z; av[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(b + (size_t)k * ldb + j);
        bv[j] = v.x; bv[j + 1] = v.y; bv[j + 2] = v.z; bv[j + 3] = v.w;
      }
    };
    auto fma_step = [&](const float (&av)[TM], const float (&bv)[TN]) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    };
    int k = 0;
    if (K > 0) load(0, a0, b0);
    for (; k + 1 < K; k += 2) {
      load(k + 1, a1, b1);
      fma_step(a0, b0);
      if (k + 2 < K) load(k + 2, a0, b0);
      fma_step(a1, b1);
    }
    if (k < K) fma_step(a0, b0);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (m0 + i < M && n0 + j < N) store(m0 + i, n0 + j, acc[i][j]);
  }
}

// 8x8 micro-tiles when there are enough of them to occupy half the CTA,
// else 4x4 (four times as many).
template <typename F>
__device__ __forceinline__ void gemm_simt_any(const float* at, int lda, const float* bm, int ldb, int M, int N,
                                              int K, F&& store) {
  if ((M + 7) / 8 * ((N + 7) / 8) >= kThreads / 2)
    gemm_simt<8, 8>(at, lda, bm, ldb, M, N, K, store);
  else
    gemm_simt<4, 4>(at, lda, bm, ldb, M, N, K, store);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// Two 16-bit elements of a K-major B operand, (k, n) and (k + 1, n), packed
// as the m16n8k16 fragment wants them.
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p, int ld) {
  const uint32_t lo = *reinterpret_cast<const unsigned short*>(p);
  const uint32_t hi = *reinterpret_cast<const unsigned short*>(p + ld);
  return lo | (hi << 16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory without a register round
// trip; zeros where !valid (src is then not read).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// C (M x N) = A (M x K) @ B (K x N) on the tensor cores: A row-major
// (a[m * lda + k]) and B row-major (bt[k * ldb + n], as the weights lie in
// device memory), bf16, K a multiple of 16 whose padding is zero in both.  With SPLIT, A is the pair
// (a, a_lo) and C = a @ B + a_lo @ B.  A warp owns a 16 x 32 block of C at a
// time (four m16n8k16 accumulators); store(m, n, v) takes in-range results.
template <bool SPLIT, typename F>
__device__ __forceinline__ void gemm_tc(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ a_lo,
                                        int lda, const __nv_bfloat16* __restrict__ bt, int ldb, int M, int N,
                                        int K, F&& store) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int nchunks = (N + 31) / 32;
  const int items = (M + 15) / 16 * nchunks;
  for (int it = warp; it < items; it += kWarps) {
    const int m0 = it / nchunks * 16, n0 = it % nchunks * 32;
    const int nb = min(4, (N - n0 + 7) / 8);
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t ah[4], al[4];
      const size_t ra = (size_t)(m0 + gq) * lda + k0 + 2 * tq;
      ah[0] = ld32(a + ra);
      ah[1] = ld32(a + ra + 8 * lda);
      ah[2] = ld32(a + ra + 8);
      ah[3] = ld32(a + ra + 8 * lda + 8);
      if (SPLIT) {
        al[0] = ld32(a_lo + ra);
        al[1] = ld32(a_lo + ra + 8 * lda);
        al[2] = ld32(a_lo + ra + 8);
        al[3] = ld32(a_lo + ra + 8 * lda + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < nb) {
          const __nv_bfloat16* pb = bt + (size_t)(k0 + 2 * tq) * ldb + n0 + j * 8 + gq;
          const uint32_t b0 = ld_pair(pb, ldb), b1 = ld_pair(pb + 8 * ldb, ldb);
          mma_bf16(acc[j], ah, b0, b1);
          if (SPLIT) mma_bf16(acc[j], al, b0, b1);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= nb) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + gq + 8 * h;
        const int n = n0 + j * 8 + 2 * tq;
        if (m >= M) continue;
        if (n < N) store(m, n, acc[j][2 * h]);
        if (n + 1 < N) store(m, n + 1, acc[j][2 * h + 1]);
      }
    }
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
  const int c16 = up(c_n, 16);
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
  for (int n0 = 0; n0 < g.co; n0 += g.np) {
    const int nv = min(g.np, g.co - n0);
    // the panel's project weights, K-major as they lie in device memory:
    // 16-byte asynchronous copies where Co allows them (a vector is then
    // whole or past Co, and zero-filled there); and the panel's bias
    const int npv = g.np / V;
    for (int j = tid; j < g.np; j += kThreads) bsm[j] = pwb != nullptr && j < nv ? to_f(pwb[n0 + j]) : 0.f;
    if constexpr (TC) {
      if (g.vec_w) {
        for (int e = tid; e < c16 * npv; e += kThreads) {
          const int k = e / npv, jn = e % npv * V;
          const bool ok = k < c_n && jn < nv;
          cp16(wt + (size_t)k * l.lw + jn, ok ? pw + (long long)(c_lo + k) * g.co + n0 + jn : pw, ok);
        }
        cp_wait_all();
      } else {
        for (int e = tid; e < c16 * g.np; e += kThreads) {
          const int k = e / g.np, jn = e % g.np;
          wt[(size_t)k * l.lw + jn] =
              k < c_n && jn < nv ? pw[(long long)(c_lo + k) * g.co + n0 + jn] : from_f<T>(0.f);
        }
      }
    } else if (std::is_same<T, float>::value && g.vec_w) {
      for (int e = tid; e < c_n * npv; e += kThreads) {
        const int k = e / npv, jn = e % npv * V;
        cp16(ws + (size_t)e * V, jn < nv ? pw + (long long)(c_lo + k) * g.co + n0 + jn : pw, jn < nv);
      }
      cp_wait_all();
    } else {
      for (int e = tid; e < c_n * g.np; e += kThreads) {
        const int k = e / g.np, jn = e % g.np;
        ws[e] = jn < nv ? to_f(pw[(long long)(c_lo + k) * g.co + n0 + jn]) : 0.f;
      }
    }
    __syncthreads();
    auto keep = [&](int p, int n, float v) { part[(size_t)p * g.np + n] = v; };
    if constexpr (TC) gemm_tc<true>(dhi, dlo, l.sa, wt, l.lw, P, nv, c16, keep);
    else gemm_simt_any(dwt, l.pm, ws, g.np, P, nv, c_n, keep);
    cluster.sync();
    // this rank's share of the tile's pixels: every rank's partial in rank
    // order, bias, activation, residual, one store.  A thread takes four
    // adjacent columns of a pixel (16-byte reads of the partials), several
    // pixels apart, so their loads are in flight together.
    const int nq4 = (nv + 3) / 4;
    const int pp = (P + g.cluster - 1) / g.cluster;
    const int p_lo = rank * pp, p_hi = min(P, p_lo + pp);
    const float* parts[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) parts[r] = r < g.cluster ? cluster.map_shared_rank(part, r) : part;
    const int n4 = tid % nq4 * 4;
    const int prow = kThreads / nq4;  // pixels taken together
    if (tid < prow * nq4) {
      for (int p = p_lo + tid / nq4; p < p_hi; p += prow) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r) {
          if (r >= g.cluster) break;
          const float4 q = *reinterpret_cast<const float4*>(parts[r] + (size_t)p * g.np + n4);
          v.x += q.x; v.y += q.y; v.z += q.z; v.w += q.w;
        }
        const long long o = ((b * g.Ho + oh0) * g.Wo + p) * g.co + n0 + n4;  // slabs span full rows
        const float y[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (n4 + u >= nv) break;
          float z = activate(y[u] + bsm[n4 + u], g.act_pw);
          if (res != nullptr) z += to_f(res[o + u]);
          if (g.out_f32) static_cast<float*>(out)[o + u] = z;
          else static_cast<T*>(out)[o + u] = from_f<T>(z);
        }
      }
    }
    // keep every CTA's partial tile alive until all ranks have read it (and
    // the panel's weights until every thread is done with them)
    cluster.sync();
  }
}

// Raises a kernel's dynamic shared-memory limit to the most a CTA may hold,
// once: every launch then fits it, whatever the order of their sizes.
template <typename K>
cudaError_t allow_smem(K kern, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess) done = true;
  return e;
}

template <typename T, bool EXPAND, int KT>
int launch_mode(const void* x, const void* ew, const void* f, const void* dwb, const void* pw,
                const void* pwb, const void* res, void* out, int B, const Geometry& g,
                cudaStream_t stream) {
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  static bool allowed = false;
  static long long placed_key = -1;
  const Layout l = sep_layout<TC>(g, EXPAND);
  if (l.total > (size_t)kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  auto kern = sep_fused_kernel<T, EXPAND, KT>;
  cudaError_t e = allow_smem(kern, allowed);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)g.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)g.cluster, (unsigned)((g.Ho + g.slab_h - 1) / g.slab_h), (unsigned)B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = l.total;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // refuse a cluster the card cannot place (checked once per shared-memory
  // size and cluster, which is all the answer depends on)
  const long long key = (long long)l.total * 16 + g.cluster;
  if (key != placed_key) {
    int active = 0;
    e = cudaOccupancyMaxActiveClusters(&active, kern, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (active < 1) return (int)cudaErrorLaunchOutOfResources;
    placed_key = key;
  }
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x), static_cast<const T*>(ew),
                         static_cast<const T*>(f), static_cast<const T*>(dwb), static_cast<const T*>(pw),
                         static_cast<const T*>(pwb), static_cast<const T*>(res), out, g, l);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
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
    return sep_launch<T>(x, expand_w, f, dw_bias, pw_w, pw_bias, residual, out, B, Hi, Wi, pad_t,   \
                         pad_l, ci, c, co, Ho, Wo, hf, wf, stride, slab_h, cb, cs, np, cluster,     \
                         act_exp, act_dw, act_pw, out_dtype == repro::kF32, stream);                \
  }
