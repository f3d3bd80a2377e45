#pragma once

// Tile products shared by the fused kernels (separable_fused.cuh,
// fused_mbconv.cu): register-tiled fp32 GEMMs on the CUDA cores, bf16 GEMMs
// on the tensor cores (mma.sync m16n8k16, fragments loaded with ldmatrix),
// cp.async copies (dwconv2d.cu uses these too), the project phase that
// multiplies a CTA's resident tile of C channels by the project weights and
// sums a thread-block cluster's partial outputs in rank order, and the
// launch of a clustered grid.  The fused kernels' CTAs have kThreads
// threads.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace repro {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;

__host__ __device__ inline int up(int n, int m) { return (n + m - 1) / m * m; }

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

// Four 8x8 16-bit matrices from shared memory, one register each: thread
// t names row t % 8 of matrix t / 8 (16 bytes, 16-byte aligned) and gets
// elements (t / 4, 2 (t % 4) .. + 1) of each, or with TRANS their transpose,
// (2 (t % 4) .. + 1, t / 4): the m16n8k16 fragments of a row-major A, and
// of a B stored row-major (k, n) as device memory holds the weights.
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(row)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(row)));
}

// C (M x N) = A (M x K) @ B (K x N) on the tensor cores: A row-major
// (a[m * lda + k]) and B row-major (bt[k * ldb + n], as the weights lie in
// device memory), bf16, K a multiple of 16 whose padding is zero in both;
// lda and ldb multiples of 8 (16-byte rows for ldmatrix), A holding rows up
// to M rounded up to 16 and B columns up to N rounded up to 8, plus 8.
// With SPLIT, A is the pair (a, a_lo) and C = a @ B + a_lo @ B.  A warp owns
// a 16 x 32 block of C at a time (four m16n8k16 accumulators), its
// fragments loaded with ldmatrix; store(m, n, v) takes in-range results.
template <bool SPLIT, typename F>
__device__ __forceinline__ void gemm_tc(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ a_lo,
                                        int lda, const __nv_bfloat16* __restrict__ bt, int ldb, int M, int N,
                                        int K, F&& store) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int nchunks = (N + 31) / 32;
  const int items = (M + 15) / 16 * nchunks;
  // this lane's ldmatrix rows: A row m0 + r (k + c), B row k + r (n + c)
  const int r = lane % 8 + 8 * (lane / 8 % 2), c = 8 * (lane / 16);
  for (int it = warp; it < items; it += kWarps) {
    const int m0 = it / nchunks * 16, n0 = it % nchunks * 32;
    const int nb = min(4, (N - n0 + 7) / 8);
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    const size_t ra = (size_t)(m0 + r) * lda + c;
    const __nv_bfloat16* pb = bt + (size_t)r * ldb + n0 + c;
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t ah[4], al[4], b01[4], b23[4];
      ldsm_x4<false>(ah, a + ra + k0);
      if (SPLIT) ldsm_x4<false>(al, a_lo + ra + k0);
      ldsm_x4<true>(b01, pb + (size_t)k0 * ldb);
      if (nb > 2) ldsm_x4<true>(b23, pb + (size_t)k0 * ldb + 16);
      mma_bf16(acc[0], ah, b01[0], b01[1]);
      mma_bf16(acc[1], ah, b01[2], b01[3]);
      if (nb > 2) {
        mma_bf16(acc[2], ah, b23[0], b23[1]);
        mma_bf16(acc[3], ah, b23[2], b23[3]);
      }
      if (SPLIT) {
        mma_bf16(acc[0], al, b01[0], b01[1]);
        mma_bf16(acc[1], al, b01[2], b01[3]);
        if (nb > 2) {
          mma_bf16(acc[2], al, b23[0], b23[1]);
          mma_bf16(acc[3], al, b23[2], b23[3]);
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

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Waits until at most one committed group of this thread's copies is in
// flight.
__device__ __forceinline__ void cp_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// The project phase of a CTA that holds the fused intermediate of its C
// slice [c_lo, c_lo + c_n) for P output pixels, a tile tw pixels wide of
// an output Wo wide (pixel p is output pixel out0 / co + (p / tw) * Wo +
// p % tw; a full-width tile, tw = Wo, is rows of pixels): for each Co panel
// of np columns,
// stage the panel's project weights (rows c_lo.. of pw, as they lie) and
// bias, multiply the slice's tile by them, sum the cluster's partial tiles
// through distributed shared memory in rank order (no atomics: results
// repeat bit for bit), each rank finishing a share of the pixels with bias,
// activation and residual, four adjacent output channels a thread.
// fp32: the tile is dwt [c_n][pm] (K-major); bf16: the pair dhi, dlo
// [pm][sa] (hi + lo, two MMAs).
struct Project {
  int c_lo, c_n, co, np, P, tw, Wo, cluster, pm, sa, lw, act_pw, out_f32, vec_w;
  long long out0;
};

template <typename T>
__device__ __forceinline__ void project_store(cg::cluster_group& cluster, int rank, const Project& pj,
                                              const float* dwt, const __nv_bfloat16* dhi,
                                              const __nv_bfloat16* dlo, float* ws, __nv_bfloat16* wt,
                                              float* bsm, float* part, const T* __restrict__ pw,
                                              const T* __restrict__ pwb, const T* __restrict__ res,
                                              void* __restrict__ out) {
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const int c16 = up(pj.c_n, 16);
  const int P = pj.P;
  for (int n0 = 0; n0 < pj.co; n0 += pj.np) {
    const int nv = min(pj.np, pj.co - n0);
    // the panel's project weights, K-major as they lie in device memory:
    // 16-byte asynchronous copies where Co allows them (a vector is then
    // whole or past Co, and zero-filled there); and the panel's bias
    const int npv = pj.np / V;
    for (int j = tid; j < pj.np; j += kThreads) bsm[j] = pwb != nullptr && j < nv ? to_f(pwb[n0 + j]) : 0.f;
    if constexpr (TC) {
      if (pj.vec_w) {
        for (int e = tid; e < c16 * npv; e += kThreads) {
          const int k = e / npv, jn = e % npv * V;
          const bool ok = k < pj.c_n && jn < nv;
          cp16(wt + (size_t)k * pj.lw + jn, ok ? pw + (long long)(pj.c_lo + k) * pj.co + n0 + jn : pw, ok);
        }
        cp_wait_all();
      } else {
        for (int e = tid; e < c16 * pj.np; e += kThreads) {
          const int k = e / pj.np, jn = e % pj.np;
          wt[(size_t)k * pj.lw + jn] =
              k < pj.c_n && jn < nv ? pw[(long long)(pj.c_lo + k) * pj.co + n0 + jn] : from_f<T>(0.f);
        }
      }
    } else if (std::is_same<T, float>::value && pj.vec_w) {
      for (int e = tid; e < pj.c_n * npv; e += kThreads) {
        const int k = e / npv, jn = e % npv * V;
        cp16(ws + (size_t)e * V, jn < nv ? pw + (long long)(pj.c_lo + k) * pj.co + n0 + jn : pw, jn < nv);
      }
      cp_wait_all();
    } else {
      for (int e = tid; e < pj.c_n * pj.np; e += kThreads) {
        const int k = e / pj.np, jn = e % pj.np;
        ws[e] = jn < nv ? to_f(pw[(long long)(pj.c_lo + k) * pj.co + n0 + jn]) : 0.f;
      }
    }
    __syncthreads();
    auto keep = [&](int p, int n, float v) { part[(size_t)p * pj.np + n] = v; };
    if constexpr (TC) gemm_tc<true>(dhi, dlo, pj.sa, wt, pj.lw, P, nv, c16, keep);
    else gemm_simt_any(dwt, pj.pm, ws, pj.np, P, nv, pj.c_n, keep);
    cluster.sync();
    // this rank's share of the tile's pixels: every rank's partial in rank
    // order, bias, activation, residual, one store.  A thread takes four
    // adjacent columns of a pixel (16-byte reads of the partials), several
    // pixels apart, so their loads are in flight together.
    const int nq4 = (nv + 3) / 4;
    const int pp = (P + pj.cluster - 1) / pj.cluster;
    const int p_lo = rank * pp, p_hi = min(P, p_lo + pp);
    const float* parts[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) parts[r] = r < pj.cluster ? cluster.map_shared_rank(part, r) : part;
    const int n4 = tid % nq4 * 4;
    const int prow = kThreads / nq4;  // pixels taken together
    if (tid < prow * nq4) {
      for (int p = p_lo + tid / nq4; p < p_hi; p += prow) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r) {
          if (r >= pj.cluster) break;
          const float4 q = *reinterpret_cast<const float4*>(parts[r] + (size_t)p * pj.np + n4);
          v.x += q.x; v.y += q.y; v.z += q.z; v.w += q.w;
        }
        const long long o = pj.out0 + ((long long)(p / pj.tw) * pj.Wo + p % pj.tw) * pj.co + n0 + n4;
        const float y[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (n4 + u >= nv) break;
          float z = activate(y[u] + bsm[n4 + u], pj.act_pw);
          if (res != nullptr) z += to_f(res[o + u]);
          if (pj.out_f32) static_cast<float*>(out)[o + u] = z;
          else static_cast<T*>(out)[o + u] = from_f<T>(z);
        }
      }
    }
    // keep every CTA's partial tile alive until all ranks have read it (and
    // the panel's weights until every thread is done with them)
    cluster.sync();
  }
}

// Launches kern at d, whose grid's x dimension is d.cluster CTAs of one
// thread-block cluster, after raising its dynamic shared-memory limit to
// the most a CTA may hold and allowing clusters above the portable 8 (once)
// and checking that the card can place such a cluster (once per
// shared-memory size and cluster).
template <typename K, typename... Args>
int launch_clustered(K kern, const LaunchDims& d, cudaStream_t stream, bool& allowed, long long& placed_key,
                     Args... args) {
  cudaError_t e;
  if (!allowed) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)d.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = d.grid_dim();
  cfg.blockDim = d.block_dim();
  cfg.dynamicSmemBytes = d.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const long long key = (long long)d.smem * 32 + d.cluster;
  if (key != placed_key) {
    int active = 0;
    e = cudaOccupancyMaxActiveClusters(&active, kern, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (active < 1) return (int)cudaErrorLaunchOutOfResources;
    placed_key = key;
  }
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace repro
