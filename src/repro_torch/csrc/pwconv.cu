// Pointwise convolution / GEMM: out (G, Co) = act(x (G, Ci) @ w (Ci, Co) + bias),
// fp32 accumulation, bias and activation in the epilogue, one store at the
// store type.  x and w are row-major as the reference lays them out; no
// transposed or padded copy of either is made, ragged G, Ci and Co are masked.
//
// Replaces repro/kernels/pwconv.py::pwconv_pallas (body _rtrd_kernel), the
// paper's RTRD PWConv: the output tile stays in registers across the whole
// reduction over Ci and is stored exactly once, while the operands stream
// through shared memory.  Three variants, chosen by
// repro_torch/kernels/blocking.py::plan_pwconv from the shape alone (plus the
// wrapper's check of 16-byte base alignment):
//
// * stream (small G: decode, the SE gate FCs).  A product of G <= 16 rows is
//   bound by the bytes of w.  A CTA owns a slice of Co and a slice of Ci; its
//   256 threads read w rows as 16-byte vectors (one element where Co's rows
//   are not 16-byte multiples), neighbouring threads on neighbouring
//   addresses, eight rows in flight per thread, against x staged in shared
//   memory as fp32.  Each thread keeps its columns x G sums in registers.
//   Ci is split across the CTAs of a thread-block cluster of up to 8; the
//   partial tiles are summed through distributed shared memory in rank order
//   (no float atomics: results repeat run to run), each rank finishing a
//   share of the tile with bias and activation.
// * tc (bf16 / fp16 at larger G, Ci and Co multiples of 8, 16-byte aligned
//   bases).  Tensor cores through wgmma, operands through TMA: one producer
//   thread keeps a ring of 1-4 shared-memory stages full (x tiles K-major, w
//   tiles N-major, both with the 128-byte swizzle, mbarriers for full and
//   empty), one or two consumer warpgroups run m64nNk16 wgmma with the
//   transpose-B bit, so w is read as it lies.  The fp32 accumulators stay in
//   registers; bias, activation and the masked store happen in the epilogue.
// * simt (fp32, and 16-bit shapes TMA cannot describe).  Exact fp32 FMAs on
//   the CUDA cores: a 64/128 x 64/128 CTA tile, 256 threads, a 4/8 x 4/8
//   register micro-tile each, the A tile stored transposed (K x BM) so each
//   thread reads its micro-tile with 16-byte shared-memory loads, and the
//   next K step's global loads issued before the current step's FMAs
//   (register double buffering into two shared-memory buffers).
#include <cooperative_groups.h>
#include <cuda.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace repro;

enum Variant { kStream = 0, kTc = 1, kSimt = 2 };

// Sets a kernel's dynamic shared-memory limit once per size it grows to.
template <typename K>
cudaError_t allow_smem(K kern, size_t bytes, size_t& allowed) {
  if (bytes <= 48 * 1024 || bytes <= allowed) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

// Two 16-bit elements packed in a 32-bit word, as fp32.
__device__ __forceinline__ void unpack2(uint32_t u, float* f, __nv_bfloat16) {
  f[0] = __uint_as_float(u << 16);
  f[1] = __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ void unpack2(uint32_t u, float* f, __half) {
  f[0] = __half2float(__ushort_as_half((unsigned short)(u & 0xffffu)));
  f[1] = __half2float(__ushort_as_half((unsigned short)(u >> 16)));
}

// V consecutive elements of T: one 16-byte vector (V > 1), loaded raw so
// that eight rows in flight cost 32 registers whatever the type, and
// widened to fp32 when they are used; or one element (V = 1).
template <typename T, int V>
struct Raw {
  using type = uint4;
};
template <typename T>
struct Raw<T, 1> {
  using type = T;
};

template <typename T, int V>
__device__ __forceinline__ void load_raw(const T* p, typename Raw<T, V>::type& r) {
  if constexpr (V == 1) r = __ldg(p);
  else r = __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T, int V>
__device__ __forceinline__ void widen(const typename Raw<T, V>::type& r, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = to_f(r);
  } else if constexpr (std::is_same<T, float>::value) {
    static_assert(V == 4, "fp32 vectors are 4 wide");
    f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
  } else {
    static_assert(V == 8, "16-bit vectors are 8 wide");
    unpack2(r.x, f + 0, T{});
    unpack2(r.y, f + 2, T{});
    unpack2(r.z, f + 4, T{});
    unpack2(r.w, f + 6, T{});
  }
}

// ---------------------------------------------------------------------------
// stream: small G, w streamed once, split-K over a cluster
// ---------------------------------------------------------------------------

constexpr int kStreamThreads = 256;
constexpr int kStreamWarps = kStreamThreads / 32;
constexpr int kStreamChunk = 256;  // Ci rows of x staged at a time
constexpr int kStreamUnroll = 8;   // w rows in flight per thread

// Shared-memory layout of one stream CTA; blocking.py::pwconv_smem_bytes
// models the same regions.
struct StreamLayout {
  size_t xs, red, part, total;
};

StreamLayout stream_layout(int gt, int bn, int kslice) {
  StreamLayout l{};
  size_t off = 0;
  l.xs = off; off += align16((size_t)(kslice < kStreamChunk ? kslice : kStreamChunk) * gt * 4);
  l.red = off; off += align16((size_t)kStreamWarps * gt * bn * 4);
  l.part = off; off += align16((size_t)gt * bn * 4);
  l.total = off;
  return l;
}

// Grid (cluster, ceil(Co / bn), ceil(G / GT)), clusters along x.  Rank r of a
// cluster owns Ci rows [r * kslice, (r + 1) * kslice); bn / V threads span
// the CTA's columns and the rest of the 256 take every (256 / (bn / V))-th
// row of the slice.
template <typename T, typename O, int GT, int V>
__global__ void __launch_bounds__(kStreamThreads, 2) pw_stream_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
    O* __restrict__ out, int G, int Ci, int Co, int bn, int kslice, int act, StreamLayout l) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem + l.xs);      // [chunk][GT]
  float* red = reinterpret_cast<float*>(smem + l.red);    // [warps][GT][bn]
  float* part = reinterpret_cast<float*>(smem + l.part);  // [GT][bn]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nranks = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int nthr = bn / V;  // threads across the columns: a power of two <= 32
  const int nt = tid % nthr;
  const int kr = kStreamThreads / nthr;  // rows taken together
  const int n0 = blockIdx.y * bn;
  const int n = n0 + nt * V;
  const int g0 = blockIdx.z * GT;
  const int k_begin = rank * kslice;
  const int k_end = min(Ci, k_begin + kslice);
  const int chunk = min(kslice, kStreamChunk);
  const bool cols = n < Co;  // a vector is whole: Co % V == 0

  float acc[GT][V];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[g][v] = 0.f;

  for (int c0 = k_begin; c0 < k_end; c0 += chunk) {
    const int kc = min(chunk, k_end - c0);
    const T* wp = w + (long long)c0 * Co + n;
    const int kk0 = tid / nthr;
    // kStreamUnroll rows in flight per thread; the rows past the chunk are
    // predicated off, so a short slice still issues all its loads together.
    // The first group is issued before x is staged, so the two round trips
    // overlap.
    typename Raw<T, V>::type raw[kStreamUnroll];
#pragma unroll
    for (int u = 0; u < kStreamUnroll; ++u)
      if (cols && kk0 + u * kr < kc) load_raw<T, V>(wp + (long long)(kk0 + u * kr) * Co, raw[u]);
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < kc * GT; e += kStreamThreads) {
      const int kk = e % kc, g = e / kc;
      xs[kk * GT + g] = g0 + g < G ? to_f(x[(long long)(g0 + g) * Ci + c0 + kk]) : 0.f;
    }
    __syncthreads();
    if (cols) {
      for (int kk = kk0; kk < kc; kk += kStreamUnroll * kr) {
        if (kk != kk0) {
#pragma unroll
          for (int u = 0; u < kStreamUnroll; ++u)
            if (kk + u * kr < kc) load_raw<T, V>(wp + (long long)(kk + u * kr) * Co, raw[u]);
        }
#pragma unroll
        for (int u = 0; u < kStreamUnroll; ++u) {
          if (kk + u * kr >= kc) break;
          float wv[V];
          widen<T, V>(raw[u], wv);
          const float* xr = xs + (kk + u * kr) * GT;
#pragma unroll
          for (int g = 0; g < GT; ++g)
#pragma unroll
            for (int v = 0; v < V; ++v) acc[g][v] = fmaf(xr[g], wv[v], acc[g][v]);
        }
      }
    }
  }

  // the rows of one warp that share columns, then the warps, in order
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    if (off < nthr) break;
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[g][v] += __shfl_xor_sync(0xffffffffu, acc[g][v], off);
  }
  const int warp = tid / 32, lane = tid % 32;
  if (lane < nthr) {
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int v = 0; v < V; ++v) red[(warp * GT + g) * bn + nt * V + v] = acc[g][v];
  }
  __syncthreads();
  const int tile = GT * bn;
  for (int e = tid; e < tile; e += kStreamThreads) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kStreamWarps; ++wi) s += red[wi * tile + e];
    part[e] = s;
  }

  // the cluster's partial tiles, summed in rank order through distributed
  // shared memory; each rank finishes its share of the tile
  cluster.sync();
  const int per = (tile + nranks - 1) / nranks;
  const int e_end = min(tile, (rank + 1) * per);
  for (int e = rank * per + tid; e < e_end; e += kStreamThreads) {
    const int g = g0 + e / bn, nn = n0 + e % bn;
    if (g >= G || nn >= Co) continue;
    float s = 0.f;
    for (int r = 0; r < nranks; ++r) s += cluster.map_shared_rank(part, r)[e];
    if (bias != nullptr) s += to_f(bias[nn]);
    out[(long long)g * Co + nn] = from_f<O>(activate(s, act));
  }
  // keep every CTA's partial tile alive until all ranks have read it
  cluster.sync();
}

template <typename T, typename O, int GT, int V>
int launch_stream_t(const void* x, const void* w, const void* bias, void* out, int G, int Ci,
                    int Co, int bn, int kslice, int cluster, int act, cudaStream_t stream) {
  static size_t allowed = 0;
  static long long placed_key = -1;
  const StreamLayout l = stream_layout(GT, bn, kslice);
  if (l.total > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = pw_stream_kernel<T, O, GT, V>;
  cudaError_t e = allow_smem(kern, l.total, allowed);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, (unsigned)((Co + bn - 1) / bn), (unsigned)((G + GT - 1) / GT));
  cfg.blockDim = dim3(kStreamThreads, 1, 1);
  cfg.dynamicSmemBytes = l.total;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // refuse a cluster the card cannot place (checked once per shared-memory
  // size and cluster, which is all the answer depends on)
  const long long key = (long long)l.total * 16 + cluster;
  if (key != placed_key) {
    int active = 0;
    e = cudaOccupancyMaxActiveClusters(&active, kern, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (active < 1) return (int)cudaErrorLaunchOutOfResources;
    placed_key = key;
  }
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x), static_cast<const T*>(w),
                         static_cast<const T*>(bias), static_cast<O*>(out), G, Ci, Co, bn, kslice,
                         act, l);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, typename O, int V>
int launch_stream_v(const void* x, const void* w, const void* bias, void* out, int G, int Ci,
                    int Co, int gt, int bn, int kslice, int cluster, int act, cudaStream_t stream) {
  // at most 64 fp32 sums a thread
  if (V > 1 && gt * V > 64) return (int)cudaErrorInvalidValue;
#define REPRO_PW_STREAM_CASE(GTV)                                                            \
  if (gt == GTV)                                                                             \
    return launch_stream_t<T, O, GTV, V>(x, w, bias, out, G, Ci, Co, bn, kslice, cluster, act, \
                                         stream);
  REPRO_PW_STREAM_CASE(1)
  REPRO_PW_STREAM_CASE(2)
  REPRO_PW_STREAM_CASE(4)
  REPRO_PW_STREAM_CASE(8)
  if constexpr (V * 16 <= 64) {
    REPRO_PW_STREAM_CASE(16)
  }
#undef REPRO_PW_STREAM_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename O>
int launch_stream(const void* x, const void* w, const void* bias, void* out, int G, int Ci, int Co,
                  int gt, int bn, int kslice, int cluster, int vec, int act, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int v = vec ? kVec : 1;
  const int nthr = bn / v;
  if (bn < 1 || bn % v != 0 || nthr > 32 || (nthr & (nthr - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (vec && (Co % kVec != 0 || (reinterpret_cast<uintptr_t>(w) & 15) != 0))
    return (int)cudaErrorInvalidValue;
  if (cluster < 1 || cluster > 8 || kslice < 1 || (long long)kslice * cluster < Ci ||
      (long long)kslice * (cluster - 1) >= Ci)
    return (int)cudaErrorInvalidValue;
  if (vec)
    return launch_stream_v<T, O, kVec>(x, w, bias, out, G, Ci, Co, gt, bn, kslice, cluster, act, stream);
  return launch_stream_v<T, O, 1>(x, w, bias, out, G, Ci, Co, gt, bn, kslice, cluster, act, stream);
}

// ---------------------------------------------------------------------------
// tc: 16-bit operands, TMA ring + wgmma
// ---------------------------------------------------------------------------

constexpr int kTcBK = 64;          // K per stage: one 128-byte swizzle row of 16-bit
constexpr int kTcMaxStages = 4;    // shared-memory ring depth
constexpr int kTcAlign = 1024;     // the 128-byte swizzle repeats every 1024 bytes

// Ring depth for a reduction of Ci on a BM x BN tile: no deeper than its K
// steps, nor than lets two CTAs share an SM (so one CTA's epilogue overlaps
// another's main loop), nor than 4.
int tc_stages(int bm, int bn, int ci) {
  const int kt = (ci + kTcBK - 1) / kTcBK;
  const int fit = (kMaxSmem / 2 - kTcAlign - 2 * kTcMaxStages * 8) / ((bm + bn) * kTcBK * 2);
  int s = kt < kTcMaxStages ? kt : kTcMaxStages;
  if (fit < s) s = fit;
  // two stages at least once there are two K steps: a stage is released
  // only after the next step's wgmma group is issued
  return s < 2 ? (kt < 2 ? 1 : 2) : s;
}

// Shared memory of one tc CTA: alignment slack, the ring of x tiles (BM rows
// of 128 bytes) and w tiles (64 K rows x BN, as BN / 64 boxes of 64 x 64),
// then the full and empty mbarriers.  blocking.py::pwconv_smem_bytes models
// the same.
size_t tc_smem_bytes(int bm, int bn, int stages) {
  return kTcAlign + (size_t)stages * (bm + bn) * kTcBK * 2 + 2 * stages * 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor with the 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// m64nNk16, fp32 accumulators, A (x) K-major, B (w) N-major (transpose-B).
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db, __nv_bfloat16) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db, __half) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, __nv_bfloat16) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, __half) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN, typename T>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 64) wgmma_n64(d, da, db, T{});
  else wgmma_n128(d, da, db, T{});
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// Grid (ceil(G / BM), ceil(Co / BN)).  Warpgroups 0 .. BM/64 - 1 consume (one
// 64-row half of the tile each); one more warp produces: its first thread
// issues every TMA load.  The consumers keep one wgmma group in flight and
// release a stage once the group that read it has retired.  TMA fills the parts of a box outside (G, Ci) and
// (Ci, Co) with zeros, so the ragged K step adds nothing and the ragged rows
// and columns are only masked at the store.
template <typename T, typename O, int BM, int BN>
__global__ void __launch_bounds__(BM / 64 * 128 + 32) pw_tc_kernel(
    const __grid_constant__ CUtensorMap tma_x, const __grid_constant__ CUtensorMap tma_w,
    const T* __restrict__ bias, O* __restrict__ out, int G, int Ci, int Co, int stages,
    int act) {
  constexpr int kWG = BM / 64;
  constexpr int kAStage = BM * kTcBK * 2;  // bytes of one x tile
  constexpr int kBStage = BN * kTcBK * 2;  // bytes of one w tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((kTcAlign - (smem_u32(smem_raw) & (kTcAlign - 1))) & (kTcAlign - 1));
  unsigned char* as = base;
  unsigned char* bs = base + stages * kAStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + stages * kBStage);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ktiles = (Ci + kTcBK - 1) / kTcBK;

  if (wg == kWG) {
    // producer
    if (tid == kWG * 128) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % stages;
        mbar_wait(&empty[s], ((kt / stages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kAStage + kBStage);
        tma_load_2d(as + s * kAStage, &tma_x, kt * kTcBK, m0, &full[s]);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_2d(bs + s * kBStage + c * 64 * kTcBK * 2, &tma_w, n0 + c * 64, kt * kTcBK, &full[s]);
      }
    }
  } else {
    // consumers
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int held = -1;  // the stage the group in flight reads
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % stages;
      mbar_wait(&full[s], (kt / stages) & 1);
      const unsigned char* a = as + s * kAStage + wg * 64 * 128;
      const unsigned char* b = bs + s * kBStage;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk) {
        // x: K-major rows of 128 bytes, 8-row groups 1024 bytes apart; the
        // k16 slice starts 32 bytes further along the row.  w: N-major, the
        // 64-column boxes 8192 bytes apart, 8-row K groups 1024 bytes
        // apart; the k16 slice starts 16 rows (2048 bytes) further down.
        const uint64_t da = gmma_desc(a + kk * 32, 16, 1024);
        const uint64_t db = gmma_desc(b + kk * 16 * 128, 64 * kTcBK * 2, 1024);
        wgmma<BN, T>(acc, da, db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_acc(acc);
      if (held >= 0) mbar_arrive(&empty[held]);
      held = s;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);

    // epilogue: thread (warp w, lane l) holds rows w*16 + l/4 (+8) and
    // column pairs j*8 + 2*(l%4) of its warpgroup's 64 x BN accumulator
    const int t = tid % 128;
    const int row = m0 + wg * 64 + (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + j * 8 + 2 * (t % 4);
      if (col >= Co) continue;  // Co is even: a pair is whole
      const float b0 = bias != nullptr ? to_f(bias[col]) : 0.f;
      const float b1 = bias != nullptr ? to_f(bias[col + 1]) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r >= G) continue;
        store_pair(out + (long long)r * Co + col, activate(acc[j * 4 + 2 * h] + b0, act),
                   activate(acc[j * 4 + 2 * h + 1] + b1, act));
      }
    }
  }
}

// A 2-D row-major (rows, cols) tensor of 16-bit elements as a TMA map with
// (box_cols, box_rows) boxes and the 128-byte swizzle.
template <typename T>
bool encode_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_cols, int box_rows) {
  const CUtensorMapDataType dt = std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return cuTensorMapEncodeTiled(map, dt, 2, const_cast<void*>(ptr), dims, strides, box, estr,
                                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, typename O, int BM, int BN>
int launch_tc_t(const void* x, const void* w, const void* bias, void* out, int G, int Ci, int Co,
                int act, cudaStream_t stream) {
  static size_t allowed = 0;
  CUtensorMap mx, mw;
  if (!encode_map<T>(&mx, x, G, Ci, kTcBK, BM) || !encode_map<T>(&mw, w, Ci, Co, 64, kTcBK))
    return (int)cudaErrorInvalidValue;
  const int stages = tc_stages(BM, BN, Ci);
  const size_t smem = tc_smem_bytes(BM, BN, stages);
  auto kern = pw_tc_kernel<T, O, BM, BN>;
  cudaError_t e = allow_smem(kern, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((G + BM - 1) / BM), (unsigned)((Co + BN - 1) / BN));
  kern<<<grid, BM / 64 * 128 + 32, smem, stream>>>(mx, mw, static_cast<const T*>(bias),
                                                    static_cast<O*>(out), G, Ci, Co, stages, act);
  return (int)cudaGetLastError();
}

template <typename T, typename O>
int launch_tc(const void* x, const void* w, const void* bias, void* out, int G, int Ci, int Co,
              int bm, int bn, int bk, int act, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    return (int)cudaErrorInvalidValue;  // fp32 stays on the CUDA cores
  } else {
    const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w);
    if (bk != kTcBK || Ci % 8 != 0 || Co % 8 != 0 || (align & 15) != 0)
      return (int)cudaErrorInvalidValue;
    if (bm == 128 && bn == 128) return launch_tc_t<T, O, 128, 128>(x, w, bias, out, G, Ci, Co, act, stream);
    if (bm == 128 && bn == 64) return launch_tc_t<T, O, 128, 64>(x, w, bias, out, G, Ci, Co, act, stream);
    if (bm == 64 && bn == 128) return launch_tc_t<T, O, 64, 128>(x, w, bias, out, G, Ci, Co, act, stream);
    if (bm == 64 && bn == 64) return launch_tc_t<T, O, 64, 64>(x, w, bias, out, G, Ci, Co, act, stream);
    return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// simt: exact fp32 FMAs, register-tiled
// ---------------------------------------------------------------------------

constexpr int kSimtThreads = 256;
constexpr int kSimtBK = 8;

size_t simt_smem_bytes(int bm, int bn) { return (size_t)2 * kSimtBK * (bm + bn) * 4; }

// VEC: fp32 operands with Ci and Co multiples of 4 and 16-byte aligned bases,
// loaded as float4; otherwise element by element.
template <typename T, bool VEC>
__device__ __forceinline__ void load4(const T* p, bool ok, int avail, float (&f)[4]) {
  if constexpr (VEC) {
    const float4 r = ok ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = ok && j < avail ? to_f(p[j]) : 0.f;
  }
}

// Grid (ceil(G / BM), ceil(Co / BN)).  Thread (ty, tx) of a 16 x 16 grid owns
// rows ty*4 + {0..3} (+64) and columns tx*4 + {0..3} (+64) of the tile.
template <typename T, typename O, int BM, int BN, bool VEC>
__global__ void __launch_bounds__(kSimtThreads) pw_simt_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
    O* __restrict__ out, int G, int Ci, int Co, int act) {
  constexpr int TM = BM / 16, TN = BN / 16;
  constexpr int ACH = BM * kSimtBK / 4, BCH = kSimtBK * BN / 4;  // 4-element chunks
  constexpr int APER = (ACH + kSimtThreads - 1) / kSimtThreads;
  constexpr int BPER = (BCH + kSimtThreads - 1) / kSimtThreads;
  extern __shared__ __align__(16) float sm[];
  float* as = sm;                       // [2][BK][BM]
  float* bs = sm + 2 * kSimtBK * BM;    // [2][BK][BN]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float ra[APER][4], rb[BPER][4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < APER; ++i) {
      const int c = tid + i * kSimtThreads;
      const int r = c / (kSimtBK / 4), kq = (c % (kSimtBK / 4)) * 4;
      const long long g = m0 + r;
      const int k = k0 + kq;
      load4<T, VEC>(x + g * Ci + k, c < ACH && g < G && k < Ci, Ci - k, ra[i]);
    }
#pragma unroll
    for (int i = 0; i < BPER; ++i) {
      const int c = tid + i * kSimtThreads;
      const int k = k0 + c / (BN / 4), nq = (c % (BN / 4)) * 4;
      const int n = n0 + nq;
      load4<T, VEC>(w + (long long)k * Co + n, c < BCH && k < Ci && n < Co, Co - n, rb[i]);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < APER; ++i) {
      const int c = tid + i * kSimtThreads;
      if (c >= ACH) continue;
      const int r = c / (kSimtBK / 4), kq = (c % (kSimtBK / 4)) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) as[(buf * kSimtBK + kq + j) * BM + r] = ra[i][j];
    }
#pragma unroll
    for (int i = 0; i < BPER; ++i) {
      const int c = tid + i * kSimtThreads;
      if (c >= BCH) continue;
      const int k = c / (BN / 4), nq = (c % (BN / 4)) * 4;
      *reinterpret_cast<float4*>(bs + (buf * kSimtBK + k) * BN + nq) =
          make_float4(rb[i][0], rb[i][1], rb[i][2], rb[i][3]);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < Ci; k0 += kSimtBK) {
    const bool next = k0 + kSimtBK < Ci;
    if (next) load(k0 + kSimtBK);  // in flight during this step's FMAs
#pragma unroll
    for (int k = 0; k < kSimtBK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM / 4; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(as + (buf * kSimtBK + k) * BM + i * 64 + ty * 4);
        a[i * 4] = v.x; a[i * 4 + 1] = v.y; a[i * 4 + 2] = v.z; a[i * 4 + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN / 4; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(bs + (buf * kSimtBK + k) * BN + j * 64 + tx * 4);
        b[j * 4] = v.x; b[j * 4 + 1] = v.y; b[j * 4 + 2] = v.z; b[j * 4 + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (next) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long g = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (g >= G) continue;
#pragma unroll
    for (int j4 = 0; j4 < TN / 4; ++j4) {
      const int n = n0 + j4 * 64 + tx * 4;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float bv = bias != nullptr && n + j < Co ? to_f(bias[n + j]) : 0.f;
        v[j] = activate(acc[i][j4 * 4 + j] + bv, act);
      }
      if constexpr (VEC && std::is_same<O, float>::value) {
        if (n < Co) *reinterpret_cast<float4*>(out + g * Co + n) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < Co) out[g * Co + n + j] = from_f<O>(v[j]);
      }
    }
  }
}

template <typename T, typename O, int BM, int BN>
int launch_simt_t(const void* x, const void* w, const void* bias, void* out, int G, int Ci, int Co,
                  bool vec, int act, cudaStream_t stream) {
  const size_t smem = simt_smem_bytes(BM, BN);
  const dim3 grid((unsigned)((G + BM - 1) / BM), (unsigned)((Co + BN - 1) / BN));
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      pw_simt_kernel<T, O, BM, BN, true><<<grid, kSimtThreads, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
          static_cast<O*>(out), G, Ci, Co, act);
      return (int)cudaGetLastError();
    }
  }
  pw_simt_kernel<T, O, BM, BN, false><<<grid, kSimtThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<O*>(out), G, Ci, Co, act);
  return (int)cudaGetLastError();
}

template <typename T, typename O>
int launch_simt(const void* x, const void* w, const void* bias, void* out, int G, int Ci, int Co,
                int bm, int bn, int bk, int act, cudaStream_t stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(out);
  const bool vec = std::is_same<T, float>::value && Ci % 4 == 0 && Co % 4 == 0 && (align & 15) == 0;
  if (bk != kSimtBK) return (int)cudaErrorInvalidValue;
  if (bm == 128 && bn == 128) return launch_simt_t<T, O, 128, 128>(x, w, bias, out, G, Ci, Co, vec, act, stream);
  if (bm == 128 && bn == 64) return launch_simt_t<T, O, 128, 64>(x, w, bias, out, G, Ci, Co, vec, act, stream);
  if (bm == 64 && bn == 128) return launch_simt_t<T, O, 64, 128>(x, w, bias, out, G, Ci, Co, vec, act, stream);
  if (bm == 64 && bn == 64) return launch_simt_t<T, O, 64, 64>(x, w, bias, out, G, Ci, Co, vec, act, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename O>
int launch_io(const void* x, const void* w, const void* bias, void* out, int G, int Ci, int Co,
              int variant, int bg, int bco, int bci, int cluster, int vec, int act,
              cudaStream_t stream) {
  if (G < 1 || Ci < 1 || Co < 1) return (int)cudaErrorInvalidValue;
  switch (variant) {
    case kStream:
      return launch_stream<T, O>(x, w, bias, out, G, Ci, Co, bg, bco, bci, cluster, vec, act, stream);
    case kTc:
      return launch_tc<T, O>(x, w, bias, out, G, Ci, Co, bg, bco, bci, act, stream);
    case kSimt:
      return launch_simt<T, O>(x, w, bias, out, G, Ci, Co, bg, bco, bci, act, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

REPRO_EXPORT_ERROR_STRING(pwconv)

// x (G, Ci), w (Ci, Co), bias (Co) or null, at the stream type; out (G, Co)
// at the store type.  variant 0 stream: (bg, bco) = (G rows, Co columns) a
// CTA holds, bci the Ci rows of each of the cluster's CTAs, vec 1 to read w
// as 16-byte vectors; variant 1 tc and 2 simt: (bg, bco, bci) one of the
// compiled tiles, cluster and vec unused.
extern "C" int pwconv_launch(const void* x, const void* w, const void* bias, void* out, int G,
                             int Ci, int Co, int variant, int bg, int bco, int bci, int cluster,
                             int vec, int act, int in_dtype, int out_dtype, void* stream) {
  REPRO_DISPATCH_IO(in_dtype, out_dtype, launch_io, x, w, bias, out, G, Ci, Co, variant, bg, bco,
                    bci, cluster, vec, act, static_cast<cudaStream_t>(stream));
}

// Shared memory one CTA of this variant and tile needs for a reduction over
// ci, in bytes: lets the wrapper check the planner's model against the
// kernel.
extern "C" long long pwconv_smem_bytes(int variant, int bg, int bco, int bci, int ci) {
  if (bg < 1 || bco < 1 || bci < 1) return 0;
  switch (variant) {
    case kStream:
      return (long long)stream_layout(bg, bco, bci).total;
    case kTc:
      return (long long)tc_smem_bytes(bg, bco, tc_stages(bg, bco, ci));
    case kSimt:
      return (long long)simt_smem_bytes(bg, bco);
    default:
      return 0;
  }
}
