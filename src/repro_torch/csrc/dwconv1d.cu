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
// What bounds it on the H100: bytes (x and dy read once, dx written once,
// df K x D); 4K operations a row and channel are far under the card's
// operations a byte.  dw1d_bwd_kernel computes both in one launch:
//   * registers: a CTA of 128 threads covers one tile of 32 channels, a
//     lane 4 adjacent channels of one run of rows, so a thread keeps K taps,
//     K fp32 tap sums and two (K-1)-row windows of 4 channels (16K - 8
//     floats; the old kernel held 8 channels a thread in bf16), and loads a
//     row's 4 values in one 16- or 8-byte shared-memory read;
//   * bytes in flight: the CTA stages its rows of x and dy (with their K-1
//     halo rows) in shared memory with 16-byte cp.async copies, two stages
//     of 80 rows (fp32) or 144 (16 bits, a stage of about the same bytes),
//     the next stage's copies in flight while the warps slide their windows
//     down the current one, five or nine rows a run, unrolled (rows of a
//     batch row only: every tap is masked by the row's position, so a stage
//     may span batch rows); misaligned or ragged widths take plain loads
//     into the stages;
//   * waves: a thread-block cluster of up to 16 CTAs splits a tile's B * L
//     rows, doubled while the grid holds fewer than two CTAs for each of the
//     132 SMs (768 channels: 24 tiles, clusters of 16, 384 CTAs); the whole
//     grid is one wave;
//   * the reduction: each CTA sums its runs' tap sums by a fixed shuffle
//     tree and its warps' in warp order, pushes them through distributed
//     shared memory to the rank that owns each entry, and after one cluster
//     barrier each rank sums its entries in rank order and rounds once to
//     f's type, so df has the same bits at every call and in a CUDA-graph
//     replay (training's bit-exact recovery), with no atomics and no second
//     launch.
// K = 2..5 take exact-K windows; any other K, K = 1 included, a runtime tap
// loop that reads x and dy from global memory and sums df one tap at a time.
#include "tile_gemm.cuh"

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

// A CTA: 128 threads over one tile of 32 channels of a range of the B * L
// rows.  At K = 2..5 a lane owns 4 adjacent channels, so 8 lanes cover a
// row of the tile and the CTA's 16 runs cover a chunk; a thread-block
// cluster of up to 16 CTAs splits the rows of one tile, so the grid is
// (cluster, tiles).
constexpr int kBwdThreads = 128;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdTile = 32;
constexpr int kBwdVec = 4;
constexpr int kBwdRowLanes = kBwdTile / kBwdVec;
constexpr int kBwdRuns = kBwdThreads / kBwdRowLanes;
// Rows of a run in a chunk, for 4- and 2-byte types (a stage of about the
// same bytes): odd, so that the two runs a 16-bit load phase of a half warp
// reads (64-byte rows) lie on other banks.
constexpr int kBwdRunRows = 5;
constexpr int kBwdRunRows16 = 9;
// The stages: the copies of the next chunk are in flight while the warps
// compute one.
constexpr int kBwdStages = 2;
constexpr int kBwdMaxCluster = 16;
// The grid the cluster is sized for: two CTAs on each of the H100's 132 SMs.
constexpr long long kBwdFill = 2 * 132;
// Fewest rows a CTA is given when the cluster grows.
constexpr long long kBwdMinRows = 32;
constexpr int kBwdMinBlocks = 1;

// Rows of a run and of a chunk (a shared-memory stage holds a chunk and
// its K-1 halo rows) for the element size esize.
__host__ __device__ constexpr int bwd_run_rows(int esize) {
  return esize == 4 ? kBwdRunRows : kBwdRunRows16;
}
__host__ __device__ constexpr int bwd_chunk(int esize) { return kBwdRuns * bwd_run_rows(esize); }

// Rows [first, first + n) of g's tile (channels [c0, c0 + nch)) into s, n
// rows of kBwdTile elements: 16-byte cp.async copies under VEC (nch is
// then a multiple of 16 / sizeof(T)), plain loads otherwise.  Rows outside
// [0, BL) are left as they are: the compute masks every use of them.
template <typename T, bool VEC>
__device__ __forceinline__ void stage_rows(T* s, const T* __restrict__ g, long long first, int n,
                                           long long BL, int D, int c0, int nch) {
  if constexpr (VEC) {
    constexpr int E = 16 / sizeof(T);
    constexpr int P = kBwdTile / E;
    for (int p = threadIdx.x; p < n * P; p += kBwdThreads) {
      const int j = p / P, q = p % P;
      const long long r = first + j;
      if (q * E < nch && r >= 0 && r < BL) cp16(s + j * kBwdTile + q * E, g + r * D + c0 + q * E, true);
    }
  } else {
    for (int e = threadIdx.x; e < n * kBwdTile; e += kBwdThreads) {
      const int j = e / kBwdTile, c = e % kBwdTile;
      const long long r = first + j;
      if (c < nch && r >= 0 && r < BL) s[e] = g[r * D + c0 + c];
    }
  }
}

// The split cluster barrier: arrive (this CTA has started, so the others
// may write into its shared memory) and wait (every CTA has arrived).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread's copies are in
// flight.
template <int N>
__device__ __forceinline__ void cp_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The CTA's sum sum(e) of entry e < taps * kBwdTile (tap i0 + e / 32,
// channel e % 32 of the tile) into df, summed over the cluster's ranks in
// rank order: each rank pushes its sums into the shared memory (vals) of
// the rank that owns the entry, through distributed shared memory, and
// after one cluster barrier each rank sums its entries and rounds once.
// The first fold waits for the arrive every CTA made when it started.
template <typename T, typename S>
__device__ __forceinline__ void cluster_fold(cg::cluster_group& cluster, S&& sum, float* vals,
                                             bool first, int taps, int i0, T* __restrict__ df,
                                             int D, int c0, int nch) {
  const int ranks = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int n = taps * kBwdTile;
  const int share = (n + ranks - 1) / ranks;
  if (first) cluster_wait();
  for (int e = threadIdx.x; e < n; e += kBwdThreads) {
    const int owner = e / share;
    cluster.map_shared_rank(vals, owner)[(e - owner * share) * ranks + rank] = sum(e);
  }
  cluster.sync();
  const int e0 = rank * share;
  const int cnt = max(0, min(n, e0 + share) - e0);
  for (int t = threadIdx.x; t < cnt; t += kBwdThreads) {
    float s = 0.f;
    for (int q = 0; q < ranks; ++q) s += vals[t * ranks + q];
    const int e = e0 + t, c = e % kBwdTile;
    if (c < nch) df[(long long)(i0 + e / kBwdTile) * D + c0 + c] = from_f<T>(s);
  }
}

// dx and df in one launch.  Grid (cluster, tiles), clusters along x: rank q
// of tile t owns rows [q rb, (q + 1) rb) of B * L and channels
// [32 t, 32 t + 32).  KT > 0: exact K (2..5), the rows staged in shared
// memory chunk by chunk (bwd_chunk rows and their halo a stage), each
// thread sliding register windows of its 4 channels down its run of a
// chunk; KT == 0: a runtime tap loop (k_rt taps, a channel a lane) that
// reads from global memory, df one tap at a time.
template <typename T, int KT, bool VEC>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks) dw1d_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ f, const T* __restrict__ dy, T* __restrict__ dx,
    T* __restrict__ df, long long BL, int L, int D, int k_rt, long long rb) {
  constexpr int KR = KT > 0 ? KT : 1;  // taps one reduction holds
  // red (warps, KR, tile): each warp's sums; vals (2, KR * tile + 16): the
  // ranks' sums a fold's entries receive (two, for the runtime path's
  // folds in turn); then, for KT > 0, the stages of x's and dy's rows
  extern __shared__ __align__(16) float dyn[];
  float* red = dyn;
  float* vals = red + kBwdWarps * KR * kBwdTile;
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.y * kBwdTile;
  const int nch = min(kBwdTile, D - c0);
  const long long r_beg = (long long)blockIdx.x * rb;
  const long long r_end = min(r_beg + rb, BL);
  const long long n_rows = r_end > r_beg ? r_end - r_beg : 0;

  if constexpr (KT > 0) {
    constexpr int V = kBwdVec;
    constexpr int run_rows = bwd_run_rows(sizeof(T));
    constexpr int chunk = bwd_chunk(sizeof(T));
    constexpr int srows = chunk + KT - 1;
    // stage s: xs[s] holds x's rows from r0 - (K-1), gs[s] dy's from r0
    T* xs = reinterpret_cast<T*>(vals + 2 * (KR * kBwdTile + kBwdMaxCluster));
    T* gs = xs + kBwdStages * srows * kBwdTile;
    const int cg4 = (lane % kBwdRowLanes) * V;   // the lane's first channel in the tile
    const int run = threadIdx.x / kBwdRowLanes;  // the lane's run of a chunk
    const int d = c0 + cg4;
    const bool live = cg4 < nch;                    // (under VEC all 4 channels are)
    float tap[KT][V], acc[KT][V];
#pragma unroll
    for (int i = 0; i < KT; ++i) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        tap[i][v] = 0.f;
        acc[i][v] = 0.f;
      }
      if constexpr (VEC) {
        if (live) load_f<T, V>(f + (long long)i * D + d, tap[i]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (cg4 + v < nch) tap[i][v] = to_f(f[(long long)i * D + d + v]);
      }
    }
    const int chunks = (int)((n_rows + chunk - 1) / chunk);
    // chunk c's rows into stage c % kBwdStages; one commit group a chunk
    // (empty past the last), so that the waits count chunks
    auto stage = [&](int c) {
      if (c < chunks) {
        const long long r0 = r_beg + (long long)c * chunk;
        const int n = (int)min((long long)chunk, r_end - r0);
        const int s = c % kBwdStages;
        stage_rows<T, VEC>(xs + s * srows * kBwdTile, x, r0 - (KT - 1), n + KT - 1, BL, D, c0, nch);
        stage_rows<T, VEC>(gs + s * srows * kBwdTile, dy, r0, n + KT - 1, BL, D, c0, nch);
      }
      cp_commit();
    };
#pragma unroll
    for (int c = 0; c < kBwdStages - 1; ++c) stage(c);
    for (int c = 0; c < chunks; ++c) {
      // chunk c has landed for every thread, and every warp is done with
      // chunk c - 1, whose stage the copies of chunk c + kBwdStages - 1 take
      cp_wait_group<kBwdStages - 2>();
      __syncthreads();
      stage(c + kBwdStages - 1);
      const long long r0 = r_beg + (long long)c * chunk;
      const int n = (int)min((long long)chunk, r_end - r0);
      const int ja = run * run_rows, nr = min(run_rows, n - ja);
      if (live && nr > 0) {
        const T* sx = xs + (c % kBwdStages) * srows * kBwdTile + cg4;
        const T* sg = gs + (c % kBwdStages) * srows * kBwdTile + cg4;
        long long r = r0 + ja;
        int l = (int)(r % L);
        // xw[m] = x[r - (K-1) + m], gw[m] = dy[r + m] for the row r at hand
        float xw[KT - 1][V], gw[KT - 1][V];
#pragma unroll
        for (int m = 0; m < KT - 1; ++m) {
          load_f<T, V>(sx + (ja + m) * kBwdTile, xw[m]);
          load_f<T, V>(sg + (ja + m) * kBwdTile, gw[m]);
        }
        T* o = dx + r * D + d;
#pragma unroll
        for (int j = 0; j < run_rows; ++j) {
          if (j < nr) {
            float xc[V], gn[V];
            load_f<T, V>(sx + (ja + j + KT - 1) * kBwdTile, xc);  // x[r]
            load_f<T, V>(sg + (ja + j + KT - 1) * kBwdTile, gn);  // dy[r + K-1]
            // dx[r] = sum_i f[i] dy[r + (K-1) - i], rows of r's batch row only
            bool in[KT - 1];
#pragma unroll
            for (int i = 0; i < KT - 1; ++i) in[i] = l + (KT - 1 - i) < L;
            Vec<T, V> ov;
#pragma unroll
            for (int v = 0; v < V; ++v) {
              float s = tap[KT - 1][v] * gw[0][v];
#pragma unroll
              for (int i = 0; i < KT - 1; ++i) {
                const int off = KT - 1 - i;
                const float g = off < KT - 1 ? gw[off][v] : gn[v];
                if (in[i]) s = fmaf(tap[i][v], g, s);
              }
              ov.v[v] = from_f<T>(s);
            }
            if constexpr (VEC) {
              *reinterpret_cast<Vec<T, V>*>(o) = ov;
            } else {
#pragma unroll
              for (int v = 0; v < V; ++v)
                if (cg4 + v < nch) o[v] = ov.v[v];
            }
            o += D;
            // df[i] += x[r - (K-1) + i] dy[r], rows of r's batch row only
#pragma unroll
            for (int i = 0; i < KT - 1; ++i) {
              if (l >= KT - 1 - i) {
#pragma unroll
                for (int v = 0; v < V; ++v) acc[i][v] = fmaf(xw[i][v], gw[0][v], acc[i][v]);
              }
            }
#pragma unroll
            for (int v = 0; v < V; ++v) acc[KT - 1][v] = fmaf(xc[v], gw[0][v], acc[KT - 1][v]);
#pragma unroll
            for (int m = 0; m + 1 < KT - 1; ++m)
#pragma unroll
              for (int v = 0; v < V; ++v) {
                xw[m][v] = xw[m + 1][v];
                gw[m][v] = gw[m + 1][v];
              }
#pragma unroll
            for (int v = 0; v < V; ++v) {
              xw[KT - 2][v] = xc[v];
              gw[KT - 2][v] = gn[v];
            }
            if (++l == L) l = 0;
          }
        }
      }
    }
    // the CTA's sums: a warp's 4 runs by a fixed shuffle tree, the warps'
    // in warp order, then the cluster's ranks' in rank order
#pragma unroll
    for (int i = 0; i < KT; ++i)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float a = acc[i][v];
#pragma unroll
#pragma unroll
        for (int o = kBwdRowLanes; o < 32; o *= 2) a += __shfl_xor_sync(0xffffffffu, a, o);
        if (lane < kBwdRowLanes) red[(warp * KT + i) * kBwdTile + cg4 + v] = a;
      }
    __syncthreads();
    cluster_fold<T>(cluster, [&](int e) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kBwdWarps; ++w) s += red[w * KT * kBwdTile + e];
      return s;
    }, vals, true, KT, 0, df, D, c0, nch);
  } else {
    const int K = k_rt;
    const int d = c0 + lane;
    const bool live = lane < nch;
    const long long rw = (n_rows + kBwdWarps - 1) / kBwdWarps;  // rows of a warp
    const long long ra = r_beg + warp * rw, rz = min(ra + rw, r_end);
    const T* xb = x + d;
    const T* gb = dy + d;
    if (live) {
      int l = (int)(ra % L);
      for (long long r = ra; r < rz; ++r) {
        float s = 0.f;
        for (int i = 0; i < K; ++i) {
          const int off = K - 1 - i;
          if (l + off < L) s = fmaf(to_f(f[(long long)i * D + d]), to_f(gb[(r + off) * D]), s);
        }
        dx[r * D + d] = from_f<T>(s);
        if (++l == L) l = 0;
      }
    }
    for (int i = 0; i < K; ++i) {
      float a = 0.f;
      if (live) {
        int l = (int)(ra % L);
        for (long long r = ra; r < rz; ++r) {
          if (l >= K - 1 - i) a = fmaf(to_f(xb[(r - (K - 1) + i) * D]), to_f(gb[r * D]), a);
          if (++l == L) l = 0;
        }
      }
      red[warp * kBwdTile + lane] = a;
      __syncthreads();
      // vals alternates between taps: a rank writes into another's for
      // tap i + 2 only after the cluster barrier of tap i + 1, which that
      // rank reaches when it is done summing tap i
      cluster_fold<T>(cluster, [&](int e) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kBwdWarps; ++w) s += red[w * kBwdTile + e];
        return s;
      }, vals + (i & 1) * (kBwdTile + kBwdMaxCluster), i == 0, 1, i, df, D, c0, nch);
    }
  }
}

// The backward's launch: grid (cluster, tiles), the cluster along x sized
// so that the grid puts two CTAs on every SM where the rows allow it; rb
// rows a CTA.
struct BwdPlan {
  LaunchDims d;
  long long rb;
};

inline BwdPlan bwd_plan(long long BL, int D, int K, int esize) {
  const long long tiles = (D + kBwdTile - 1) / kBwdTile;
  int cluster = 1;
  while (cluster < kBwdMaxCluster && tiles * cluster < kBwdFill &&
         (BL + 2 * cluster - 1) / (2 * cluster) >= kBwdMinRows)
    cluster *= 2;
  BwdPlan p;
  p.rb = (BL + cluster - 1) / cluster;
  const bool exact = K >= 2 && K <= 5;
  const int kr = exact ? K : 1;
  const size_t smem = ((size_t)kBwdWarps * kr * kBwdTile + 2 * (kr * kBwdTile + kBwdMaxCluster)) * sizeof(float) +
                      (exact ? (size_t)kBwdStages * 2 * (bwd_chunk(esize) + K - 1) * kBwdTile * esize : 0);
  p.d = launch_dims(cluster, tiles, 1, kBwdThreads, cluster, smem);
  return p;
}

template <typename T, int KT, bool VEC>
int launch_bwd_kv(const void* x, const void* f, const void* dy, void* dx, void* df, long long BL,
                  int L, int D, int k, cudaStream_t stream) {
  static bool allowed = false;
  static long long placed_key = -1;
  const BwdPlan p = bwd_plan(BL, D, k, sizeof(T));
  if (p.d.grid[1] > 65535) return (int)cudaErrorInvalidConfiguration;
  return launch_clustered(dw1d_bwd_kernel<T, KT, VEC>, p.d, stream, allowed, placed_key,
                          static_cast<const T*>(x), static_cast<const T*>(f),
                          static_cast<const T*>(dy), static_cast<T*>(dx), static_cast<T*>(df), BL,
                          L, D, k, p.rb);
}

template <typename T, bool VEC>
int launch_bwd_v(const void* x, const void* f, const void* dy, void* dx, void* df, long long BL,
                 int L, int D, int k, cudaStream_t stream) {
  switch (k) {
    case 2: return launch_bwd_kv<T, 2, VEC>(x, f, dy, dx, df, BL, L, D, k, stream);
    case 3: return launch_bwd_kv<T, 3, VEC>(x, f, dy, dx, df, BL, L, D, k, stream);
    case 4: return launch_bwd_kv<T, 4, VEC>(x, f, dy, dx, df, BL, L, D, k, stream);
    case 5: return launch_bwd_kv<T, 5, VEC>(x, f, dy, dx, df, BL, L, D, k, stream);
    default: return launch_bwd_kv<T, 0, VEC>(x, f, dy, dx, df, BL, L, D, k, stream);
  }
}

template <typename T>
int launch_bwd(const void* x, const void* f, const void* dy, void* dx, void* df, long long BL,
               int L, int D, int k, int vec, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec) return launch_bwd_v<T, true>(x, f, dy, dx, df, BL, L, D, k, stream);
  if (vec == 1) return launch_bwd_v<T, false>(x, f, dy, dx, df, BL, L, D, k, stream);
  return (int)cudaErrorInvalidValue;
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

// The backward, dx and df in one launch: x, f, dy (B, L, D) / (K, D), dx
// (B, L, D) and df (K, D), all at one type (dtype code).  vec: 1, or
// 16 / sizeof(type) when D divides into it and every operand is 16-byte
// aligned.
extern "C" int dwconv1d_bwd_launch(const void* x, const void* f, const void* dy, void* dx,
                                   void* df, int B, int L, int D, int K, int vec, int dtype,
                                   void* stream) {
  using namespace repro;
  if (K < 1 || B < 1 || L < 1 || D < 1 || vec < 1 || D % vec != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long BL = (long long)B * L;
  if (dtype == kF32) return launch_status(launch_bwd<float>(x, f, dy, dx, df, BL, L, D, K, vec, s));
  if (dtype == kBF16)
    return launch_status(launch_bwd<__nv_bfloat16>(x, f, dy, dx, df, BL, L, D, K, vec, s));
  if (dtype == kF16) return launch_status(launch_bwd<__half>(x, f, dy, dx, df, BL, L, D, K, vec, s));
  return (int)cudaErrorInvalidValue;
}

// The backward's launch at (B, L, D, K, dtype) as ten numbers (write_dims),
// the ones dwconv1d_bwd_launch uses.
extern "C" int dwconv1d_bwd_launch_dims(int B, int L, int D, int K, int dtype, long long* out) {
  using namespace repro;
  if (K < 1 || B < 1 || L < 1 || D < 1) return (int)cudaErrorInvalidValue;
  return write_dims(bwd_plan((long long)B * L, D, K, dtype == kF32 ? 4 : 2).d, out);
}
