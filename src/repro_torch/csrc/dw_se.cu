// Depthwise conv with the squeeze-excite gate as its epilogue, in one pass:
//   y    = act_dw(DW(x) + dw_bias)                   (fp32, never stored raw)
//   gate = sigmoid(act_se(mean_hw(y) @ w1 + b1) @ w2 + b2)
//   out  = y * gate
// NHWC, VALID geometry (the wrapper pads SAME with zeros).
//
// Replaces repro/kernels/se_epilogue.py::dw_se_pallas (body _dw_se_kernel).
//
// The gate of an image needs the pooled mean of every channel of its DW
// output over the whole image; a partial pool is a wrong answer.  The TPU
// kernel holds one image's whole fp32 DW output in VMEM.  One CTA's 227 KB
// cannot hold it for most MnasNet SE blocks (28x28x120 is 376 KB), so an
// image is owned by one thread-block cluster of n CTAs (n = 1, 2, 4 or 8,
// from repro_torch/kernels/blocking.py::plan_dw_se).  CTA r of the cluster
// owns channels [r*cs, (r+1)*cs) with cs = ceil(C / n) and:
//   1. computes DW + bias + act for its channels over the whole image into
//      its shared memory as fp32, a thread owning one channel (a 3x3 or 5x5
//      filter's taps in registers) and every rows-th pixel, and summing
//      what it computes;
//   2. reduces those sums to the slice's pooled means;
//   3. forms its partial hidden vector pooled_slice @ w1[slice, :], one
//      warp per hidden unit with a shuffle reduction;
//   4. after a cluster barrier, sums the n partials of every hidden unit
//      through distributed shared memory, in rank order, so every CTA gets
//      the same vector; adds b1 and applies act_se;
//   5. computes the gates of its channels, sigmoid(hid @ w2 + b2);
//   6. scales its resident slice and stores it once.
// A second cluster barrier keeps every CTA's partials alive until all have
// read them.  The barrier is what guarantees that no gate sees a partial
// pool.
//
// That is the `resident` mode.  Where even 8 CTAs cannot hold the slice
// (MnasNet's 28x28x672 block at a 224 input: 2.1 MB of fp32 DW output),
// the `recompute` mode keeps nothing but the sums in step 1, and in step 6
// computes each DW value again, by the same code in the same tap order, so
// its values are bit-identical to the resident mode's; it pays the DW's
// multiply-adds twice and a second read of the input, mostly from L2.
//
// What bounds it on the H100: bytes (Hf*Wf multiply-adds per output against
// one input read and one output write; the gate's FCs are tiny).  The
// input window is read from device memory, not staged: neighbouring threads
// own neighbouring channels, so a warp reads runs along C.  The resident
// slice leaves little of the SM's 256 KB to L1, so most of the
// Hf*Wf/stride^2 re-reads come from L2, and a CTA is one per SM: it runs
// 1024 threads to keep enough reads in flight.  With one cluster per image
// a launch has at most 8*B CTAs, far fewer than the card's 132 SMs at
// batch 1; what this kernel buys is that the DW output makes no round trip
// through device memory between the DW, the pool and the scale.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace repro;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

struct Geometry {
  int Hi, Wi, C, Ho, Wo, hf, wf, stride, cse, cs, act_dw, act_se;
};

// Shared-memory layout of one CTA; repro_torch/kernels/blocking.py
// ::dw_se_smem_bytes models the same regions in the same order.
struct Layout {
  size_t dw, red, pooled, gate, hpart, hid, total;
};

Layout dw_se_layout(const Geometry& g, bool resident) {
  Layout l{};
  size_t off = 0;
  l.dw = off; off += resident ? align16((size_t)g.Ho * g.Wo * g.cs * 4) : 0;
  l.red = off; off += align16((size_t)kThreads * 4);
  l.pooled = off; off += align16((size_t)g.cs * 4);
  l.gate = off; off += align16((size_t)g.cs * 4);
  l.hpart = off; off += align16((size_t)g.cse * 4);
  l.hid = off; off += align16((size_t)g.cse * 4);
  l.total = off;
  return l;
}

// K is 3 or 5 for a K x K filter, whose taps are held in registers and whose
// K*K reads per pixel, unrolled without guards, are all in flight together;
// 0 for any other filter, whose taps are read per pixel.  RESIDENT: keep the
// DW output in shared memory between the pool and the scale, else compute
// it again for the scale.
template <typename T, typename O, int K, bool RESIDENT>
__global__ void __launch_bounds__(kThreads) dw_se_kernel(
    const T* __restrict__ x, const T* __restrict__ f, const T* __restrict__ dwb,
    const T* __restrict__ w1, const T* __restrict__ b1, const T* __restrict__ w2,
    const T* __restrict__ b2, O* __restrict__ out, Geometry g, Layout l) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* dws = reinterpret_cast<float*>(smem + l.dw);        // [pixels][cs]
  float* red = reinterpret_cast<float*>(smem + l.red);       // [kThreads]
  float* pooled = reinterpret_cast<float*>(smem + l.pooled); // [cs]
  float* gate = reinterpret_cast<float*>(smem + l.gate);     // [cs]
  float* hpart = reinterpret_cast<float*>(smem + l.hpart);   // [cse]
  float* hid = reinterpret_cast<float*>(smem + l.hid);       // [cse]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nranks = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const long long b = blockIdx.y;
  const int c0 = rank * g.cs;
  const int cc = max(0, min(g.cs, g.C - c0));  // this CTA's channels
  const int npix = g.Ho * g.Wo;
  const int s = g.stride;
  const T* xb = x + b * g.Hi * g.Wi * g.C + c0;
  O* ob = out + b * npix * g.C + c0;

  // DW + bias + act of channel cl at output (r, q), taps in registers for
  // K > 0; the same code, in the same tap order, in steps 1 and 6
  auto dw_at = [&](const float (&taps)[K > 0 ? K * K : 1], float bias, int cl, int r,
                   int q) -> float {
    const T* xp = xb + ((long long)r * s * g.Wi + (long long)q * s) * g.C + cl;
    const T* fc = f + c0 + cl;
    float sum = 0.f;
    if (K > 0) {
#pragma unroll
      for (int n = 0; n < K; ++n)
#pragma unroll
        for (int m = 0; m < K; ++m)
          sum = fmaf(to_f(xp[((long long)n * g.Wi + m) * g.C]), taps[n * K + m], sum);
    } else {
      for (int n = 0; n < g.hf; ++n)
        for (int m = 0; m < g.wf; ++m)
          sum = fmaf(to_f(xp[((long long)n * g.Wi + m) * g.C]),
                     to_f(fc[(long long)(n * g.wf + m) * g.C]), sum);
    }
    return activate(sum + bias, g.act_dw);
  };
  auto load_taps = [&](float (&taps)[K > 0 ? K * K : 1], int cl) {
#pragma unroll
    for (int t = 0; t < K * K; ++t) taps[t] = to_f(f[(long long)t * g.C + c0 + cl]);
  };

  // 1-2: DW + bias + act (-> dws when RESIDENT), and the pooled mean of
  // each channel.  A thread owns channel cb0 + lane and the pixels row,
  // row + rows, ...
  for (int cb0 = 0; cb0 < cc; cb0 += kThreads) {
    const int lanes = min(kThreads, cc - cb0);
    const int rows = kThreads / lanes;
    const int lane = tid % lanes;
    const int row = tid / lanes;
    float part = 0.f;
    if (row < rows) {
      const int cl = cb0 + lane;
      float taps[K > 0 ? K * K : 1];
      load_taps(taps, cl);
      const float bias = dwb != nullptr ? to_f(dwb[c0 + cl]) : 0.f;
      int r = row / g.Wo, q = row % g.Wo;
      for (int p = row; p < npix; p += rows) {
        const float v = dw_at(taps, bias, cl, r, q);
        if (RESIDENT) dws[p * g.cs + cl] = v;
        part += v;
        q += rows;
        while (q >= g.Wo) {
          q -= g.Wo;
          ++r;
        }
      }
    }
    red[tid] = part;
    __syncthreads();
    if (tid < lanes) {
      float sum = 0.f;
      for (int rr = 0; rr < rows; ++rr) sum += red[rr * lanes + tid];
      pooled[cb0 + tid] = sum / (float)npix;
    }
    __syncthreads();
  }

  // 3: this slice's share of the reduce FC, one warp per hidden unit
  const int warp = tid / 32, wl = tid % 32;
  for (int j = warp; j < g.cse; j += kWarps) {
    float sum = 0.f;
    for (int cl = wl; cl < cc; cl += 32)
      sum = fmaf(pooled[cl], to_f(w1[(long long)(c0 + cl) * g.cse + j]), sum);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (wl == 0) hpart[j] = sum;
  }

  // 4: the whole hidden vector, from every CTA's partial (distributed
  // shared memory), summed in rank order so that every CTA agrees
  cluster.sync();
  for (int j = tid; j < g.cse; j += kThreads) {
    float sum = 0.f;
    for (int rr = 0; rr < nranks; ++rr) sum += cluster.map_shared_rank(hpart, rr)[j];
    hid[j] = activate(sum + to_f(b1[j]), g.act_se);
  }
  cluster.sync();

  // 5: the gates of this CTA's channels
  for (int cl = tid; cl < cc; cl += kThreads) {
    float sum = 0.f;
    for (int j = 0; j < g.cse; ++j) sum = fmaf(hid[j], to_f(w2[(long long)j * g.C + c0 + cl]), sum);
    gate[cl] = 1.f / (1.f + expf(-(sum + to_f(b2[c0 + cl]))));
  }
  __syncthreads();

  // 6: scale the resident slice (or the DW computed again) and store it
  // once
  for (int cb0 = 0; cb0 < cc; cb0 += kThreads) {
    const int lanes = min(kThreads, cc - cb0);
    const int rows = kThreads / lanes;
    const int lane = tid % lanes;
    const int row = tid / lanes;
    if (row >= rows) continue;
    const int cl = cb0 + lane;
    const float gv = gate[cl];
    if (RESIDENT) {
      for (int p = row; p < npix; p += rows)
        ob[(long long)p * g.C + cl] = from_f<O>(dws[p * g.cs + cl] * gv);
    } else {
      float taps[K > 0 ? K * K : 1];
      load_taps(taps, cl);
      const float bias = dwb != nullptr ? to_f(dwb[c0 + cl]) : 0.f;
      int r = row / g.Wo, q = row % g.Wo;
      for (int p = row; p < npix; p += rows) {
        ob[(long long)p * g.C + cl] = from_f<O>(dw_at(taps, bias, cl, r, q) * gv);
        q += rows;
        while (q >= g.Wo) {
          q -= g.Wo;
          ++r;
        }
      }
    }
  }
}

template <typename T, typename O, int K, bool RESIDENT>
int launch_k(const void* x, const void* f, const void* dwb, const void* w1, const void* b1,
             const void* w2, const void* b2, void* out, int B, int cluster, const Geometry& g,
             cudaStream_t stream) {
  const Layout l = dw_se_layout(g, RESIDENT);
  if (l.total > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = dw_se_kernel<T, O, K, RESIDENT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.total);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, (unsigned)B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = l.total;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // refuse a cluster the card cannot place rather than let it hang or fail
  // later: a launch needs room for at least one whole cluster
  int active = 0;
  e = cudaOccupancyMaxActiveClusters(&active, kern, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (active < 1) return (int)cudaErrorLaunchOutOfResources;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x), static_cast<const T*>(f),
                         static_cast<const T*>(dwb), static_cast<const T*>(w1),
                         static_cast<const T*>(b1), static_cast<const T*>(w2),
                         static_cast<const T*>(b2), static_cast<O*>(out), g, l);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, typename O, bool RESIDENT>
int launch_mode(const void* x, const void* f, const void* dwb, const void* w1, const void* b1,
                const void* w2, const void* b2, void* out, int B, int cluster, const Geometry& g,
                cudaStream_t stream) {
#define REPRO_DW_SE_CASE(KK)                                                              \
  if (g.hf == KK && g.wf == KK)                                                           \
    return launch_k<T, O, KK, RESIDENT>(x, f, dwb, w1, b1, w2, b2, out, B, cluster, g, stream);
  REPRO_DW_SE_CASE(3)
  REPRO_DW_SE_CASE(5)
#undef REPRO_DW_SE_CASE
  return launch_k<T, O, 0, RESIDENT>(x, f, dwb, w1, b1, w2, b2, out, B, cluster, g, stream);
}

template <typename T, typename O>
int launch_io(const void* x, const void* f, const void* dwb, const void* w1, const void* b1,
              const void* w2, const void* b2, void* out, int B, int cluster, int resident,
              const Geometry& g, cudaStream_t stream) {
  if (resident) return launch_mode<T, O, true>(x, f, dwb, w1, b1, w2, b2, out, B, cluster, g, stream);
  return launch_mode<T, O, false>(x, f, dwb, w1, b1, w2, b2, out, B, cluster, g, stream);
}

Geometry make_geometry(int Hi, int Wi, int C, int Ho, int Wo, int hf, int wf, int stride, int cse,
                       int cluster, int act_dw, int act_se) {
  return Geometry{Hi, Wi, C, Ho, Wo, hf, wf, stride, cse, (C + cluster - 1) / cluster,
                  act_dw, act_se};
}

}  // namespace

REPRO_EXPORT_ERROR_STRING(dw_se)

// x (B, Hi, Wi, C); f (hf, wf, C); dw_bias (C) or null; w1 (C, cse);
// b1 (cse); w2 (cse, C); b2 (C): all at the stream type.  out (B, Ho, Wo, C)
// at the store type.  cluster CTAs per image, 1 <= cluster <= 8; resident
// 1 for the resident mode, 0 for the recompute mode.
extern "C" int dw_se_launch(const void* x, const void* f, const void* dw_bias, const void* w1,
                            const void* b1, const void* w2, const void* b2, void* out, int B,
                            int Hi, int Wi, int C, int Ho, int Wo, int hf, int wf, int stride,
                            int cse, int cluster, int resident, int act_dw, int act_se,
                            int in_dtype, int out_dtype, void* stream) {
  if (B < 1 || C < 1 || cse < 1 || cluster < 1 || cluster > 8 || hf < 1 || wf < 1)
    return (int)cudaErrorInvalidValue;
  const Geometry g = make_geometry(Hi, Wi, C, Ho, Wo, hf, wf, stride, cse, cluster, act_dw, act_se);
  REPRO_DISPATCH_IO(in_dtype, out_dtype, launch_io, x, f, dw_bias, w1, b1, w2, b2, out, B,
                    cluster, resident, g, static_cast<cudaStream_t>(stream));
}

// Shared memory one CTA of this geometry and mode needs, in bytes: lets the
// wrapper check the planner's model against the kernel.
extern "C" long long dw_se_smem_bytes(int Ho, int Wo, int C, int cse, int cluster, int resident) {
  if (cluster < 1) return 0;
  return (long long)dw_se_layout(make_geometry(0, 0, C, Ho, Wo, 1, 1, 1, cse, cluster, 0, 0),
                                 resident != 0)
      .total;
}
