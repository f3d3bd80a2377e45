// Depthwise 2-D convolution, NHWC.  The kernel reads x as it lies and
// applies the zero padding itself (pad_t rows above, pad_l columns left;
// whatever lies past the input's far edges is zero too), so the wrapper's
// VALID geometry is pad 0.
//
// Replaces repro/kernels/dwconv2d.py::dwconv2d_pallas (body _dw2d_kernel).
//
// What bounds it on the H100: bytes.  At the main-path shapes (3x3 taps,
// 112x112x32 s1 .. 7x7x1024) it does 9 multiply-adds per input element,
// about 2-4.5 operations per byte in fp32 and twice that in bf16, far
// below the card's ~20 fp32 operations per byte of device memory.  So the
// design moves every byte of device memory once, in 16-byte transactions,
// and serves the Hf*Wf/stride^2 re-reads of each input from on chip (the
// paper's Alg. 4 register reuse):
//   * a CTA owns tile_h x tile_w output pixels by cg channels of one image
//     (blocking.py::plan_dwconv2d).  It stages its padded input tile, the
//     (tile_h - 1) * stride + hf rows by (tile_w - 1) * stride + wf columns
//     of cg channels, in shared memory with 16-byte cp.async copies that
//     zero-fill outside the image, and the tile's taps as fp32;
//   * a thread owns one 16-byte channel vector (4 fp32, 8 bf16 or fp16
//     channels; one channel where C or a base is not a whole vector) and a
//     run of kRun adjacent output columns of one row.  For each tap row it
//     holds that row's taps in registers and slides over the (kRun - 1) *
//     stride + wf inputs of the run's window once, each input feeding every
//     output of the run that it touches (compiled for 3x3, 5x5 and 7x7 at
//     strides 1 and 2); any other filter or stride reads its taps from
//     shared memory per output (the runtime-K path);
//   * fp32 accumulation, each output's taps summed row by row, column by
//     column on both paths, and one store per output at the store type O.
#include "tile_gemm.cuh"

namespace {

using namespace repro;

// Output columns a thread computes from one sliding register window
// (blocking.py::DW_RUN).
constexpr int kRun = 4;

struct Geometry {
  int Hi, Wi, C, Ho, Wo, hf, wf, stride, pad_t, pad_l, tile_h, tile_w, cg;
};

// Shared-memory layout of one CTA; repro_torch/kernels/blocking.py
// ::dwconv2d_smem_bytes models the same regions.
struct Layout {
  size_t win, taps, total;
  int hw, ww;
};

template <typename T>
Layout dw_layout(const Geometry& g) {
  Layout l{};
  l.hw = (g.tile_h - 1) * g.stride + g.hf;
  l.ww = (g.tile_w - 1) * g.stride + g.wf;
  size_t off = 0;
  l.win = off; off += align16((size_t)l.hw * l.ww * g.cg * sizeof(T));
  l.taps = off; off += align16((size_t)g.hf * g.wf * g.cg * 4);
  l.total = off;
  return l;
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

// Grid (tiles of the output plane, channel groups, batch).
template <typename T, typename O, int V, int KT, int S>
__global__ void __launch_bounds__(256) dw2d_kernel(const T* __restrict__ x, const T* __restrict__ f,
                                                   O* __restrict__ out, Geometry g, Layout l) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem + l.win);          // [hw][ww][cg]
  float* taps = reinterpret_cast<float*>(smem + l.taps);  // [hf * wf][cg]
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int s = g.stride;
  const int tiles_w = (g.Wo + g.tile_w - 1) / g.tile_w;
  const int oh0 = blockIdx.x / tiles_w * g.tile_h;
  const int ow0 = blockIdx.x % tiles_w * g.tile_w;
  const int c0 = blockIdx.y * g.cg;
  const long long b = blockIdx.z;
  const int nv = g.cg / V;  // channel vectors of a tile pixel
  const int ih0 = oh0 * s - g.pad_t, iw0 = ow0 * s - g.pad_l;

  // the padded input tile: zeros outside the image and past C
  const int nwin = l.hw * l.ww;
  for (int e = tid; e < nwin * nv; e += nthr) {
    const int p = e / nv, v = e - p * nv;
    const int r = p / l.ww, q = p - r * l.ww;
    const int ih = ih0 + r, iw = iw0 + q, ch = c0 + v * V;
    const bool ok = ih >= 0 && ih < g.Hi && iw >= 0 && iw < g.Wi && ch < g.C;
    const T* src = x + ((b * g.Hi + ih) * g.Wi + iw) * g.C + ch;
    if constexpr (V > 1) {
      cp16(win + (size_t)e * V, ok ? src : x, ok);
    } else {
      win[e] = ok ? *src : from_f<T>(0.f);
    }
  }
  for (int e = tid; e < g.hf * g.wf * g.cg; e += nthr) {
    const int t = e / g.cg, j = e - t * g.cg;
    taps[e] = c0 + j < g.C ? to_f(f[(long long)t * g.C + c0 + j]) : 0.f;
  }
  if constexpr (V > 1) cp_wait_all();
  __syncthreads();

  // this thread: channel vector v, output row oh, columns ow .. ow + kRun - 1
  const int runs = g.tile_w / kRun;
  const int v = tid % nv, rr = tid / nv;
  const int oh = oh0 + rr / runs;
  const int ow = ow0 + rr % runs * kRun;
  const int ch = c0 + v * V;
  if (rr / runs >= g.tile_h || oh >= g.Ho || ow >= g.Wo || ch >= g.C) return;
  const T* src = win + ((size_t)(rr / runs) * s * l.ww + (size_t)(rr % runs) * kRun * s) * g.cg + v * V;
  const float* tv = taps + v * V;

  float acc[kRun][V];
#pragma unroll
  for (int u = 0; u < kRun; ++u)
#pragma unroll
    for (int c = 0; c < V; ++c) acc[u][c] = 0.f;

  if constexpr (KT > 0) {
    constexpr int kIn = (kRun - 1) * S + KT;
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
        for (int u = 0; u < kRun; ++u) {
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
    for (int u = 0; u < kRun; ++u) {
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

  O* o = out + ((b * g.Ho + oh) * g.Wo + ow) * g.C + ch;
#pragma unroll
  for (int u = 0; u < kRun; ++u) {
    if (ow + u >= g.Wo) break;
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

template <typename T, typename O, int V, int KT, int S>
int launch_k(const void* x, const void* f, void* out, int B, const Geometry& g, cudaStream_t stream) {
  static bool allowed = false;
  const Layout l = dw_layout<T>(g);
  if (l.total > (size_t)kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  auto kern = dw2d_kernel<T, O, V, KT, S>;
  if (!allowed) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  const int threads = g.cg / V * g.tile_h * (g.tile_w / kRun);
  const long long tiles = (long long)((g.Ho + g.tile_h - 1) / g.tile_h) * ((g.Wo + g.tile_w - 1) / g.tile_w);
  const int groups = (g.C + g.cg - 1) / g.cg;
  if (threads < 1 || threads > 256 || tiles > 0x7fffffffLL || groups > 65535 || B > 65535)
    return (int)cudaErrorInvalidConfiguration;
  kern<<<dim3((unsigned)tiles, (unsigned)groups, (unsigned)B), threads, l.total, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(f), static_cast<O*>(out), g, l);
  return (int)cudaGetLastError();
}

template <typename T, typename O, int V>
int launch_v(const void* x, const void* f, void* out, int B, const Geometry& g, cudaStream_t stream) {
  const bool square = g.hf == g.wf;
#define REPRO_DW_CASE(KK, SS)                                 \
  if (square && g.hf == KK && g.stride == SS)                 \
    return launch_k<T, O, V, KK, SS>(x, f, out, B, g, stream);
  REPRO_DW_CASE(3, 1)
  REPRO_DW_CASE(3, 2)
  REPRO_DW_CASE(5, 1)
  REPRO_DW_CASE(5, 2)
  REPRO_DW_CASE(7, 1)
  REPRO_DW_CASE(7, 2)
#undef REPRO_DW_CASE
  return launch_k<T, O, V, 0, 0>(x, f, out, B, g, stream);
}

template <typename T, typename O>
int launch_io(const void* x, const void* f, void* out, int B, const Geometry& g, int vec,
              cudaStream_t stream) {
  constexpr int VV = 16 / sizeof(T);
  if (vec == VV) {
    auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
    if (g.C % VV != 0 || g.cg % VV != 0 || !aligned(x) || !aligned(f) || !aligned(out))
      return (int)cudaErrorInvalidValue;
    return launch_v<T, O, VV>(x, f, out, B, g, stream);
  }
  if (vec == 1) return launch_v<T, O, 1>(x, f, out, B, g, stream);
  return (int)cudaErrorInvalidValue;
}

Geometry make_geometry(int Hi, int Wi, int C, int Ho, int Wo, int hf, int wf, int stride, int pad_t,
                       int pad_l, int tile_h, int tile_w, int cg) {
  return Geometry{Hi, Wi, C, Ho, Wo, hf, wf, stride, pad_t, pad_l, tile_h, tile_w, cg};
}

}  // namespace

REPRO_EXPORT_ERROR_STRING(dwconv2d)

// x (B, Hi, Wi, C), read as zero-padded by pad_t rows above and pad_l
// columns left (and zeros past its far edges) to give an (Ho, Wo) VALID
// output, and f (hf, wf, C), both at the stream type; out (B, Ho, Wo, C) at
// the store type.  A CTA takes tile_h x tile_w outputs (tile_w a multiple
// of 4) by cg channels, vec (1, or a 16-byte vector) channels a thread.
extern "C" int dwconv2d_launch(const void* x, const void* f, void* out, int B, int Hi, int Wi,
                               int C, int Ho, int Wo, int hf, int wf, int stride, int pad_t,
                               int pad_l, int tile_h, int tile_w, int cg, int vec, int in_dtype,
                               int out_dtype, void* stream) {
  if (B < 1 || C < 1 || Ho < 1 || Wo < 1 || hf < 1 || wf < 1 || stride < 1 || pad_t < 0 ||
      pad_l < 0 || tile_h < 1 || tile_w < kRun || tile_w % kRun != 0 || cg < 1 || vec < 1 ||
      cg % vec != 0)
    return (int)cudaErrorInvalidValue;
  const Geometry g = make_geometry(Hi, Wi, C, Ho, Wo, hf, wf, stride, pad_t, pad_l, tile_h, tile_w, cg);
  REPRO_DISPATCH_IO(in_dtype, out_dtype, launch_io, x, f, out, B, g, vec,
                    static_cast<cudaStream_t>(stream));
}

// Shared memory one CTA of this tile needs, in bytes (0 for an unknown
// dtype): lets the wrapper check the planner's model against the kernel.
extern "C" long long dwconv2d_smem_bytes(int tile_h, int tile_w, int cg, int hf, int wf, int stride,
                                         int in_dtype) {
  const Geometry g = make_geometry(0, 0, 0, 0, 0, hf, wf, stride, 0, 0, tile_h, tile_w, cg);
  if (in_dtype == repro::kF32) return (long long)dw_layout<float>(g).total;
  if (in_dtype == repro::kBF16 || in_dtype == repro::kF16) return (long long)dw_layout<__half>(g).total;
  return 0;
}
