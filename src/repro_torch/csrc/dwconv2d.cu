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
// paper's Alg. 4 register reuse).  The tile is dw_tile.cuh's, which
// dw_se.cu's two passes share:
//   * a CTA owns tile_h x tile_w output pixels by cg channels of one image
//     (blocking.py::plan_dwconv2d).  It stages its padded input tile, the
//     (tile_h - 1) * stride + hf rows by (tile_w - 1) * stride + wf columns
//     of cg channels, in shared memory with 16-byte cp.async copies that
//     zero-fill outside the image, and the tile's taps as fp32;
//   * a thread owns one 16-byte channel vector (4 fp32, 8 bf16 or fp16
//     channels; one channel where C or a base is not a whole vector) and a
//     run of kDwRun adjacent output columns of one row.  For each tap row
//     it holds that row's taps in registers and slides over the (kDwRun - 1) *
//     stride + wf inputs of the run's window once, each input feeding every
//     output of the run that it touches (compiled for 3x3, 5x5 and 7x7 at
//     strides 1 and 2); any other filter or stride reads its taps from
//     shared memory per output (the runtime-K path);
//   * fp32 accumulation, each output's taps summed row by row, column by
//     column on both paths, and one store per output at the store type O.
#include "dw_tile.cuh"

namespace {

using namespace repro;

using Geometry = DwGeometry;

// Grid (tiles of the output plane, channel groups, batch): the shared tile
// of dw_tile.cuh, stored as it is.
template <typename T, typename O, int V, int KT, int S>
__global__ void __launch_bounds__(256) dw2d_kernel(const T* __restrict__ x, const T* __restrict__ f,
                                                   O* __restrict__ out, Geometry g, DwLayout l) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem + l.win);          // [hw][ww][cg]
  float* taps = reinterpret_cast<float*>(smem + l.taps);  // [hf * wf][cg]
  const DwTile t = dw_tile(g);
  const long long b = blockIdx.z;
  dw_stage<T, V>(x, f, g, l, win, taps, t, b);
  const DwThread th = dw_thread<V>(g, t);
  if (!th.live) return;
  float acc[kDwRun][V];
  dw_run<T, V, KT, S>(win, taps, g, l, th, acc);
  dw_store<O, V>(out, g, th, b, acc);
}

// The launch of the kernel: dw_tile.cuh's tile, its layout's shared memory.
template <typename T>
LaunchDims dw2d_dims(int B, const Geometry& g, int V) {
  return dw_tile_dims(B, g, V, dw_tile_layout<T>(g).total);
}

template <typename T, typename O, int V, int KT, int S>
int launch_k(const void* x, const void* f, void* out, int B, const Geometry& g, cudaStream_t stream) {
  static bool allowed = false;
  const DwLayout l = dw_tile_layout<T>(g);
  const LaunchDims d = dw2d_dims<T>(B, g, V);
  if (d.smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  auto kern = dw2d_kernel<T, O, V, KT, S>;
  if (!allowed) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  if (d.block[0] < 1 || d.block[0] > 256 || d.grid[0] > 0x7fffffffLL || d.grid[1] > 65535 || d.grid[2] > 65535)
    return (int)cudaErrorInvalidConfiguration;
  kern<<<d.grid_dim(), d.block_dim(), d.smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(f),
                                                        static_cast<O*>(out), g, l);
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
      pad_l < 0 || tile_h < 1 || tile_w < kDwRun || tile_w % kDwRun != 0 || cg < 1 || vec < 1 ||
      cg % vec != 0)
    return (int)cudaErrorInvalidValue;
  const Geometry g{Hi, Wi, C, Ho, Wo, hf, wf, stride, pad_t, pad_l, tile_h, tile_w, cg};
  REPRO_DISPATCH_IO(in_dtype, out_dtype, launch_io, x, f, out, B, g, vec,
                    static_cast<cudaStream_t>(stream));
}

// The launch dwconv2d_launch configures for this geometry (vec channels a
// thread), as write_dims' ten numbers in out; cudaErrorInvalidValue for an
// unknown dtype or a tile that is not whole vectors.
extern "C" int dwconv2d_launch_dims(int B, int C, int Ho, int Wo, int hf, int wf, int stride, int tile_h,
                                    int tile_w, int cg, int vec, int in_dtype, long long* out) {
  if (vec < 1 || cg % vec != 0) return (int)cudaErrorInvalidValue;
  const Geometry g{0, 0, C, Ho, Wo, hf, wf, stride, 0, 0, tile_h, tile_w, cg};
  if (in_dtype == repro::kF32) return repro::write_dims(dw2d_dims<float>(B, g, vec), out);
  if (in_dtype == repro::kBF16 || in_dtype == repro::kF16) return repro::write_dims(dw2d_dims<__half>(B, g, vec), out);
  return (int)cudaErrorInvalidValue;
}

// Shared memory one CTA of this tile needs, in bytes (0 for an unknown
// dtype): lets the wrapper check the planner's model against the kernel.
extern "C" long long dwconv2d_smem_bytes(int tile_h, int tile_w, int cg, int hf, int wf, int stride,
                                         int in_dtype) {
  const Geometry g{0, 0, 0, 0, 0, hf, wf, stride, 0, 0, tile_h, tile_w, cg};
  if (in_dtype == repro::kF32) return (long long)dw_tile_layout<float>(g).total;
  if (in_dtype == repro::kBF16 || in_dtype == repro::kF16) return (long long)dw_tile_layout<__half>(g).total;
  return 0;
}
