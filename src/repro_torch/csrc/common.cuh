// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel library exposes a plain C interface (loaded with ctypes by
// repro_torch/kernels/_build.py): each launch function returns
// cudaGetLastError() as an int, through launch_status below, and the Python
// wrapper raises when it is not 0.  Element types are passed as integer codes (DType below); the
// wrappers accept the (stream, store) pairs listed in REPRO_DISPATCH_IO.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// Largest dynamic shared memory a CTA may use on Hopper (227 KB).
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

// Activation codes: 0 none, then repro_torch.kernels.epilogue.ACTIVATIONS
// in order.  Every one maps 0 to 0.  gelu is the tanh approximation
// (jax.nn.gelu's default).
__device__ __forceinline__ float activate(float y, int act) {
  switch (act) {
    case 1:
      return fmaxf(y, 0.f);
    case 2:
      return fminf(fmaxf(y, 0.f), 6.f);
    case 3: {
      const float k = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * y * (1.f + tanhf(k * (y + 0.044715f * y * y * y)));
    }
    case 4:
      return y / (1.f + expf(-y));
    default:
      return y;
  }
}

// V consecutive elements of T, loaded or stored as one aligned vector.
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// One launch's configuration: the grid, the CTA, the thread-block cluster
// (CTAs along x) and the dynamic shared memory.  Each library computes it
// in one function per kernel, which both its launch and its
// <kernel>_launch_dims export call (repro_torch/kernels/gridspec.py models
// the same numbers).
struct LaunchDims {
  long long grid[3];
  int block[3];
  int cluster;
  size_t smem;
  dim3 grid_dim() const { return dim3((unsigned)grid[0], (unsigned)grid[1], (unsigned)grid[2]); }
  dim3 block_dim() const { return dim3((unsigned)block[0], (unsigned)block[1], (unsigned)block[2]); }
};

inline LaunchDims launch_dims(long long gx, long long gy, long long gz, int threads, int cluster, size_t smem) {
  LaunchDims d{};
  d.grid[0] = gx;
  d.grid[1] = gy;
  d.grid[2] = gz;
  d.block[0] = threads;
  d.block[1] = d.block[2] = 1;
  d.cluster = cluster;
  d.smem = smem;
  return d;
}

// d as ten numbers: grid x, y, z; block x, y, z; cluster x, y, z; dynamic
// shared memory.  Returns 0.
inline int write_dims(const LaunchDims& d, long long* out) {
  for (int i = 0; i < 3; ++i) out[i] = d.grid[i];
  for (int i = 0; i < 3; ++i) out[3 + i] = d.block[i];
  out[6] = d.cluster;
  out[7] = out[8] = 1;
  out[9] = (long long)d.smem;
  return 0;
}

// A runtime call that fails (a launch the driver refuses, a shared-memory
// limit it will not raise) also keeps its code as this library's last
// error, which the next launch's cudaGetLastError() would report as its
// own.  Every launch function returns through here, so that a refused
// launch fails only itself.  A sticky error stays: the context is lost.
inline int launch_status(int code) {
  if (code != 0) (void)cudaGetLastError();
  return code;
}

}  // namespace repro

// Calls FN<T, O>(args...) for the (stream, store) dtype pair (in, out):
// fp32 -> fp32, and bf16/fp16 stored either at their own width or widened
// to fp32.  Any other pair is refused.
#define REPRO_DISPATCH_IO(in, out, FN, ...)                                       \
  do {                                                                            \
    using namespace repro;                                                        \
    if ((in) == kF32 && (out) == kF32)                                            \
      return launch_status(FN<float, float>(__VA_ARGS__));                        \
    if ((in) == kBF16 && (out) == kBF16)                                          \
      return launch_status(FN<__nv_bfloat16, __nv_bfloat16>(__VA_ARGS__));        \
    if ((in) == kBF16 && (out) == kF32)                                           \
      return launch_status(FN<__nv_bfloat16, float>(__VA_ARGS__));               \
    if ((in) == kF16 && (out) == kF16)                                            \
      return launch_status(FN<__half, __half>(__VA_ARGS__));                      \
    if ((in) == kF16 && (out) == kF32)                                            \
      return launch_status(FN<__half, float>(__VA_ARGS__));                       \
    return (int)cudaErrorInvalidValue;                                            \
  } while (0)

// Exports <prefix>_error_string(code) so a wrapper can name a failure.
#define REPRO_EXPORT_ERROR_STRING(prefix)                                 \
  extern "C" const char* prefix##_error_string(int code) {                \
    return cudaGetErrorString(static_cast<cudaError_t>(code));            \
  }
