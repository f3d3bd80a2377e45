// separable_fused for fp32 streams (the kernel is separable_fused.cuh), and
// the shared-memory count of every stream type.
#include "separable_fused.cuh"

REPRO_SEPARABLE_FUSED_EXPORT(separable_fused, float, repro::kF32)

// The launch separable_fused{,_bf16,_f16}_launch configure for this
// geometry over B images (the bf16 library's tensor-core layout for
// in_dtype bf16), as write_dims' ten numbers in out; cudaErrorInvalidValue
// for an unknown dtype.
extern "C" int separable_fused_launch_dims(int B, int ci, int cs, int cb, int np, int cluster, int slab_h,
                                           int Ho, int Wo, int Hi, int Wi, int hf, int wf, int stride,
                                           int expand, int in_dtype, long long* out) {
  const Geometry g{Hi, Wi, 0, 0, ci, 0, 0, Ho, Wo, hf, wf, stride, slab_h, cb, cs, np, cluster, 0, 0, 0, 0, 0, 0, 0};
  if (in_dtype == repro::kBF16) return repro::write_dims(sep_dims<true>(B, g, expand != 0), out);
  if (in_dtype == repro::kF32 || in_dtype == repro::kF16)
    return repro::write_dims(sep_dims<false>(B, g, expand != 0), out);
  return (int)cudaErrorInvalidValue;
}

// Shared memory one CTA of this geometry needs, in bytes (0 for an unknown
// dtype): lets the wrapper check the planner's model against the kernel.
extern "C" long long separable_fused_smem_bytes(int ci, int cs, int cb, int np, int cluster,
                                                int slab_h, int Wo, int Hi, int Wi, int hf, int wf,
                                                int stride, int expand, int in_dtype) {
  const Geometry g{Hi, Wi, 0, 0, ci, 0, 0, 0, Wo, hf, wf, stride, slab_h, cb, cs, np, cluster, 0, 0, 0, 0, 0, 0, 0};
  if (in_dtype == repro::kBF16) return (long long)sep_layout<true>(g, expand != 0).total;
  if (in_dtype == repro::kF32 || in_dtype == repro::kF16)
    return (long long)sep_layout<false>(g, expand != 0).total;
  return 0;
}
