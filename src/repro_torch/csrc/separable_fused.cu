// separable_fused for fp32 streams (the kernel is separable_fused.cuh), and
// the shared-memory count of every stream type.
#include "separable_fused.cuh"

REPRO_SEPARABLE_FUSED_EXPORT(separable_fused, float, repro::kF32)

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
