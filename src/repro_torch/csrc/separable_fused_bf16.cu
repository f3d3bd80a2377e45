// separable_fused for bf16 streams, stored at bf16 or fp32 (the kernel is
// separable_fused.cuh: tensor-core products).
#include "separable_fused.cuh"

REPRO_SEPARABLE_FUSED_EXPORT(separable_fused_bf16, __nv_bfloat16, repro::kBF16)
