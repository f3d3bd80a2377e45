// separable_fused for fp16 streams, stored at fp16 or fp32 (the kernel is
// separable_fused.cuh: exact fp32 products on the CUDA cores).
#include "separable_fused.cuh"

REPRO_SEPARABLE_FUSED_EXPORT(separable_fused_f16, __half, repro::kF16)
