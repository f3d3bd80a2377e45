"""llama4-maverick-400b-a17b [moe] — MoE 128e top-1, early fusion
(hf:meta-llama/Llama-4-Maverick flavor). 48L d_model=5120 40H (kv=8)
d_ff=8192 vocab=202048. Llama4 signatures: shared expert + top-1 routed
expert on every *other* layer (interleave_moe_layer_step=2 -> ~400B total,
17B active); iRoPE — 3 chunked-attention layers (approximated as SWA 8192;
DESIGN.md) per 1 global NoPE layer; early-fusion multimodal (stub: 64
precomputed fusion embeddings prepended).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    d_head=128,
    sliding_window=8192,
    global_every=4,
    nope_on_global=True,
    rope_theta=5e5,
    fusion_tokens=64,
    moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192, n_shared=1),
    moe_every=2,
)


def smoke_config():
    return ModelConfig(
        name="llama4-maverick-smoke",
        family="moe",
        n_layers=4,
        d_model=48,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=128,
        d_head=16,
        sliding_window=32,
        global_every=4,
        nope_on_global=True,
        fusion_tokens=8,
        moe=MoEConfig(n_experts=4, top_k=1, d_ff_expert=96, n_shared=1,
                      capacity_factor=4.0),
        moe_every=2,
        dtype="float32",
        loss_chunk=16,
        attn_chunk=64,
    )
