"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 (hf:Qwen/Qwen3-235B-A22B
flavor). 94L d_model=4096 64H (kv=4) d_ff=1536 (per expert) vocab=151936.
qk-norm, head_dim=128, no shared expert, normalized top-k router weights.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    d_head=128,
    qk_norm=True,
    rope_theta=1e6,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536, n_shared=0),
)


def smoke_config():
    return ModelConfig(
        name="qwen3-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=48,
        n_heads=4,
        n_kv_heads=2,
        d_ff=64,
        vocab_size=128,
        d_head=16,
        qk_norm=True,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64, n_shared=0,
                      capacity_factor=4.0),
        dtype="float32",
        loss_chunk=16,
        attn_chunk=64,
    )
