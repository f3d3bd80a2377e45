"""internvl2-1b [vlm] — InternViT frontend (stub) + Qwen2-0.5B-family LM
(arXiv:2404.16821). 24L d_model=896 14H (kv=2) d_ff=4864 vocab=151655.
Frontend: input_specs provides 256 precomputed patch embeddings, prepended
(early fusion). Qwen2 LM flavor: QKV bias, RMSNorm, theta=1e6, tied.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
    fusion_tokens=256,
)


def smoke_config():
    return ModelConfig(
        name="internvl2-1b-smoke",
        family="vlm",
        n_layers=2,
        d_model=48,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=128,
        qkv_bias=True,
        rope_theta=1e6,
        tie_embeddings=True,
        fusion_tokens=8,
        dtype="float32",
        loss_chunk=16,
        attn_chunk=64,
    )
