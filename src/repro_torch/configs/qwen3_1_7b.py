"""qwen3-1.7b [dense] — qk_norm, GQA (hf:Qwen/Qwen3-1.7B flavor).
28L d_model=2048 16H (kv=8) d_ff=6144 vocab=151936. head_dim=128, qk-norm,
no QKV bias (dropped in qwen3), theta=1e6, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab_size=151936,
    d_head=128,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
)


def smoke_config():
    return ModelConfig(
        name="qwen3-1.7b-smoke",
        family="dense",
        n_layers=2,
        d_model=48,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=128,
        d_head=16,
        qk_norm=True,
        rope_theta=1e6,
        tie_embeddings=True,
        dtype="float32",
        loss_chunk=16,
        attn_chunk=64,
    )
