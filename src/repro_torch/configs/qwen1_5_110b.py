"""qwen1.5-110b [dense] — QKV bias (hf:Qwen/Qwen1.5-110B flavor).
80L d_model=8192 64H (kv=8) d_ff=49152 vocab=152064. Untied embeddings,
QKV bias, RMSNorm, theta=1e6.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
)


def smoke_config():
    return ModelConfig(
        name="qwen1.5-110b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=192,
        vocab_size=128,
        qkv_bias=True,
        rope_theta=1e6,
        dtype="float32",
        loss_chunk=16,
        attn_chunk=64,
    )
