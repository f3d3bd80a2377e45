"""hymba-1.5b [hybrid] — parallel attn+mamba heads (arXiv:2411.13676).
32L d_model=1600 25H (kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Hymba signature features: 128 learnable meta tokens (attention sinks) +
sliding-window attention; every layer fuses a SWA attention branch and a
Mamba branch (outputs per-branch normalized then averaged).  Uniform
SWA+meta, as the reference configures it (Hymba's few global layers folded
into the meta-token mechanism), which keeps decode O(window) per token.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    sliding_window=1024,
    meta_tokens=128,
    ssm=SSMConfig(d_state=16, conv_k=4, expand=2),
    tie_embeddings=True,
)


def smoke_config():
    return ModelConfig(
        name="hymba-1.5b-smoke",
        family="hybrid",
        n_layers=2,
        d_model=40,
        n_heads=5,
        n_kv_heads=1,
        d_ff=96,
        vocab_size=128,
        sliding_window=32,
        meta_tokens=8,
        ssm=SSMConfig(d_state=4, conv_k=4, expand=2, chunk=16),
        tie_embeddings=True,
        dtype="float32",
        loss_chunk=16,
        attn_chunk=64,
    )
