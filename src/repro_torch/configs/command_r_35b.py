"""command-r-35b [dense] — GQA, no-bias (hf:CohereForAI/c4ai-command-r-v01).
40L d_model=8192 64H (kv=8) d_ff=22528 vocab=256000. Cohere flavor:
LayerNorm (no bias), parallel attention+FFN residual block, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    norm_type="layer",
    parallel_block=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
)


def smoke_config():
    return ModelConfig(
        name="command-r-35b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=128,
        norm_type="layer",
        parallel_block=True,
        tie_embeddings=True,
        dtype="float32",
        loss_chunk=16,
        attn_chunk=64,
    )
