"""smollm-360m [dense] — llama-arch small (hf:HuggingFaceTB/SmolLM-360M).
32L d_model=960 15H (kv=5) d_ff=2560 vocab=49152. Tied embeddings, RMSNorm,
no biases.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    tie_embeddings=True,
)


def smoke_config():
    return ModelConfig(
        name="smollm-360m-smoke",
        family="dense",
        n_layers=2,
        d_model=48,
        n_heads=3,
        n_kv_heads=1,
        d_ff=96,
        vocab_size=128,
        tie_embeddings=True,
        dtype="float32",
        loss_chunk=16,
        attn_chunk=64,
    )
