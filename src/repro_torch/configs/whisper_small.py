"""whisper-small [audio] — enc-dec, conv frontend stubbed (arXiv:2212.04356).
12L (decoder) + 12L encoder, d_model=768 12H (kv=12) d_ff=3072 vocab=51865.
The mel/conv frontend is a STUB: input_specs provides precomputed frame
embeddings (B, 1500, d). LayerNorm; RoPE replaces the decoder's learned
positional embedding.  Counterpart of ``repro/configs/whisper_small.py``,
field for field.  Like the reference's, the model's LayerNorms carry a
scale and no bias (``init_norm(cfg.norm_type, d)``), and its encoder's
self-attention applies RoPE at the frame positions.
"""
from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    norm_type="layer",
    qkv_bias=True,
    tie_embeddings=True,
    encdec=EncDecConfig(n_enc_layers=12, enc_seq=1500),
)


def smoke_config():
    return ModelConfig(
        name="whisper-small-smoke",
        family="audio",
        n_layers=2,
        d_model=48,
        n_heads=4,
        n_kv_heads=4,
        d_ff=96,
        vocab_size=128,
        norm_type="layer",
        qkv_bias=True,
        tie_embeddings=True,
        encdec=EncDecConfig(n_enc_layers=2, enc_seq=24),
        dtype="float32",
        loss_chunk=16,
        attn_chunk=64,
    )
