"""xlstm-125m [ssm] — sLSTM + mLSTM blocks (arXiv:2405.04517).

12L d_model=768 4H (kv=4) d_ff=0 vocab=50304. d_ff=0: xLSTM blocks carry
their own up/down projections (mLSTM pre-up-projection ×2; sLSTM post-FFN
×4/3) — no separate transformer FFN. Blocks alternate [mLSTM, sLSTM]
(slstm_every=2); DESIGN.md notes this 1:1 ratio choice.
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    tie_embeddings=True,
    xlstm=XLSTMConfig(slstm_every=2, proj_factor=2.0, conv_k=4),
)


def smoke_config():
    return ModelConfig(
        name="xlstm-125m-smoke",
        family="ssm",
        n_layers=4,
        d_model=32,
        n_heads=2,
        n_kv_heads=2,
        d_ff=0,
        vocab_size=128,
        tie_embeddings=True,
        xlstm=XLSTMConfig(slstm_every=2, proj_factor=2.0, conv_k=4),
        dtype="float32",
        loss_chunk=16,
        attn_chunk=64,
    )
