"""tinyllama-1.1b [arXiv:2401.02385]: 22L d_model=2048 32H (GQA kv=4)
d_ff=5632 vocab=32000 — llama2 architecture, RMSNorm + SwiGLU + RoPE."""
import torch

from ..models.transformer import TransformerConfig

ARCH_ID = "tinyllama-1.1b"
FAMILY = "lm"


def make_config(dtype=torch.bfloat16, **kw):
    return TransformerConfig(
        name=ARCH_ID, n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
        d_ff=5632, vocab=32000, head_dim=64, qkv_bias=False, norm="rmsnorm",
        act="silu", rope_theta=10_000.0, tie_embeddings=False, dtype=dtype,
        **kw,
    )


def smoke_config(**kw):
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab=256, norm="rmsnorm",
        tie_embeddings=False, **kw,
    )
