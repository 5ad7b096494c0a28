"""qwen2-7b [arXiv:2407.10671]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — QKV bias, RMSNorm + SwiGLU + RoPE(1e6)."""
import torch

from ..models.transformer import TransformerConfig

ARCH_ID = "qwen2-7b"
FAMILY = "lm"


def make_config(dtype=torch.bfloat16, **kw):
    return TransformerConfig(
        name=ARCH_ID, n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
        d_ff=18944, vocab=152064, head_dim=128, qkv_bias=True,
        norm="rmsnorm", act="silu", rope_theta=1_000_000.0,
        tie_embeddings=False, dtype=dtype, **kw,
    )


def smoke_config(**kw):
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab=256, qkv_bias=True, norm="rmsnorm",
        tie_embeddings=False, **kw,
    )
