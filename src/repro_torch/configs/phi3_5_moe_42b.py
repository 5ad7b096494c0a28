"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct]: 32L
d_model=4096 32H (GQA kv=8) vocab=32064, MoE 16 experts top-2 with
d_ff=6400 per expert; LayerNorm + attention bias (PhiMoE)."""
import torch

from ..models.moe import MoEConfig
from ..models.transformer import TransformerConfig

ARCH_ID = "phi3.5-moe-42b-a6.6b"
FAMILY = "lm"


def make_config(dtype=torch.bfloat16, **kw):
    return TransformerConfig(
        name=ARCH_ID, n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=6400, vocab=32064, head_dim=128, qkv_bias=True,
        norm="layernorm", act="silu", rope_theta=10_000.0,
        tie_embeddings=False,
        moe=MoEConfig(n_experts=16, top_k=2, d_ff=6400, act="silu"),
        dtype=dtype, **kw,
    )


def smoke_config(**kw):
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=96, vocab=256, qkv_bias=True, norm="layernorm",
        tie_embeddings=False,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=96), **kw,
    )
