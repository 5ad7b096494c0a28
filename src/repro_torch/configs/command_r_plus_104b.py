"""command-r-plus-104b [hf:CohereForAI/c4ai-command-r-plus; unverified]:
64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000 — parallel
attn||FFN block, LayerNorm, no biases, tied embeddings."""
import torch

from ..models.transformer import TransformerConfig

ARCH_ID = "command-r-plus-104b"
FAMILY = "lm"


def make_config(dtype=torch.bfloat16, **kw):
    return TransformerConfig(
        name=ARCH_ID, n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
        d_ff=33792, vocab=256000, head_dim=128, qkv_bias=False,
        norm="layernorm", parallel_block=True, act="silu",
        rope_theta=75_000_000.0, tie_embeddings=True, logit_scale=0.0625,
        dtype=dtype, **kw,
    )


def smoke_config(**kw):
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=128, n_heads=8,
        n_kv_heads=2, d_ff=256, vocab=512, head_dim=16, qkv_bias=False,
        norm="layernorm", parallel_block=True, act="silu",
        tie_embeddings=True, logit_scale=0.0625, **kw,
    )
