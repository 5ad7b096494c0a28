"""grok-1-314b [hf:xai-org/grok-1; unverified]: 64L d_model=6144 48H
(GQA kv=8) vocab=131072, MoE 8 experts top-2 with d_ff=32768 per expert;
attention + output logit soft-capping at 30."""
import torch

from ..models.moe import MoEConfig
from ..models.transformer import TransformerConfig

ARCH_ID = "grok-1-314b"
FAMILY = "lm"


def make_config(dtype=torch.bfloat16, **kw):
    return TransformerConfig(
        name=ARCH_ID, n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=32768, vocab=131072, head_dim=128, qkv_bias=False,
        norm="rmsnorm", act="gelu", rope_theta=10_000.0,
        attn_softcap=30.0, logit_softcap=30.0, tie_embeddings=True,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=32768, act="gelu"),
        dtype=dtype, **kw,
    )


def smoke_config(**kw):
    return TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, norm="rmsnorm", act="gelu",
        attn_softcap=30.0, logit_softcap=30.0, tie_embeddings=True,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=128, act="gelu"), **kw,
    )
