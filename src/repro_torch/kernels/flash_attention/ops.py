"""Public GQA attention of the port, with its gradient.

``attention`` runs K4 (:func:`kernel.flash_attention`) with the causal
diagonal at the *unpadded* ``skv - sq`` — the alignment of the JAX
package's oracle ``attention_ref`` and of its XLA path ``mea_attention``.
(Its Pallas path pads q and k/v to 128-row blocks first and aligns on the
padded lengths, so it differs from those two when ``sq != skv`` and
``sq`` is not a block multiple; at ``sq == skv`` all agree.)
Its backward is the JAX package's ``_pallas_bwd``: recompute ``(out,
lse)`` with the chunked forward (``chunk = min(512, skv)``) and run the
two-pass backward, both plain PyTorch in ``xla_flash.py`` as they are XLA
in JAX; K4 runs in the forward only.
``decode_attention`` is plain PyTorch, as the JAX package's is plain XLA:
one query row against a KV cache is a memory-bound matrix-vector product;
it takes no gradient.
"""

from __future__ import annotations

import torch

from .kernel import flash_attention
from .xla_flash import mea_bwd, mea_fwd

__all__ = ["attention", "decode_attention"]


class _Attention(torch.autograd.Function):
    """K4 forward; ``_pallas_bwd``'s backward (mea recompute + mea bwd)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.softcap = causal, softcap
        return flash_attention(q, k, v, causal=causal, softcap=softcap,
                               q_offset=k.shape[2] - q.shape[2])

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        chunk = min(512, k.shape[2])
        with torch.profiler.record_function("repro_torch.attention_bwd"):
            out, lse = mea_fwd(q, k, v, ctx.causal, ctx.softcap, chunk)
            dq, dk, dv = mea_bwd(q, k, v, out, lse, dout, ctx.causal,
                                 ctx.softcap, chunk)
        return dq, dk, dv, None, None


def attention(q, k, v, causal: bool = True, softcap: float = 0.0):
    """GQA attention.  q [B, Hq, Sq, D]; k/v [B, Hkv, Skv, D] ->
    [B, Hq, Sq, D].  Differentiable; the backward raises ``ValueError``
    when ``Skv`` is over 512 and not a multiple of it."""
    # the kernel reads [B, H, S, D] rows; projections may hand views
    return _Attention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal, softcap)


def decode_attention(q, k_cache, v_cache, cache_len, softcap: float = 0.0):
    """Single-token decode.  q [B, Hq, 1, D] against k/v caches
    [B, Hkv, Smax, D] whose first ``cache_len`` positions are live."""
    b, hq, _, d = q.shape
    hkv, smax = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    scale = 1.0 / (d ** 0.5)
    qf = q.float().reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bhkd->bhgk", qf * scale, k_cache.float())
    if softcap and softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    live = torch.arange(smax, device=q.device) < cache_len
    s = torch.where(live, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return o.reshape(b, hq, 1, d).to(q.dtype)
