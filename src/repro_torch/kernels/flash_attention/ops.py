"""Public GQA attention of the port, forward only.

``attention`` runs K4 (:func:`kernel.flash_attention`) with the causal
diagonal at the *unpadded* ``skv - sq`` — the alignment of the JAX
package's oracle ``attention_ref`` and of its XLA path ``mea_attention``.
(Its Pallas path pads q and k/v to 128-row blocks first and aligns on the
padded lengths, so it differs from those two when ``sq != skv`` and
``sq`` is not a block multiple; at ``sq == skv`` all agree.)
``decode_attention`` is plain PyTorch, as the JAX package's is plain XLA:
one query row against a KV cache is a memory-bound matrix-vector product.

The backward (``_pallas_bwd`` in JAX) belongs to the training slice:
``attention`` raises on inputs that require grad.
"""

from __future__ import annotations

import torch

from .kernel import flash_attention

__all__ = ["attention", "decode_attention"]


def attention(q, k, v, causal: bool = True, softcap: float = 0.0):
    """GQA attention.  q [B, Hq, Sq, D]; k/v [B, Hkv, Skv, D] ->
    [B, Hq, Sq, D]."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "attention has no backward yet (the training slice, ROADMAP "
            "queue 1); call it under torch.no_grad()")
    # the kernel reads [B, H, S, D] rows; projections may hand views
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, softcap=softcap,
                           q_offset=k.shape[2] - q.shape[2])


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
