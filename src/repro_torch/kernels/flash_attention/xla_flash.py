"""Memory-efficient attention in plain PyTorch: the chunked forward and the
two-pass backward of ``repro/kernels/flash_attention/xla_flash.py``.

The JAX package computes the backward of its Pallas attention in XLA with
these two functions (``ops._pallas_bwd``), not in a Pallas kernel, so the
port keeps them as plain tensor code: :func:`mea_fwd` recomputes ``(out,
lse)`` over ``chunk``-wide KV blocks with f32 math, and :func:`mea_bwd`
walks the same blocks once more for ``dq``, ``dk`` and ``dv``.  Live
memory is O(Sq * chunk) a (batch, head) in both passes: no S x S score
tensor.  GQA, the causal diagonal at ``skv - sq``, a ``kv_len`` mask and
the logit softcap (grok-1) are supported.  The reference's sharding pins
(``_pin``) stand at its points: on DTensors they lay q, k, v, the output
and the gradients out [batch, heads]; on plain tensors (a rank's local
heads, which ``ops.attention`` hands these functions) and outside a
sharding context they do nothing.
"""

from __future__ import annotations

import torch

from ...dist.sharding import logical_constraint

__all__ = ["mea_fwd", "mea_bwd"]


def _pin(x, *names):
    """Anchor the layout so forward and backward agree ([batch, heads]):
    a seq-split cotangent must not meet head-split attention tensors."""
    return logical_constraint(x, *names)

_NEG = float("-inf")


def _check_chunk(skv: int, chunk: int) -> int:
    if skv % chunk:
        raise ValueError(f"kv length {skv} must divide the chunk size "
                         f"{chunk}")
    return skv // chunk


def _scores(qg, kb, scale: float, softcap: float):
    """q [B, H, G, Sq, D], k [B, H, C, D] -> f32 scores [B, H, G, Sq, C]
    (softcapped when ``softcap`` > 0)."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float() * scale, kb.float())
    if softcap and softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    return s


def _mask(s, kv0: int, chunk: int, sq: int, skv: int, causal: bool,
          kv_len: int):
    kpos = torch.arange(kv0, kv0 + chunk, device=s.device)
    m = kpos[None, :] < kv_len
    if causal:
        qpos = torch.arange(sq, device=s.device)[:, None] + (skv - sq)
        m = m & (kpos[None, :] <= qpos)
    return torch.where(m, s, _NEG)


def mea_fwd(q, k, v, causal: bool = True, softcap: float = 0.0,
            chunk: int = 512, kv_len: int | None = None):
    """q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] -> (out [B, Hq, Sq, D] in
    q's dtype, lse [B, Hkv, G, Sq] f32; -inf on a fully masked row).
    Raises ``ValueError`` unless ``chunk`` divides ``Skv``."""
    q = _pin(q, "batch", "heads", None, None)
    k = _pin(k, "batch", "kv_heads", None, None)
    v = _pin(v, "batch", "kv_heads", None, None)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    kv_len = skv if kv_len is None else kv_len
    scale = 1.0 / (d ** 0.5)
    nc = _check_chunk(skv, chunk)
    qg = q.reshape(b, hkv, g, sq, d)
    dev = q.device
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, hkv, g, sq), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    for c in range(nc):
        kb = k[:, :, c * chunk:(c + 1) * chunk]
        vb = v[:, :, c * chunk:(c + 1) * chunk]
        s = _mask(_scores(qg, kb, scale, softcap), c * chunk, chunk, sq,
                  skv, causal, kv_len)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        alpha = torch.exp(torch.where(torch.isneginf(m), _NEG, m - m_safe))
        p = torch.exp(s - m_safe[..., None])
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                                     vb.float())
        m = m_new
    l_safe = torch.clamp(l, min=1e-20)
    out = (acc / l_safe[..., None]).reshape(b, hq, sq, d).to(q.dtype)
    lse = torch.where(torch.isneginf(m), _NEG, m + torch.log(l_safe))
    return out, lse


def mea_bwd(q, k, v, out, lse, dout, causal: bool = True,
            softcap: float = 0.0, chunk: int = 512,
            kv_len: int | None = None):
    """The two-pass flash backward: (dq, dk, dv) in the dtypes of q, k, v,
    from :func:`mea_fwd`'s ``(out, lse)`` and the cotangent ``dout``.
    ``delta = sum(out * dout)`` reads ``out`` as given (the reference
    passes the recomputed one, in q's dtype)."""
    dout = _pin(dout, "batch", "heads", None, None)
    out = _pin(out, "batch", "heads", None, None)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    kv_len = skv if kv_len is None else kv_len
    scale = 1.0 / (d ** 0.5)
    nc = _check_chunk(skv, chunk)
    qg = q.reshape(b, hkv, g, sq, d).float()
    dog = dout.reshape(b, hkv, g, sq, d).float()
    delta = (out.reshape(b, hkv, g, sq, d).float() * dog).sum(-1)
    dq = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32,
                     device=q.device)
    dks, dvs = [], []
    for c in range(nc):
        kb = k[:, :, c * chunk:(c + 1) * chunk].float()
        vb = v[:, :, c * chunk:(c + 1) * chunk].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg * scale, kb)
        dcap = None
        if softcap and softcap > 0:
            s = softcap * torch.tanh(s / softcap)
            dcap = 1.0 - (s / softcap) ** 2
        s = _mask(s, c * chunk, chunk, sq, skv, causal, kv_len)
        p = torch.exp(s - lse[..., None])
        p = torch.where(torch.isfinite(s), p, 0.0)
        dvs.append(torch.einsum("bhgqk,bhgqd->bhkd", p, dog))
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, vb)
        ds = p * (dp - delta[..., None])
        if dcap is not None:
            ds = ds * dcap
        dq = dq + torch.einsum("bhgqk,bhkd->bhgqd", ds, kb) * scale
        dks.append(torch.einsum("bhgqk,bhgqd->bhkd", ds, qg) * scale)
    return (_pin(dq.reshape(b, hq, sq, d).to(q.dtype), "batch", "heads",
                 None, None),
            _pin(torch.cat(dks, dim=2).to(k.dtype), "batch", "kv_heads",
                 None, None),
            _pin(torch.cat(dvs, dim=2).to(v.dtype), "batch", "kv_heads",
                 None, None))
