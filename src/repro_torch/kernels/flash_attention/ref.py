"""Plain PyTorch versions of GQA attention (causal, optional logit softcap).

* :func:`attention_ref` / :func:`decode_attention_ref` — the quadratic
  oracle of ``repro/kernels/flash_attention/ref.py``: the causal diagonal
  sits at ``skv - sq`` (decode-style alignment).
* :func:`flash_attention_ref` — the kernel's own algorithm: the online
  softmax of ``repro/kernels/flash_attention/kernel.py :: _kernel`` over
  ``block_k``-wide KV blocks, every q row at once, with an explicit
  ``q_offset``.  CPU tensors of the K4 wrapper take it.
"""

from __future__ import annotations

import torch

__all__ = ["attention_ref", "decode_attention_ref", "flash_attention_ref"]


def attention_ref(q, k, v, causal: bool = True, softcap: float = 0.0,
                  kv_len: int | None = None):
    """q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] -> [B, Hq, Sq, D] in q's
    dtype; f32 math.  ``kv_len`` masks keys at and past it."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / (d ** 0.5)
    qf = q.float().reshape(b, hkv, g, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf * scale, k.float())
    if softcap and softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    ki = torch.arange(skv, device=q.device)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        s = torch.where(ki[None, :] <= qi, s, float("-inf"))
    if kv_len is not None and kv_len < skv:
        s = torch.where(ki < kv_len, s, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-20)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)


def decode_attention_ref(q, k, v, kv_len=None, softcap: float = 0.0):
    """Single-step decode: q [B, Hq, 1, D] against the whole KV cache."""
    return attention_ref(q, k, v, causal=True, softcap=softcap, kv_len=kv_len)


def flash_attention_ref(q, k, v, causal: bool = True, softcap: float = 0.0,
                        kv_len: int | None = None, q_offset: int = 0,
                        block_k: int = 128):
    """The FA2 online softmax over KV blocks, as the TPU kernel runs it.

    q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D]; key ``j`` is seen by query
    ``i`` iff ``j < kv_len`` and (not causal or ``j <= i + q_offset``).
    f32 ``(acc, m, l)``; a fully masked row gives 0.  Returns q's dtype.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    kv_len = skv if kv_len is None else kv_len
    scale = 1.0 / (d ** 0.5)
    neg = float("-inf")
    dev = q.device
    qf = q.float().reshape(b, hkv, g, sq, d) * scale
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, hkv, g, sq), neg, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    qpos = torch.arange(sq, device=dev)[:, None] + q_offset
    for k0 in range(0, skv, block_k):
        kb = k[:, :, k0:k0 + block_k].float()
        vb = v[:, :, k0:k0 + block_k].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb)
        if softcap and softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        kpos = torch.arange(k0, k0 + kb.shape[2], device=dev)[None, :]
        mask = kpos < kv_len
        if causal:
            mask = mask & (kpos <= qpos)
        s = torch.where(mask, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(m_new == neg, 0.0, m_new)
        alpha = torch.exp(torch.where(m == neg, neg, m - m_safe))
        p = torch.exp(torch.where(mask, s - m_safe[..., None], neg))
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                                     vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.reshape(b, hq, sq, d).to(q.dtype)
