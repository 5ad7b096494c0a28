"""Shared model-building blocks (``repro/models/common.py``'s, in PyTorch).

Initialisers draw from a ``torch.Generator`` with the reference's
distributions (not its numbers: ``jax.random`` and torch differ); weights
that must match the reference come across with
``transformer.params_from_numpy``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

__all__ = [
    "dense_init",
    "embed_init",
    "rmsnorm",
    "layernorm",
    "apply_rope",
    "rope_freqs",
    "cross_entropy",
    "ACTIVATIONS",
]


def dense_init(gen: torch.Generator | None, shape, in_axis=0,
               dtype=torch.float32, out=None):
    """Truncated-normal (+-2 sigma) fan-in init on ``gen``'s device (with
    ``gen=None``, an empty tensor on the meta device: the shape alone).
    With ``out`` (``shape``, ``dtype``) the values are drawn into it, and
    at most one float32 temporary is made."""
    axes = (in_axis,) if isinstance(in_axis, int) else tuple(in_axis)
    fan_in = math.prod(shape[a] for a in axes)
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    t = (out if out is not None and out.dtype == torch.float32 else
         torch.empty(shape, dtype=torch.float32, device=gen.device))
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    t.mul_((1.0 / fan_in) ** 0.5)
    if out is None:
        return t.to(dtype)
    return t if t is out else out.copy_(t)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32):
    t = torch.randn((vocab, d), generator=gen, device=gen.device)
    return (t * 0.02).to(dtype)


def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layernorm(x, scale, bias=None, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * (1.0 + scale.float())
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # theta stays a Python scalar: a device tensor made from it would be a
    # host-to-device copy that waits for the stream, twice per layer
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x [..., S, D] (split-halves rotation); positions [S] or [B, S]."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)      # [D/2]
    angles = positions[..., None].float() * freqs                 # [.., S, D/2]
    if positions.dim() == 1:        # [S] -> [1, .., 1, S, D/2]
        angles = angles.reshape((1,) * (x.dim() - 2) + angles.shape)
    else:                           # [B, S] -> [B, 1, .., 1, S, D/2]
        b = angles.shape[0]
        angles = angles.reshape((b,) + (1,) * (x.dim() - 3)
                                + angles.shape[1:])
    cos, sin = torch.cos(angles), torch.sin(angles)
    if isinstance(x, DTensor):
        # the tables are the same on every rank; as DTensors they also
        # meet the sharded gradient in the backward
        from torch.distributed.tensor import Replicate
        rep = [Replicate()] * x.device_mesh.ndim
        cos, sin = (DTensor.from_local(t, x.device_mesh, rep,
                                       run_check=False) for t in (cos, sin))
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def cross_entropy(logits, labels, z_loss: float = 0.0):
    """Mean token cross entropy; logits [..., V] (f32 math), labels int."""
    logits = logits.float()
    if isinstance(logits, DTensor):
        lse, ll = _vocab_terms(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = (lse - ll).mean()
    if z_loss:
        loss = loss + z_loss * lse.square().mean()
    return loss


def _vocab_terms(logits, labels):
    """(logsumexp, the label's logit) of a DTensor ``logits`` [..., V],
    each a DTensor laid out as the logits' leading dims, computed on each
    rank's own block: its block's logsumexp and the label's logit (zero
    where another vocab block holds it) are combined over the vocab's mesh
    dims.  Nothing beyond a rank's block of the logits is
    made, and their cotangent keeps their layout (DTensor's own
    ``logsumexp`` gathers the vocab, and a vocab mask's backward splits a
    whole ``[..., V]`` cotangent one mesh dim at a time)."""
    from torch.distributed.tensor import Replicate

    from ..dist.sharding import shard_index
    from ..dist.spmd import pmax, psum, wrap

    mesh, nd = logits.device_mesh, logits.ndim
    vocab = [i for i, p in enumerate(logits.placements)
             if p.is_shard(nd - 1)]
    rest = [Replicate() if i in vocab else p
            for i, p in enumerate(logits.placements)]
    if any(p.is_partial() for p in rest):
        raise ValueError(f"cross entropy of partial logits "
                         f"{logits.placements}")
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    labels = labels.redistribute(mesh, rest)
    local = logits.to_local()
    part = torch.logsumexp(local, dim=-1)          # this vocab block's
    m = pmax(part, mesh, vocab)
    lse = m + torch.log(psum(torch.exp(part - m), mesh, vocab))
    ids = labels.to_local().long()
    if vocab:
        ids = ids - shard_index(mesh, vocab) * local.shape[-1]
    inside = (ids >= 0) & (ids < local.shape[-1])
    picked = torch.gather(local, -1, ids.clamp(0, local.shape[-1] - 1)
                          [..., None])[..., 0]
    ll = psum(torch.where(inside, picked, 0.0), mesh, vocab)
    shape = tuple(labels.shape)
    return wrap(lse, mesh, rest, shape), wrap(ll, mesh, rest, shape)


ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu's default
    "relu": F.relu,
    "tanh": torch.tanh,
}
