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


def dense_init(gen: torch.Generator, shape, in_axis=0, dtype=torch.float32):
    """Truncated-normal (+-2 sigma) fan-in init on ``gen``'s device."""
    axes = (in_axis,) if isinstance(in_axis, int) else tuple(in_axis)
    fan_in = math.prod(shape[a] for a in axes)
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * (1.0 / fan_in) ** 0.5).to(dtype)


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
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def cross_entropy(logits, labels, z_loss: float = 0.0):
    """Mean token cross entropy; logits [..., V] (f32 math), labels int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = (lse - ll).mean()
    if z_loss:
        loss = loss + z_loss * lse.square().mean()
    return loss


ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu's default
    "relu": F.relu,
    "tanh": torch.tanh,
}
