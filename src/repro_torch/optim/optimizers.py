"""Optimizers (the port of ``repro/optim/optimizers.py``): AdamW,
Adafactor, SGD-momentum, schedules, global-norm clipping, gradient
accumulation and int8 gradient compression with error feedback.

The functional form of the reference is kept: parameters, gradients and
states are nested dicts of tensors (the JAX package's trees), and
``update(grads, state, params, step) -> (updates, state)`` returns new
tensors.  A leaf is the reference's leaf: for an LM, the ``[L, ...]``
stack of one name's layer tensors (``Transformer.tree``), so
Adafactor factors a stacked norm scale and clips each update by its RMS
over all L layers, as JAX does on its scanned parameters.  The update
math is elementwise tensor code with reductions: plain PyTorch, as it is
plain XLA in the reference.

DTensor leaves (a sharded model): the states are DTensors laid out as
their parameters (an Adafactor row or column moment drops the reduced
dim's split), every reduction is DTensor's, so Adafactor's factored
moments, its update clipping and the global norm are the whole tensor's,
not a shard's, and each update comes back in its parameter's layout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch
from torch.distributed.tensor import DTensor

__all__ = [
    "Optimizer", "adamw", "adafactor", "sgd", "cosine_schedule",
    "linear_warmup", "clip_by_global_norm", "global_norm",
    "compress_int8", "decompress_int8", "GradAccumulator", "tree_map",
    "tree_leaves", "zeros_f32", "laid_out_as",
]


class Optimizer(NamedTuple):
    init: Callable    # params -> state
    update: Callable  # (grads, state, params, step) -> (updates, state)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree``, nested dicts and lists (a GNN's
    layer list); ``rest`` are trees of the same structure down to
    ``tree``'s leaves (their nodes there may be dicts, as an Adafactor
    state's are)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts and lists, in JAX's flatten order (dict
    keys sorted, list items in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def zeros_f32(p, drop: int | None = None):
    """float32 zeros shaped as ``p`` or, with ``drop``, as ``p`` without
    that dim; for a DTensor ``p`` a DTensor laid out as ``p`` (a split of
    the dropped dim becomes a replica)."""
    shape = tuple(p.shape)
    if drop is not None:
        drop %= len(shape)
        shape = shape[:drop] + shape[drop + 1:]
    if not isinstance(p, DTensor):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    from torch.distributed.tensor import Replicate, Shard, zeros

    pl = []
    for q in p.placements:
        if drop is not None and q.is_shard() and q.dim >= drop:
            q = Replicate() if q.dim == drop else Shard(q.dim - 1)
        pl.append(q)
    return zeros(shape, dtype=torch.float32, device_mesh=p.device_mesh,
                 placements=pl)


def laid_out_as(x, like):
    """``x`` redistributed to the layout of ``like`` when both are
    DTensors (a reduction may leave a partial or a replica); else ``x``."""
    if isinstance(x, DTensor) and isinstance(like, DTensor) and \
            tuple(x.placements) != tuple(like.placements):
        return x.redistribute(like.device_mesh, like.placements)
    return x


def global_norm(tree):
    return torch.sqrt(sum(x.float().square().sum()
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to a global norm of at most ``max_norm``, the norm);
    each leaf keeps its dtype (an f32 scale would double grad memory)."""
    g = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), g


def cosine_schedule(base_lr: float, total_steps: int, warmup: int = 100,
                    final_frac: float = 0.1):
    def lr(step):
        step = float(step)
        warm = min(1.0, step / max(warmup, 1))
        prog = min(max((step - warmup) / max(total_steps - warmup, 1), 0.0),
                   1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi
                                                                  * prog))
        return base_lr * warm * cos
    return lr


def linear_warmup(base_lr: float, warmup: int = 100):
    return lambda step: base_lr * min(1.0, float(step) / max(warmup, 1))


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


def adamw(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0):
    """lr may be a float or a schedule fn(step)."""
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"mu": tree_map(zeros_f32, params),
                "nu": tree_map(zeros_f32, params)}

    def update(grads, state, params, step):
        t = float(step) + 1.0
        lr_t = lr_fn(step)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g.float().square(),
                      state["nu"], grads)

        def upd(p, m, v):
            u = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return laid_out_as((-lr_t * u).to(p.dtype), p)

        return tree_map(upd, params, mu, nu), {"mu": mu, "nu": nu}

    return Optimizer(init, update)


def adafactor(lr=1e-2, decay=0.8, eps=1e-30, clip_threshold=1.0):
    """Factored second-moment optimizer (Shazeer & Stern): O(n + m) state
    for an [..., n, m] leaf (``vr [..., n]``, ``vc [..., m]``), a full
    ``v`` for a vector."""
    lr_fn = _lr_fn(lr)

    def init(params):
        def st(p):
            if p.dim() >= 2:
                return {"vr": zeros_f32(p, -1), "vc": zeros_f32(p, -2)}
            return {"v": zeros_f32(p)}
        return tree_map(st, params)

    def update(grads, state, params, step):
        t = float(step) + 1.0
        beta = 1.0 - t ** (-decay)
        lr_t = lr_fn(step)

        def upd(p, g, s):
            gf = g.float()
            g2 = gf.square() + eps
            if p.dim() >= 2:
                # each factor in its state's layout before their outer
                # product, which is then laid out as the leaf (a partial
                # factor would make the product whole on every rank)
                vr = laid_out_as(beta * s["vr"] + (1 - beta) * g2.mean(-1),
                                 s["vr"])
                vc = laid_out_as(beta * s["vc"] + (1 - beta) * g2.mean(-2),
                                 s["vc"])
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(-1)[..., None, None],
                                       min=eps))
                u = gf * torch.rsqrt(denom + eps)
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = gf * torch.rsqrt(v + eps)
                new_s = {"v": v}
            rms = torch.sqrt(u.square().mean() + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return laid_out_as((-lr_t * u).to(p.dtype), p), new_s

        out = tree_map(upd, params, grads, state)   # (update, state) leaves
        return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)

    return Optimizer(init, update)


def sgd(lr=1e-2, momentum=0.9, nesterov=False):
    lr_fn = _lr_fn(lr)

    def init(params):
        return tree_map(zeros_f32, params)

    def update(grads, state, params, step):
        lr_t = lr_fn(step)
        mom = tree_map(lambda m, g: momentum * m + g.float(), state, grads)
        upd = (tree_map(lambda m, g: momentum * m + g.float(), mom, grads)
               if nesterov else mom)
        return tree_map(lambda p, u: (-lr_t * u).to(p.dtype), params,
                        upd), mom

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback
# ---------------------------------------------------------------------------

def compress_int8(g, err):
    """Quantize g + err to int8 with a per-tensor scale; returns (q, scale,
    new_err).  Error feedback keeps the optimizer unbiased over time."""
    gf = g.float() + err
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_err = gf - q.float() * scale
    return q, scale, new_err


def decompress_int8(q, scale):
    return q.float() * scale


@dataclasses.dataclass
class GradAccumulator:
    """Micro-batch gradient accumulation (a host-side loop adds each
    micro-batch's gradients)."""
    n_micro: int

    def init(self, params):
        return tree_map(zeros_f32, params)

    def add(self, acc, grads):
        return tree_map(lambda a, g: a + g.float() / self.n_micro, acc,
                        grads)
