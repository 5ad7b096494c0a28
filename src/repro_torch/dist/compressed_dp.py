"""Compressed data-parallel all-reduce: int8 gradients + error feedback
(the port of ``repro/dist/compressed_dp.py``).

4x fewer bytes on the data-parallel axis; the quantization residual is
carried in an error state and re-added next step, so the optimizer stays
unbiased over time.  The reference's ``shard_map`` body becomes per-rank
code: a ``MAX`` all-reduce gives the common scale, a ``SUM`` all-reduce of
the int8 values widened to int32 gives the total.  Builds on the
optimizer's ``decompress_int8``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..optim.optimizers import decompress_int8, tree_map

__all__ = ["compressed_psum_mean", "init_error_state"]


def init_error_state(params):
    """Zero residual per gradient leaf (f32 regardless of param dtype)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _compress_leaf(g, err, group):
    gf = g.float() + err
    # common scale across the group so every rank dequantizes the sum
    # identically (bitwise-equal means on all ranks)
    scale = torch.clamp(gf.abs().max(), min=1e-12)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    scale = scale / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_err = gf - decompress_int8(q, scale)
    return q, scale, new_err


def compressed_psum_mean(grads, err_state, group, n_shards: int):
    """Per-leaf int8-quantized mean over the ranks of ``group``.

    grads / err_state: matching trees of this rank's gradient
    contributions and error-feedback residuals.  Returns (mean tree, new
    err tree); every rank of ``group`` calls it."""
    def leaf(g, e):
        q, scale, ne = _compress_leaf(g, e, group)
        total = q.to(torch.int32)
        dist.all_reduce(total, group=group)
        return decompress_int8(total, scale) / n_shards, ne

    out = tree_map(leaf, grads, err_state)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)
