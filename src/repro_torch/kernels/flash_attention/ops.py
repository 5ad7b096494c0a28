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

Both take DTensors (a sharded LM under ``dist.sharding``), laid out
[batch, heads] over the mesh: ``attention`` runs K4 and its backward on
each rank's local heads through ``local_map``; where the KV heads do not
divide the mesh (replicated while q's heads are sharded) each rank picks
the KV heads of its own q-head groups, and their gradients are partial
sums.  ``decode_attention`` also takes a cache whose positions are
sharded: the softmax then combines the shards' maxima and sums with
all-reduces.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from ...dist.sharding import shard_index
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
    when ``Skv`` is over 512 and not a multiple of it.  DTensors run per
    rank on their local heads (:func:`_attention_sharded`)."""
    if any(isinstance(t, DTensor) for t in (q, k, v)):
        return _attention_sharded(q, k, v, causal, softcap)
    # the kernel reads [B, H, S, D] rows; projections may hand views
    return _Attention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal, softcap)


def _head_layout(mesh, qp, kp, hq: int, hkv: int):
    """(KV grad placements, the local KV head slice or None) of q's
    placements ``qp`` and a KV tensor's ``kp``, laid out [batch, heads] on
    ``mesh``.  Raises ``ValueError`` for a layout the per-rank kernel
    cannot run: a partial, a sharded sequence or head dim, batches split
    differently, or KV heads split over other mesh dims than q's."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    grad, q_dims, replicated = [], [], []
    for i, (pq, pk) in enumerate(zip(qp, kp)):
        for p in (pq, pk):
            if not (isinstance(p, Replicate) or
                    (isinstance(p, Shard) and p.dim in (0, 1))):
                raise ValueError(f"attention shards batch and heads only; "
                                 f"got q {qp}, k/v {kp}")
        if pq == Shard(0) or pk == Shard(0):
            if pq != pk:
                raise ValueError(f"q and k/v split the batch differently: "
                                 f"{qp}, {kp}")
        elif pq == Shard(1):
            q_dims.append(i)
            if pk == Replicate():
                replicated.append(i)
        elif pk == Shard(1):
            raise ValueError(f"k/v heads split where q's are not: "
                             f"{qp}, {kp}")
        grad.append(Partial() if i in replicated else pk)
    if not replicated:
        return tuple(grad), None
    if replicated != q_dims:
        raise ValueError(f"k/v heads split over some of q's mesh dims: "
                         f"{qp}, {kp}")
    g = hq // hkv
    n = 1
    for i in q_dims:
        n *= mesh.size(i)
    hq_loc = hq // n
    a = shard_index(mesh, q_dims) * hq_loc
    if hq_loc % g == 0:
        sel = (a // g, (a + hq_loc) // g)
    elif g % hq_loc == 0:
        sel = (a // g, a // g + 1)
    else:
        raise ValueError(f"{hq_loc} local q heads straddle GQA groups of "
                         f"{g}")
    return tuple(grad), sel


def _attention_sharded(q, k, v, causal, softcap):
    """``attention`` on DTensors: K4 forward and the plain backward on each
    rank's local [batch, heads] block (``local_map``); the output has q's
    placements."""
    from torch.distributed.tensor.experimental import local_map

    if not all(isinstance(t, DTensor) for t in (q, k, v)):
        raise TypeError("attention takes q, k and v all DTensors or all "
                        "plain tensors")
    if tuple(k.placements) != tuple(v.placements):
        raise ValueError(f"k and v are laid out differently: "
                         f"{k.placements}, {v.placements}")
    if k.device_mesh != q.device_mesh or v.device_mesh != q.device_mesh:
        raise ValueError("q and k/v lie on different meshes")
    kv_grad, sel = _head_layout(q.device_mesh, q.placements, k.placements,
                                q.shape[1], k.shape[1])

    def local(ql, kl, vl):
        if sel is not None:
            kl, vl = kl[:, sel[0]:sel[1]], vl[:, sel[0]:sel[1]]
        return _Attention.apply(ql.contiguous(), kl.contiguous(),
                                vl.contiguous(), causal, softcap)

    # a list of placements is one output's (a tuple would be several)
    fn = local_map(local, out_placements=list(q.placements),
                   in_placements=(list(q.placements), list(k.placements),
                                  list(v.placements)),
                   in_grad_placements=(list(q.placements), list(kv_grad),
                                       list(kv_grad)),
                   device_mesh=q.device_mesh)
    return fn(q, k, v)


def decode_attention(q, k_cache, v_cache, cache_len, softcap: float = 0.0):
    """Single-token decode.  q [B, Hq, 1, D] against k/v caches
    [B, Hkv, Smax, D] whose first ``cache_len`` positions are live.
    DTensors: :func:`_decode_sharded`."""
    if any(isinstance(t, DTensor) for t in (q, k_cache, v_cache)):
        return _decode_sharded(q, k_cache, v_cache, cache_len, softcap)
    return _decode_local(q, k_cache, v_cache, cache_len, softcap)


def _decode_sharded(q, k_cache, v_cache, cache_len, softcap):
    """``decode_attention`` on DTensors.  The cache may split batch, KV
    heads and positions over the mesh; q's heads are replicated over the
    mesh dims that split positions.  Each rank scores its own positions;
    where positions are split, the softmax's maxima and sums and the
    weighted values are all-reduced over those mesh dims (an unsplit
    cache runs ``_decode_local`` on the local block as it is)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    if not all(isinstance(t, DTensor) for t in (q, k_cache, v_cache)):
        raise TypeError("decode_attention takes q and the caches all "
                        "DTensors or all plain tensors")
    if tuple(k_cache.placements) != tuple(v_cache.placements):
        raise ValueError(f"the k and v caches are laid out differently: "
                         f"{k_cache.placements}, {v_cache.placements}")
    mesh = q.device_mesh
    if k_cache.device_mesh != mesh or v_cache.device_mesh != mesh:
        raise ValueError("q and the caches lie on different meshes")
    seq_dims = [i for i, p in enumerate(k_cache.placements)
                if p == Shard(2)]
    want = tuple(Replicate() if i in seq_dims else p
                 for i, p in enumerate(q.placements))
    if want != tuple(q.placements):
        q = q.redistribute(mesh, want)
    heads = tuple(Replicate() if i in seq_dims else p
                  for i, p in enumerate(k_cache.placements))
    _, sel = _head_layout(mesh, q.placements, heads, q.shape[1],
                          k_cache.shape[1])
    ql, kl, vl = q.to_local(), k_cache.to_local(), v_cache.to_local()
    if sel is not None:
        kl, vl = kl[:, sel[0]:sel[1]], vl[:, sel[0]:sel[1]]
    split = [i for i in seq_dims if mesh.size(i) > 1]
    if not split:
        out = _decode_local(ql, kl, vl, cache_len, softcap)
        return DTensor.from_local(out, mesh, q.placements,
                                  shape=q.shape, stride=q.stride())
    b, hq, _, d = ql.shape
    hkv, m = kl.shape[1], kl.shape[2]
    g = hq // hkv
    qf = ql.float().reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bhkd->bhgk", qf * (1.0 / (d ** 0.5)),
                     kl.float())
    if softcap and softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    first = shard_index(mesh, seq_dims) * m
    live = torch.arange(first, first + m, device=ql.device) < cache_len
    s = torch.where(live, s, float("-inf"))
    mx = s.amax(dim=-1, keepdim=True)
    for i in split:
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=mesh.get_group(i))
    p = torch.exp(s - torch.where(torch.isneginf(mx), 0.0, mx))
    den = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgk,bhkd->bhgd", p, vl.float())
    for i in split:
        dist.all_reduce(den, group=mesh.get_group(i))
        dist.all_reduce(o, group=mesh.get_group(i))
    out = (o / den).reshape(b, hq, 1, d).to(ql.dtype)
    return DTensor.from_local(out, mesh, q.placements, shape=q.shape,
                              stride=q.stride())


def _decode_local(q, k_cache, v_cache, cache_len, softcap):
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
