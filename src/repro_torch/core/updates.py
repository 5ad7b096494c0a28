"""Batched graph mutation — the paper's seven primitives, vectorized and
device-resident (PyTorch port of ``repro.core.updates``).

:class:`UpdateBatch` collects vertex/edge add/delete/touch operations and
applies them to a :class:`~repro_torch.core.graph.ShardedGraph` in one
pass of tensor code (:func:`apply_updates`): slot matching, cumsum-based
free-slot allocation, field scatters, and the incremental CSR patching
(tombstones + staged delta blocks).  A commit costs O(batch) scatters plus
the O(cells x edge slots) matching passes, and reads back only the per-cell
policy counters and the per-op ``add_ok``/``del_ok`` flags — never an edge
stream.  Group order matches the sequential primitives in ``dynamic.py``:

    vertex adds -> edge deletes -> vertex deletes -> edge adds -> touches

Semantics (mirroring the sequential primitives):

* edge deletes remove the first matching live slot per occurrence — a
  batch deleting the same (u, v) pair twice removes two parallel edges;
* edge adds fill the lowest free slots of the source's cell, in order;
* vertex deletes drop the vertex's out-edges and mask + degree-fix its
  in-edges across all cells;
* ids are allocated at ``add_vertex`` time (through the NameServer), so
  new ids are usable by later ops in the same batch.

Compaction policy: staging falls back to the full ``with_csr`` rebuild
when a cell's delta segment would overflow, or when its tombstones exceed
``TOMBSTONE_COMPACT_FRACTION`` of its edge slots.  The JAX package pads
each op group to a power-of-two size so one compiled program serves many
batches; PyTorch runs eagerly, so the port applies the groups unpadded —
the dropped padding rows change no array.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import NamedTuple

import numpy as np
import torch

from .graph import TOMBSTONE_COMPACT_FRACTION, _scatter_drop

__all__ = ["UpdateBatch", "AppliedUpdates", "apply_updates"]

# edge-delete matching runs over [rows, Ep] tables in chunks of at most
# this many elements
_MATCH_CHUNK = 1 << 26


class AppliedUpdates(NamedTuple):
    """What a batch did — consumed by the session's incremental repair."""

    vertex_adds: tuple        # ((gid, shard, local), ...)
    vertex_deletes: tuple     # (gid, ...)
    edge_adds: tuple          # ((u, v, w), ...)
    edge_deletes: tuple       # ((u, v), ...)
    touched: tuple            # (gid, ...)

    @property
    def has_deletes(self) -> bool:
        return bool(self.vertex_deletes or self.edge_deletes)

    @property
    def n_ops(self) -> int:
        return (len(self.vertex_adds) + len(self.vertex_deletes)
                + len(self.edge_adds) + len(self.edge_deletes)
                + len(self.touched))


def _cumsum_rows(x: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """Inclusive int32 cumsum along the last dim of ``[R, E]``, in two
    levels: within blocks of ``block``, then over the block totals.  The
    same integers as ``torch.cumsum``, whose scan of a few very long rows
    runs at a few GB/s on the GPU."""
    r, e = x.shape
    nb = -(-e // block)
    x = torch.nn.functional.pad(x.to(torch.int32), (0, nb * block - e))
    inner = x.view(r, nb, block).cumsum(-1, dtype=torch.int32)
    tot = inner[..., -1]
    off = tot.cumsum(-1, dtype=torch.int32) - tot
    return (inner + off[..., None]).view(r, nb * block)[:, :e]


def _match_deletes(sg, su, lu, vg, occ):
    """The slot each edge-delete op removes: the ``occ``-th live slot of
    cell ``su`` holding edge (``lu`` -> ``vg``), where the running match
    count reaches ``occ + 1`` (first-match semantics).  Returns (slot [K]
    int64, ok [K] bool); the [K, Ep] match table is built in row chunks."""
    ep = sg.edges_per_shard
    step = max(1, _MATCH_CHUNK // max(ep, 1))
    slots, oks = [], []
    for i in range(0, su.shape[0], step):
        s, l, v, o = (a[i:i + step] for a in (su, lu, vg, occ))
        sl = s.long()
        match = ((sg.src_local[sl] == l[:, None])
                 & (sg.dst_gid[sl] == v[:, None]) & sg.edge_ok[sl])
        run = _cumsum_rows(match)
        hit = match & (run == (o + 1)[:, None])
        slot = hit.to(torch.uint8).argmax(dim=1)
        slots.append(slot)
        oks.append(hit.gather(1, slot[:, None])[:, 0])
    return torch.cat(slots), torch.cat(oks)


def apply_updates(sg, ops: dict, stage: bool):
    """The whole batched apply, in tensor code.

    ``ops`` holds the op-group tensors (any group may be absent).
    ``stage`` selects incremental CSR patching — tombstones for the delete
    groups, staged delta entries for the add group; False leaves the views
    untouched for a caller-side rebuild.

    Returns ``(sg, del_ok, add_ok)``: which edge-delete ops matched a live
    edge (phantom deletes are no-ops) and which edge adds found a free slot
    (False => the cell's edge memory is full and the caller rejects the
    batch).
    """
    np_ = sg.n_per_shard
    ep = sg.edges_per_shard
    i32 = torch.int32

    if "va_s" in ops:
        s, l, g = ops["va_s"].long(), ops["va_l"].long(), ops["va_g"]
        node_ok, gid, deg = (sg.node_ok.clone(), sg.gid.clone(),
                             sg.out_degree.clone())
        node_ok[s, l] = True
        gid[s, l] = g
        deg[s, l] = 0
        sg = dataclasses.replace(sg, node_ok=node_ok, gid=gid,
                                 out_degree=deg)

    del_ok = None
    if "ed_su" in ops:
        su, lu = ops["ed_su"], ops["ed_lu"]
        slot, del_ok = _match_deletes(sg, su, lu, ops["ed_vg"],
                                      ops["ed_occ"])
        slot = torch.where(del_ok, slot, ep)
        sg = dataclasses.replace(
            sg,
            edge_ok=_scatter_drop(sg.edge_ok, su, slot, False),
            out_degree=sg.out_degree.index_put(
                (su.long(), lu.long()), -del_ok.to(i32), accumulate=True),
        )
        if stage:
            sg = sg.with_edge_tombstones(su, slot, del_ok)

    if "vd_s" in ops:
        s, l = ops["vd_s"].long(), ops["vd_l"].long()
        dv = torch.zeros((sg.n_shards, np_), dtype=torch.bool,
                         device=sg.device)
        dv[s, l] = True
        dead_out = sg.edge_ok & torch.gather(dv, 1, sg.src_local.long())
        dead_in = sg.edge_ok & dv[sg.dst_shard.long(), sg.dst_local.long()]
        deg = sg.out_degree.scatter_add(
            1, sg.src_local.long(), -(dead_in & ~dead_out).to(i32))
        deg[s, l] = 0
        node_ok = sg.node_ok.clone()
        node_ok[s, l] = False
        sg = dataclasses.replace(
            sg, edge_ok=sg.edge_ok & ~dead_out & ~dead_in, node_ok=node_ok,
            out_degree=deg)
        if stage:
            sg = sg.with_slot_tombstones(dead_out | dead_in)

    add_ok = None
    if "ea_su" in ops:
        su, lu, sv, lv, vg, w, rank = (
            ops["ea_su"], ops["ea_lu"], ops["ea_sv"], ops["ea_lv"],
            ops["ea_vg"], ops["ea_w"], ops["ea_rank"])
        sl = su.long()
        # the op's rank among its cell's adds picks the rank-th free slot,
        # located by a per-cell searchsorted over the free-mask cumsum
        free_cum = _cumsum_rows(~sg.edge_ok).contiguous()
        targets = torch.arange(1, su.shape[0] + 1, dtype=i32,
                               device=sg.device)
        slot_tab = torch.searchsorted(
            free_cum, targets.expand(sg.n_shards, -1).contiguous())
        slot = slot_tab[sl, rank.long()]
        add_ok = free_cum[sl, -1] > rank
        slot = torch.where(add_ok, slot, ep)
        put = lambda a, v: _scatter_drop(a, su, slot, v)
        sg = dataclasses.replace(
            sg,
            src_local=put(sg.src_local, lu),
            dst_shard=put(sg.dst_shard, sv),
            dst_local=put(sg.dst_local, lv),
            dst_gid=put(sg.dst_gid, vg),
            weight=put(sg.weight, w),
            edge_ok=put(sg.edge_ok, True),
            out_degree=sg.out_degree.index_put(
                (sl, lu.long()), add_ok.to(i32), accumulate=True),
        )
        if stage:
            sg = sg.with_staged_edges(su, slot, lu, sv * np_ + lv, rank,
                                      add_ok)
    return sg, del_ok, add_ok


class UpdateBatch:
    """Collect mutations; apply them as one batched pass.

    Build one through :meth:`repro_torch.core.session.DiffusionSession.
    update` (the session then repairs its cached programs on ``commit()``),
    or standalone with a :class:`~repro_torch.core.dynamic.NameServer`.
    """

    def __init__(self, ns):
        self.ns = ns
        self._vadds: list[tuple[int, int, int]] = []
        self._vdels: list[int] = []
        self._eadds: list[tuple[int, int, float]] = []
        self._edels: list[tuple[int, int]] = []
        self._touch: list[int] = []

    def __len__(self) -> int:
        return (len(self._vadds) + len(self._vdels) + len(self._eadds)
                + len(self._edels) + len(self._touch))

    # -- the seven primitives (peek is a read; see session.peek) ----------

    def add_vertex(self, shard: int | None = None) -> int:
        """Reserve a vertex slot (eager id allocation); returns the gid."""
        if shard is None:
            shard = self.ns.best_shard()
        gid, s, l = self.ns.allocate(shard)
        self._vadds.append((gid, s, l))
        return gid

    def delete_vertex(self, gid: int):
        self._vdels.append(int(gid))
        return self

    def touch_vertex(self, gid: int):
        """Re-activate ``gid`` at the next commit (the relax seed)."""
        self._touch.append(int(gid))
        return self

    def add_edge(self, u: int, v: int, w: float = 1.0):
        self._eadds.append((int(u), int(v), float(w)))
        return self

    def delete_edge(self, u: int, v: int):
        self._edels.append((int(u), int(v)))
        return self

    def touch_edge(self, u: int):
        """Re-emit on all of u's out-edges at the next commit."""
        return self.touch_vertex(u)

    # -- host-side packing -------------------------------------------------

    def _pack_ops(self, sg) -> tuple[dict, dict]:
        """Resolve gids and pack each op group into device tensors.
        Returns ``(ops, per_cell)`` — the second holds host-side per-cell
        add/delete counts for the compaction policy."""
        ns = self.ns
        n_shards = sg.n_shards
        dev = sg.device
        up = lambda a: torch.from_numpy(a).to(dev)
        ops: dict = {}
        per_cell = {"adds": np.zeros(n_shards, np.int64),
                    "dels": np.zeros(n_shards, np.int64)}

        if self._vadds:
            g, s, l = (np.array([t[i] for t in self._vadds], np.int32)
                       for i in (0, 1, 2))
            ops["va_s"], ops["va_l"], ops["va_g"] = up(s), up(l), up(g)

        if self._edels:
            n = len(self._edels)
            su, lu, vg, occ = (np.empty(n, np.int32) for _ in range(4))
            seen: Counter = Counter()     # occurrence index per (u, v)
            for j, (u, v) in enumerate(self._edels):
                # a split source is probed at the member the rank hash
                # stored this (u, v) edge in (build and add use it too)
                su[j], lu[j] = ns.route_edge(u, v)
                vg[j] = v
                occ[j] = seen[(u, v)]
                seen[(u, v)] += 1
            ops["ed_su"], ops["ed_lu"] = up(su), up(lu)
            ops["ed_vg"], ops["ed_occ"] = up(vg), up(occ)
            per_cell["dels"] = np.bincount(su, minlength=n_shards)

        if self._vdels:
            # a split hub dies at ALL member slots (its out-edges are
            # stored across them)
            pairs = [p for gid in self._vdels
                     for p in ns.members_of(gid) or [ns.resolve(gid)]]
            ops["vd_s"] = up(np.array([p[0] for p in pairs], np.int32))
            ops["vd_l"] = up(np.array([p[1] for p in pairs], np.int32))

        if self._eadds:
            n = len(self._eadds)
            su, lu, sv, lv, vg, rank = (np.empty(n, np.int32)
                                        for _ in range(6))
            w = np.empty(n, np.float32)
            cell_rank: Counter = Counter()       # index among cell's adds
            for j, (u, v, wj) in enumerate(self._eadds):
                # split endpoints route by the rank hash (the slots the
                # partition build picks: incremental == rebuild)
                su[j], lu[j] = ns.route_edge(u, v)
                sv[j], lv[j] = ns.route_target(v, u)
                vg[j], w[j] = v, wj
                rank[j] = cell_rank[int(su[j])]
                cell_rank[int(su[j])] += 1
            for k, a in (("su", su), ("lu", lu), ("sv", sv), ("lv", lv),
                         ("vg", vg), ("w", w), ("rank", rank)):
                ops[f"ea_{k}"] = up(a)
            per_cell["adds"] = np.bincount(su, minlength=n_shards)
        return ops, per_cell

    # -- vectorized apply --------------------------------------------------

    def apply(self, sg, incremental: bool | None = None) -> tuple:
        """Apply every collected op; returns (new sg, AppliedUpdates).

        ``incremental=None`` (default) patches the CSR views in place
        (tombstones + staged delta blocks) when the graph carries them and
        the compaction policy allows, falling back to the full ``with_csr``
        rebuild otherwise; ``False`` forces the rebuild."""
        topo = bool(self._edels or self._vdels or self._eadds)
        stage = incremental is not False and topo and (
            sg.csr_perm is not None and sg.delta_count is not None
            and sg.delta_width > 0)
        ops, per_cell = self._pack_ops(sg)
        if stage:
            # compaction / capacity policy: the [S] counters, one read
            dc, tc = torch.stack([sg.delta_count, sg.tomb_count]).cpu()\
                .numpy().astype(np.int64)
            overflow = np.any(dc + per_cell["adds"] > sg.delta_width)
            crowded = np.any(
                tc + per_cell["dels"]
                > TOMBSTONE_COMPACT_FRACTION * sg.edges_per_shard)
            if (overflow or crowded) and np.any(dc + tc):
                # accumulated dirt tripped the policy: compact (the views
                # are consistent here) and retry staging into the fresh
                # delta segment
                sg = sg.with_csr()
                overflow = np.any(per_cell["adds"] > sg.delta_width)
                crowded = np.any(
                    per_cell["dels"]
                    > TOMBSTONE_COMPACT_FRACTION * sg.edges_per_shard)
            if overflow or crowded:
                stage = False
        if incremental is True and topo and not stage:
            raise ValueError(
                "incremental apply requested but the graph carries no "
                "delta-capable CSR views (call with_csr()) or the "
                "compaction policy demands a rebuild")
        new_sg, del_ok, add_ok = apply_updates(sg, ops, stage=stage)
        flags = {}
        if add_ok is not None or del_ok is not None:
            got = [t for t in (add_ok, del_ok) if t is not None]
            host = torch.cat(got).cpu().numpy()
            if add_ok is not None:
                flags["add"] = host[:add_ok.shape[0]]
            if del_ok is not None:
                flags["del"] = host[host.shape[0] - del_ok.shape[0]:]
        if "add" in flags:
            bad = np.flatnonzero(~flags["add"])
            if bad.size:
                j = int(bad[0])
                cell = self.ns.resolve(self._eadds[j][0])[0]
                raise RuntimeError(
                    f"compute cell {cell} has no free edge slots "
                    f"(batched edge_add #{j})")
        if topo and not stage:
            # full rebuild: apply_updates(stage=False) changed topology
            # without patching the views, so drop them first
            new_sg = new_sg.invalidate_csr().with_csr()
        elif stage and self._vdels:
            # vertex deletes tombstone a data-dependent number of edges
            # that the pre-apply bound cannot count: re-check the counters
            tc2 = new_sg.tomb_count.cpu().numpy().astype(np.int64)
            if np.any(tc2 > TOMBSTONE_COMPACT_FRACTION
                      * sg.edges_per_shard):
                new_sg = new_sg.with_csr()

        # NameServer slot release only after every group applied cleanly
        for gid in self._vdels:
            self.ns.release(gid)

        # edge_deletes records only ops that removed a live edge, so a
        # phantom delete is a no-op for the repair
        deleted = tuple(e for j, e in enumerate(self._edels)
                        if flags["del"][j]) if "del" in flags else ()
        applied = AppliedUpdates(
            vertex_adds=tuple(self._vadds),
            vertex_deletes=tuple(self._vdels),
            edge_adds=tuple(self._eadds),
            edge_deletes=deleted,
            touched=tuple(self._touch),
        )
        self._vadds, self._vdels = [], []
        self._eadds, self._edels, self._touch = [], [], []
        return new_sg, applied
