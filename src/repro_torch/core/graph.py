"""Graph containers for the diffusive-computation engine (PyTorch port of
``repro.core.graph``).

* :class:`Graph` — a flat edge-list graph with capacity slots.
* :class:`ShardedGraph` — the graph partitioned over compute cells: every
  array carries a leading cell axis ``S``; vertices live on one cell and
  edges live with the cell that owns their *source* vertex.

Both blocked-CSR views (the destination-sorted pull stream and its
source-sorted push twin) are maintained incrementally between rebuilds:
deletes tombstone stream positions and adds stage into a delta segment
(:meth:`ShardedGraph.with_edge_tombstones`, ``with_slot_tombstones``,
``with_staged_edges``), each an O(batch) scatter.  Compaction
(:meth:`ShardedGraph.with_csr`) is the full stable sort.
:meth:`ShardedGraph._merge_compact`, the JAX package's compaction at wide
streams (a compact of the live sorted prefix, a sort of the delta segment
alone and a ``searchsorted`` merge), gives the same bits; on the GPU it
is slower than the sort wherever compaction takes milliseconds
(``chip_smoke.py`` phase 3i), so it is the check of the views' order
invariant, not a compaction path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Graph", "ShardedGraph", "from_edges", "build_csr",
           "build_push_csr", "DEFAULT_EDGE_BLOCK", "DELTA_BLOCK_FRACTION",
           "TOMBSTONE_COMPACT_FRACTION", "default_delta_blocks"]

# Edge-block width of the blocked-CSR view: the relaxation kernels combine
# within blocks of exactly this many edges (one CUDA thread per edge).
DEFAULT_EDGE_BLOCK = 128

# Delta-segment policy: a rebuild reserves staged delta blocks for this
# fraction of the sorted stream (>= 1 block), and the update layer
# compacts once a cell's tombstones exceed the same fraction of its edge
# slots — the incremental views' extra sweep cost stays bounded.
DELTA_BLOCK_FRACTION = 0.25
TOMBSTONE_COMPACT_FRACTION = 0.25


def default_delta_blocks(edges_per_shard: int, block: int) -> int:
    """Staged-delta capacity (in blocks) reserved by a rebuild."""
    nb = -(-edges_per_shard // block)
    return max(1, int(nb * DELTA_BLOCK_FRACTION))


def _pad_last(a: torch.Tensor, pad: int, value) -> torch.Tensor:
    if not pad:
        return a
    fill = torch.full(a.shape[:-1] + (pad,), value, dtype=a.dtype,
                      device=a.device)
    return torch.cat([a, fill], dim=-1)


def build_csr(dst_shard, dst_local, edge_ok, n_shards: int, n_per_shard: int,
              block: int):
    """Destination-sorted blocked-CSR permutation of per-shard edge slots.

    Sort key per live edge is the flat destination ``dst_shard * Np +
    dst_local``; dead slots sort last (stable, so ties keep slot order).
    Returns ``perm`` [S, Eb] int32 (sorted position -> edge slot) and
    ``key`` [S, Eb] int32 (sorted destination key, ``-1`` on dead and
    padding positions), with ``Eb`` the capacity rounded up to ``block``.
    """
    ep = dst_shard.shape[-1]
    eb = -(-ep // block) * block
    sentinel = n_shards * n_per_shard
    key = torch.where(edge_ok, dst_shard * n_per_shard + dst_local, sentinel)
    perm = torch.argsort(key, dim=-1, stable=True)
    skey = torch.gather(key, -1, perm)
    skey = torch.where(skey >= sentinel, -1, skey).to(torch.int32)
    return (_pad_last(perm.to(torch.int32), eb - ep, 0),
            _pad_last(skey, eb - ep, -1))


def build_push_csr(src_local, edge_ok, csr_perm, n_per_shard: int,
                   block: int):
    """Source-sorted blocked-CSR permutation — the push twin of
    :func:`build_csr`.  Returns ``perm`` [S, Eb] (push position -> slot),
    ``src`` [S, Eb] (sorted source local index, ``-1`` on dead/pad) and
    ``pos`` [S, Eb] (the same edge's position in the destination-sorted
    stream of ``csr_perm``, ``-1`` on dead/pad)."""
    s_, ep = src_local.shape
    eb = -(-ep // block) * block
    key = torch.where(edge_ok, src_local, n_per_shard)
    perm = torch.argsort(key, dim=-1, stable=True)
    ssrc = torch.gather(key, -1, perm)
    ssrc = torch.where(ssrc >= n_per_shard, -1, ssrc).to(torch.int32)
    # invert the destination sort: edge slot -> dense stream position
    ar = torch.arange(ep, dtype=torch.int32, device=src_local.device)
    inv = torch.zeros((s_, ep), dtype=torch.int32, device=src_local.device)
    inv.scatter_(1, csr_perm[:, :ep].long(), ar.expand(s_, ep))
    pos = torch.gather(inv, -1, perm)
    pos = torch.where(ssrc >= 0, pos, -1)
    pad = eb - ep
    return (_pad_last(perm.to(torch.int32), pad, 0),
            _pad_last(ssrc, pad, -1), _pad_last(pos, pad, -1))


def _scatter_drop(a: torch.Tensor, rows, cols, vals) -> torch.Tensor:
    """``a[rows, cols] = vals`` into a copy of the ``[S, W]`` tensor
    ``a``, where a column index ``W`` drops its entry (JAX's
    ``mode="drop"``): the write goes to a spare column that is cut off,
    never onto a real position.  The copy has ``a``'s row stride ``W``
    (``.contiguous()`` would keep ``W + 1`` for one row, which counts as
    contiguous), as the kernels' stream checks require."""
    s_, w = a.shape
    out = torch.empty((s_, w + 1), dtype=a.dtype, device=a.device)
    out[:, :w] = a
    out[rows.long(), cols.long()] = vals
    return out[:, :w].clone(memory_format=torch.contiguous_format)


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


def _merge_compact_views(csr_key, csr_perm, csr_live, push_src, push_perm,
                         edge_ok, sw: int, dwid: int, ep: int, used: int):
    """Body of :meth:`ShardedGraph._merge_compact`: both views' merged
    (key, perm, slot -> position inverse), then the push view's dense
    positions.

    Every scatter writes each target at most once and sends nothing to a
    shared discard column (same-address stores serialize on the GPU): a
    view's sorted prefix splits stably into its live entries, which move
    to their merged positions, and the rest, which land past the live
    region and are overwritten.  Only the staged entries carry the int64
    composite ``key * (ep + 1) + slot`` (empty ones ``1 << 60``, above
    every live composite), searched into the prefix's compacted
    composites.  ``used`` bounds the staged columns that can hold an
    entry (the largest per-cell ``delta_count``): staging fills each
    cell's delta segment from its start."""
    s_ = edge_ok.shape[0]
    w = sw + dwid
    dev = edge_ok.device
    i32, i64 = torch.int32, torch.int64
    base, big = ep + 1, 1 << 60
    idx_a = torch.arange(sw, dtype=i32, device=dev)
    idx_w = torch.arange(w, dtype=i32, device=dev)
    slots = torch.arange(ep, dtype=i32, device=dev).expand(s_, ep)
    dead = ~edge_ok
    dead_rank = _cumsum_rows(dead)            # inclusive
    n_dead = dead_rank[:, -1:]

    def compact_merge(key, perm, live):
        ka, pa = key[:, :sw], perm[:, :sw]
        la = live[:, :sw] & (ka >= 0)
        cl = _cumsum_rows(la)                 # live entries up to i
        n_a = cl[:, -1:]
        rank = cl - 1
        rest = idx_a - cl                     # rank among the others
        n_b, shift = 0, 0
        if used:
            kb, pb = key[:, sw:sw + used], perm[:, sw:sw + used]
            lb = live[:, sw:sw + used] & (kb >= 0)
            comp_b = torch.sort(torch.where(lb, kb.to(i64) * base + pb,
                                            big), dim=1).values
            n_b = lb.sum(1, keepdim=True, dtype=i32)
            # the prefix's live composites compacted (already in (key,
            # slot) order), the others after them as the sentinel
            comp_a = torch.empty((s_, sw), dtype=i64, device=dev)
            comp_a.scatter_(1, torch.where(la, rank, n_a + rest).long(),
                            torch.where(la, ka.to(i64) * base + pa, big))
            # ins[j]: the live prefix entries below staged entry j (n_a
            # for an empty one, which then passes every prefix entry)
            ins = torch.searchsorted(comp_a, comp_b)
            del comp_a
            # a live prefix entry of rank r lands after the staged entries
            # with ins <= r; staged entry j lands at ins[j] + j
            shift = torch.searchsorted(ins.to(i32), rank, right=True,
                                       out_int32=True)
        n_live = n_a + n_b
        dest = torch.where(la, rank + shift, n_live + rest).long()
        # perm has ep spare columns: the dead-tail scatter's discard
        new_key = torch.empty((s_, w), dtype=i32, device=dev)
        new_perm = torch.empty((s_, w + ep), dtype=i32, device=dev)
        new_key.scatter_(1, dest, ka)
        new_perm.scatter_(1, dest, pa)
        if used:
            at = ins + torch.arange(used, device=dev)
            new_key.scatter_(1, at, (comp_b // base).to(i32))
            new_perm.scatter_(1, at, (comp_b % base).to(i32))
        # dead slots tail the live region in ascending slot order: the
        # stable sort's tie-break on the shared sentinel key
        new_perm.scatter_(1, torch.where(dead, n_live + dead_rank - 1,
                                         w + slots).long(), slots)
        new_key = torch.where(idx_w < n_live, new_key, -1)
        new_perm = torch.where(idx_w < n_live + n_dead, new_perm[:, :w], 0)
        # positions [0, ep) hold each slot exactly once
        inv = torch.zeros((s_, ep), dtype=i32, device=dev)
        inv.scatter_(1, new_perm[:, :ep].long(), slots)
        return new_key, new_perm, inv

    key, perm, inv = compact_merge(csr_key, csr_perm, csr_live)
    psrc, pperm, pinv = compact_merge(push_src, push_perm, push_src >= 0)
    ppos = torch.where(psrc >= 0,
                       inv.gather(1, pperm.clamp(0, ep - 1).long()), -1)
    return key, perm, inv, psrc, pperm, pinv, ppos


def _count_per_cell(counts: torch.Tensor, shard, ok) -> torch.Tensor:
    """``counts[shard] += ok`` (int32, per op, duplicates accumulate)."""
    return counts.index_add(0, shard.long(), ok.to(counts.dtype))


@dataclasses.dataclass(frozen=True)
class Graph:
    """Flat directed edge-list graph with capacity slots.

    ``src/dst/weight`` have length = edge capacity; slots with
    ``edge_ok == False`` are free.  Undirected graphs are stored with both
    directions materialized.
    """

    src: torch.Tensor       # [Ecap] int32
    dst: torch.Tensor       # [Ecap] int32
    weight: torch.Tensor    # [Ecap] float32
    edge_ok: torch.Tensor   # [Ecap] bool
    node_ok: torch.Tensor   # [Ncap] bool
    n_nodes: int            # vertex capacity

    def n_edges(self) -> torch.Tensor:
        """Count of live edges."""
        return self.edge_ok.sum()


def from_edges(src, dst, n_nodes: int, weight=None, edge_slack: float = 0.0,
               node_slack: float = 0.0, device="cuda") -> Graph:
    """Build a :class:`Graph` on ``device`` from host edge arrays, with
    optional slack capacity for dynamic updates (fraction of the initial
    size)."""
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    e = src.shape[0]
    if weight is None:
        weight = np.ones(e, np.float32)
    weight = np.asarray(weight, np.float32)
    ecap = e + int(np.ceil(e * edge_slack))
    ncap = n_nodes + int(np.ceil(n_nodes * node_slack))
    pad = ecap - e
    up = lambda a: torch.from_numpy(a).to(device)
    return Graph(
        src=up(np.concatenate([src, np.zeros(pad, np.int32)])),
        dst=up(np.concatenate([dst, np.zeros(pad, np.int32)])),
        weight=up(np.concatenate([weight, np.zeros(pad, np.float32)])),
        edge_ok=up(np.concatenate([np.ones(e, bool), np.zeros(pad, bool)])),
        node_ok=up(np.concatenate([np.ones(n_nodes, bool),
                                   np.zeros(ncap - n_nodes, bool)])),
        n_nodes=ncap,
    )


_DATA_FIELDS = (
    "src_local", "dst_shard", "dst_local", "dst_gid", "weight", "edge_ok",
    "node_ok", "gid", "out_degree", "csr_perm", "csr_key", "csr_live",
    "csr_inv", "push_perm", "push_src", "push_pos", "push_inv",
    "delta_count", "tomb_count", "replica_of", "replica_group",
    "replica_members",
)


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Graph partitioned over S compute cells (field-for-field the JAX
    package's layout, so a JAX-built graph loads through
    :meth:`from_state` and both engines run on identical arrays).

    ``csr_perm``/``csr_key`` are the destination-sorted pull view padded
    to a ``csr_block`` multiple, followed by ``delta_blocks`` staged
    blocks; ``push_perm``/``push_src``/``push_pos`` are its source-sorted
    push twin.  ``csr_live`` masks tombstones, ``csr_inv``/``push_inv``
    map an edge slot back to its stream positions, and
    ``delta_count``/``tomb_count`` count staged adds and tombstones per
    cell.  The replica maps (``partition(..., replica_threshold=...)``) are
    None on unsplit graphs: ``replica_of`` [S, Np] the hub gid at each
    non-primary member slot, ``replica_group`` [S, Np] the group index at
    every member slot, ``replica_members`` [G, Rmax] each group's member
    slots as flat ``cell * Np + slot`` keys (primary first, -1 pad).
    """

    src_local: torch.Tensor   # [S, Ep] int32 — local index of the source
    dst_shard: torch.Tensor   # [S, Ep] int32 — owner cell of the destination
    dst_local: torch.Tensor   # [S, Ep] int32 — local index at that cell
    dst_gid: torch.Tensor     # [S, Ep] int32 — global id of the destination
    weight: torch.Tensor      # [S, Ep] float32
    edge_ok: torch.Tensor     # [S, Ep] bool
    node_ok: torch.Tensor     # [S, Np] bool
    gid: torch.Tensor         # [S, Np] int32 — global id of each slot
    out_degree: torch.Tensor  # [S, Np] int32 — live out-degree
    n_shards: int
    n_per_shard: int
    n_nodes: int
    csr_perm: torch.Tensor | None = None   # [S, W] stream pos -> slot
    csr_key: torch.Tensor | None = None    # [S, W] structural dst key | -1
    csr_live: torch.Tensor | None = None   # [S, W] bool live (not tombstone)
    csr_inv: torch.Tensor | None = None    # [S, Ep] slot -> dense pos
    push_perm: torch.Tensor | None = None  # [S, W] push pos -> slot
    push_src: torch.Tensor | None = None   # [S, W] sorted src | -1
    push_pos: torch.Tensor | None = None   # [S, W] dense pos | -1
    push_inv: torch.Tensor | None = None   # [S, Ep] slot -> push pos
    delta_count: torch.Tensor | None = None  # [S] staged adds per cell
    tomb_count: torch.Tensor | None = None   # [S] tombstones per cell
    replica_of: torch.Tensor | None = None       # [S, Np] int32
    replica_group: torch.Tensor | None = None    # [S, Np] int32
    replica_members: torch.Tensor | None = None  # [G, Rmax] int32
    csr_block: int = DEFAULT_EDGE_BLOCK
    delta_blocks: int = -1               # staged blocks; -1 = policy default

    _META_FIELDS = ("n_shards", "n_per_shard", "n_nodes", "csr_block",
                    "delta_blocks")

    @property
    def edges_per_shard(self) -> int:
        return int(self.src_local.shape[1])

    @property
    def device(self) -> torch.device:
        return self.gid.device

    # -- state exchange with the JAX package / snapshots ---------------------

    def state_dict(self) -> dict:
        """Every non-None data array by field name."""
        return {f: getattr(self, f) for f in _DATA_FIELDS
                if getattr(self, f) is not None}

    def meta_dict(self) -> dict:
        """The static geometry, JSON-ready."""
        return {name: int(getattr(self, name)) for name in self._META_FIELDS}

    @classmethod
    def from_state(cls, arrays: dict, meta: dict, device="cuda"):
        """Rebuild from :meth:`state_dict`-style arrays (numpy or tensors —
        e.g. the JAX package's ``ShardedGraph.state_dict()`` converted with
        ``np.asarray``) and :meth:`meta_dict`, on ``device``."""
        kw = {k: int(v) for k, v in meta.items()}
        for f in _DATA_FIELDS:
            if f in arrays:
                a = arrays[f]
                if not isinstance(a, torch.Tensor):
                    a = np.asarray(a)
                    a = torch.from_numpy(a if a.flags.writeable else a.copy())
                kw[f] = a.to(device)
        return cls(**kw)

    # -- blocked-CSR views -----------------------------------------------

    @property
    def sorted_width(self) -> int:
        """Width of the sorted region of both views: edge capacity rounded
        up to a ``csr_block`` multiple."""
        return -(-self.edges_per_shard // self.csr_block) * self.csr_block

    @property
    def delta_width(self) -> int:
        """Per-cell staged-delta capacity in edge slots."""
        return max(self.delta_blocks, 0) * self.csr_block

    def _views_clean(self) -> bool:
        """Views present with no staged adds and no tombstones (one host
        read of the per-cell counters)."""
        if self.csr_perm is None or self.delta_count is None:
            return False
        dirty = self.delta_count.any()
        if self.tomb_count is not None:
            dirty = dirty | self.tomb_count.any()
        return not bool(dirty)

    def with_csr(self, block: int | None = None,
                 delta_blocks: int | None = None) -> "ShardedGraph":
        """Rebuild both blocked-CSR views from the current topology by the
        full stable sort: tombstones fold out, staged edges land in sorted
        position, and a fresh empty delta segment of ``delta_blocks`` blocks
        is appended.  Clean views of unchanged geometry are returned as
        they are."""
        block = block or self.csr_block
        if delta_blocks is None:
            delta_blocks = self.delta_blocks
        if delta_blocks < 0:
            delta_blocks = default_delta_blocks(self.edges_per_shard, block)
        if (block == self.csr_block and delta_blocks == self.delta_blocks
                and self._views_clean()):
            return self
        s_, ep = self.src_local.shape
        perm, key = build_csr(self.dst_shard, self.dst_local, self.edge_ok,
                              self.n_shards, self.n_per_shard, block)
        pperm, psrc, ppos = build_push_csr(
            self.src_local, self.edge_ok, perm, self.n_per_shard, block)
        dw = delta_blocks * block
        perm, key = _pad_last(perm, dw, 0), _pad_last(key, dw, -1)
        pperm, psrc = _pad_last(pperm, dw, 0), _pad_last(psrc, dw, -1)
        ppos = _pad_last(ppos, dw, -1)
        # slot -> stream position inverses; the first ep positions hold
        # the real argsort, so scattering through them covers every slot
        ar = torch.arange(ep, dtype=torch.int32, device=self.device)
        pos = ar.expand(s_, ep)
        inv = torch.zeros((s_, ep), dtype=torch.int32, device=self.device)
        inv.scatter_(1, perm[:, :ep].long(), pos)
        pinv = torch.zeros((s_, ep), dtype=torch.int32, device=self.device)
        pinv.scatter_(1, pperm[:, :ep].long(), pos)
        zero = torch.zeros((s_,), dtype=torch.int32, device=self.device)
        return dataclasses.replace(
            self, csr_perm=perm, csr_key=key, csr_live=key >= 0,
            csr_inv=inv, push_perm=pperm, push_src=psrc, push_pos=ppos,
            push_inv=pinv, delta_count=zero, tomb_count=zero,
            csr_block=block, delta_blocks=delta_blocks,
        )

    def _merge_compact(self, used: int | None = None) -> "ShardedGraph":
        """Compact both views by merging instead of re-sorting.

        The sorted region's live entries are already in ascending ``(key,
        slot)`` order, the order the stable sort of the full key stream
        gives (its tie-break is slot order, and slots are unique per
        cell).  So folding the tombstones out is a cumsum/scatter compact,
        only the delta segment is sorted, and the two ascending streams
        meet through one row-wise ``searchsorted`` of the staged entries
        into the prefix.  Dead slots fill the tail in ascending slot order:
        the full rebuild, bit for bit, on views whose sorted prefix keeps
        its live entries in that order: the invariant the incremental
        patches must keep.  ``used`` is the largest per-cell
        ``delta_count`` (read from the device when not given)."""
        if used is None:
            used = int(self.delta_count.max())
        key, perm, inv, psrc, pperm, pinv, ppos = _merge_compact_views(
            self.csr_key, self.csr_perm, self.csr_live, self.push_src,
            self.push_perm, self.edge_ok, self.sorted_width,
            self.delta_width, self.edges_per_shard, used)
        zero = torch.zeros((self.n_shards,), dtype=torch.int32,
                           device=self.device)
        return dataclasses.replace(
            self, csr_perm=perm, csr_key=key, csr_live=key >= 0,
            csr_inv=inv, push_perm=pperm, push_src=psrc, push_pos=ppos,
            push_inv=pinv, delta_count=zero, tomb_count=zero)

    def invalidate_csr(self) -> "ShardedGraph":
        """Drop both blocked-CSR views (the next diffusion rebuilds them)."""
        return dataclasses.replace(self, csr_perm=None, csr_key=None,
                                   csr_live=None, csr_inv=None,
                                   push_perm=None, push_src=None,
                                   push_pos=None, push_inv=None,
                                   delta_count=None, tomb_count=None)

    # -- incremental view maintenance ----------------------------------

    def with_edge_tombstones(self, shard, slot, ok) -> "ShardedGraph":
        """Tombstone K edges at ``(shard, slot)`` (``ok`` masks no-ops) in
        both views: O(K) scatters through the slot -> position inverses.
        The dense position keeps its structural ``csr_key`` and drops
        ``csr_live``; the push position drops ``push_src`` to ``-1``."""
        ep = self.edges_per_shard
        w = self.csr_key.shape[-1]
        sh = shard.long()
        sl = slot.clamp(0, ep - 1).long()
        dpos = torch.where(ok, self.csr_inv[sh, sl], w)
        ppos = torch.where(ok, self.push_inv[sh, sl], w)
        return dataclasses.replace(
            self,
            csr_live=_scatter_drop(self.csr_live, sh, dpos, False),
            push_src=_scatter_drop(self.push_src, sh, ppos, -1),
            tomb_count=_count_per_cell(self.tomb_count, sh, ok),
        )

    def with_slot_tombstones(self, dead) -> "ShardedGraph":
        """Tombstone every edge slot in the ``dead`` [S, Ep] mask (the
        vertex-delete path): one O(E) elementwise pass over both views,
        no sort."""
        ep = self.edges_per_shard
        at = lambda perm: torch.gather(dead, -1, perm.clamp(0, ep - 1).long())
        at_dense = at(self.csr_perm)
        newly = self.csr_live & at_dense
        at_push = at(self.push_perm) & (self.push_src >= 0)
        return dataclasses.replace(
            self,
            csr_live=self.csr_live & ~at_dense,
            push_src=torch.where(at_push, -1, self.push_src),
            tomb_count=self.tomb_count + newly.sum(-1, dtype=torch.int32),
        )

    def with_staged_edges(self, shard, slot, src_local, dst_key, rank,
                          ok) -> "ShardedGraph":
        """Stage K freshly written edges (``(shard, slot)`` already hold
        their fields) into the delta segment of both views at position
        ``sorted_width + delta_count[shard] + rank`` (``rank`` = the op's
        index among this batch's adds to the same cell).  O(K) scatters;
        the caller has checked capacity (``delta_count + adds-per-cell <=
        delta_width``)."""
        es = self.sorted_width
        w = self.csr_key.shape[-1]
        ep = self.edges_per_shard
        sh = shard.long()
        dpos = torch.where(ok, es + self.delta_count[sh] + rank, w)
        islot = torch.where(ok, slot, ep)
        i32 = lambda a: a.to(torch.int32)
        inv = lambda a: _scatter_drop(a, sh, islot, i32(dpos))
        stage = lambda a, v: _scatter_drop(a, sh, dpos, v)
        return dataclasses.replace(
            self,
            csr_perm=stage(self.csr_perm, i32(slot)),
            csr_key=stage(self.csr_key, i32(dst_key)),
            csr_live=stage(self.csr_live, True),
            csr_inv=inv(self.csr_inv),
            push_perm=stage(self.push_perm, i32(slot)),
            push_src=stage(self.push_src, i32(src_local)),
            push_pos=stage(self.push_pos, i32(dpos)),
            push_inv=inv(self.push_inv),
            delta_count=_count_per_cell(self.delta_count, sh, ok),
        )

    def csr_view(self) -> dict:
        """The destination-sorted edge streams the relax kernels consume:
        [S, W] gathers of the edge fields through ``csr_perm``.  Positions
        with ``csr_key == -1`` carry garbage and are masked by the key;
        ``csr_key`` here is live-masked, ``csr_skey`` the structural key."""
        if self.csr_perm is None:
            raise ValueError("ShardedGraph has no CSR view; call with_csr()")
        idx = self.csr_perm.long()
        take = lambda a: torch.gather(a, -1, idx)
        return {
            "csr_key": torch.where(self.csr_live, self.csr_key, -1),
            "csr_skey": self.csr_key,
            "csr_src": take(self.src_local),
            "csr_weight": take(self.weight),
            "csr_dst_gid": take(self.dst_gid),
        }

    def push_view(self) -> dict:
        """The source-sorted edge streams of the push sweep: [S, W]
        gathers through ``push_perm``; ``push_pos`` maps each push position
        back to the destination-sorted stream."""
        if self.push_perm is None:
            raise ValueError("ShardedGraph has no push view; call with_csr()")
        idx = self.push_perm.long()
        take = lambda a: torch.gather(a, -1, idx)
        key = take(self.dst_shard) * self.n_per_shard + take(self.dst_local)
        return {
            "push_src": self.push_src,
            "push_key": torch.where(self.push_src >= 0, key, -1),
            "push_weight": take(self.weight),
            "push_dst_gid": take(self.dst_gid),
            "push_pos": self.push_pos,
        }

    def n_edges(self) -> torch.Tensor:
        return self.edge_ok.sum()
