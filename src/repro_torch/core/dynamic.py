"""Dynamic-graph primitives — the paper's seven graph operations (PyTorch
port of ``repro.core.dynamic``).

    vertex add | vertex delete | vertex touch
    edge add   | edge delete   | edge touch   | peek

Each primitive is a functional update of a :class:`ShardedGraph` with
capacity slots: array shapes never change, and the CSR views are patched
in place (tombstones and staged delta entries) instead of re-sorted.

:class:`NameServer` allocates globally unique vertex ids and resolves id
-> (owner cell, local slot).  On a hub-split graph (``partition(...,
replica_threshold=...)``) it also routes each edge of a split hub to the
member slot the partition's rank hash chose, so an incremental add or
delete touches the same slot a rebuild would.

:func:`incremental_sssp` composes the primitives into dynamic graph
processing: edge inserts re-diffuse from the endpoints; deletes
invalidate the affected shortest-path subtree (through the parent
pointers) and re-diffuse from the frontier.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .graph import TOMBSTONE_COMPACT_FRACTION, ShardedGraph
from .partition import Partitioned
from .rhizome import member_rank

__all__ = [
    "NameServer",
    "vertex_add",
    "vertex_delete",
    "vertex_touch",
    "edge_add",
    "edge_delete",
    "edge_touch",
    "peek",
    "incremental_sssp",
]


class NameServer:
    """Global namespace: id allocation + id -> (owner, local) resolution,
    and the member routing of split hubs."""

    def __init__(self, part: Partitioned):
        self.owner = part.owner_np.copy()
        self.local = part.local_np.copy()
        self._next = int(self.owner.shape[0])
        self.replica = part.replica
        # non-primary member slots stay reserved for their hub's mirrors,
        # even after the hub's delete (release() frees only the primary)
        taken = part.sg.node_ok.cpu().numpy().copy()
        if self.replica is not None:
            ms = self.replica.members_s[:, 1:].ravel()
            ml = self.replica.members_l[:, 1:].ravel()
            live = ms >= 0
            taken[ms[live], ml[live]] = True
        self._free_local = {s: np.flatnonzero(~taken[s]).tolist()
                            for s in range(part.sg.n_shards)}

    # -- hub-replica routing ------------------------------------------------

    def _member_slot(self, hub: int, other: int):
        """(shard, local) of the member slot the rank hash assigns the
        (hub, other) edge key to, or None when ``hub`` is unsplit."""
        rep = self.replica
        h = int(hub)
        if rep is None or h >= rep.group_of.shape[0]:
            return None     # ids minted after partition are never split
        g = int(rep.group_of[h])
        if g < 0:
            return None
        m = int(member_rank(h, int(other), int(rep.n_members[g])))
        return int(rep.members_s[g, m]), int(rep.members_l[g, m])

    def route_edge(self, u: int, v: int) -> tuple[int, int]:
        """Storage slot of directed edge u -> v: the member of a split u
        the rank hash picks, else u's primary slot."""
        return self._member_slot(u, v) or self.resolve(u)

    def route_target(self, v: int, u: int) -> tuple[int, int]:
        """Destination slot of directed edge u -> v: the member of a split
        v the rank hash picks, else v's primary slot."""
        return self._member_slot(v, u) or self.resolve(v)

    def members_of(self, gid: int):
        """All (shard, local) member slots of a split hub (primary
        first), or None for an unsplit vertex."""
        rep = self.replica
        g = int(gid)
        if rep is None or g >= rep.group_of.shape[0]:
            return None
        gi = int(rep.group_of[g])
        if gi < 0:
            return None
        return [(int(rep.members_s[gi, m]), int(rep.members_l[gi, m]))
                for m in range(int(rep.n_members[gi]))]

    # -- snapshot state ------------------------------------------------------

    def state_dict(self) -> dict:
        """The full allocation state: the owner/local maps and each cell's
        free-slot list in order (allocate pops the front, release
        appends)."""
        out = {"owner": self.owner, "local": self.local}
        for s, free in self._free_local.items():
            out[f"free_{s}"] = np.asarray(free, np.int32)
        return out

    @classmethod
    def from_state(cls, arrays: dict, n_shards: int,
                   replica=None) -> "NameServer":
        """Rebuild from :meth:`state_dict` arrays (the same maps, the same
        free-list order), routing split hubs through ``replica``."""
        ns = cls.__new__(cls)
        ns.owner = np.asarray(arrays["owner"]).copy()
        ns.local = np.asarray(arrays["local"]).copy()
        ns._next = int(ns.owner.shape[0])
        ns.replica = replica
        ns._free_local = {s: [int(x) for x in arrays[f"free_{s}"]]
                          for s in range(n_shards)}
        return ns

    def best_shard(self) -> int:
        """The compute cell with the most free vertex slots."""
        return max(self._free_local, key=lambda s: len(self._free_local[s]))

    def allocate(self, shard: int) -> tuple[int, int, int]:
        """-> (gid, owner shard, local slot). Raises if the cell is full."""
        if not self._free_local[shard]:
            raise RuntimeError(f"compute cell {shard} has no free vertex "
                               f"slots")
        local = self._free_local[shard].pop(0)
        gid = self._next
        self._next += 1
        self.owner = np.append(self.owner, np.int32(shard))
        self.local = np.append(self.local, np.int32(local))
        return gid, shard, local

    def resolve(self, gid: int) -> tuple[int, int]:
        return int(self.owner[gid]), int(self.local[gid])

    def release(self, gid: int):
        s, l = self.resolve(gid)
        self._free_local[s].append(l)


def _can_patch(sg: ShardedGraph) -> bool:
    """Whether the graph carries delta-capable CSR views to patch in
    place; otherwise the primitives drop the views (the next diffusion
    rebuilds them)."""
    return (sg.csr_perm is not None and sg.delta_count is not None
            and sg.delta_width > 0)


def _crowded(counts: torch.Tensor, sg: ShardedGraph) -> bool:
    return int(counts.max()) > TOMBSTONE_COMPACT_FRACTION * sg.edges_per_shard


def _ints(*xs, device):
    return torch.tensor(xs, dtype=torch.int32, device=device)


def vertex_add(sg: ShardedGraph, ns: NameServer, shard: int):
    """Activate a free vertex slot on ``shard``; returns (sg, gid)."""
    gid, s, l = ns.allocate(shard)
    node_ok, gids, deg = (sg.node_ok.clone(), sg.gid.clone(),
                          sg.out_degree.clone())
    node_ok[s, l] = True
    gids[s, l] = gid
    deg[s, l] = 0
    return dataclasses.replace(sg, node_ok=node_ok, gid=gids,
                               out_degree=deg), gid


def vertex_delete(sg: ShardedGraph, ns: NameServer, gid: int):
    """Remove a vertex, its out-edges and its in-edges (degree-fixed at
    their sources).  The doomed slots are tombstoned in both views in one
    elementwise pass; a cell crowded with tombstones compacts.  A split
    hub dies at every member slot (its out-edges are stored across them);
    release() then frees only the primary."""
    pairs = ns.members_of(gid) or [ns.resolve(gid)]
    ss = torch.tensor([p[0] for p in pairs], dtype=torch.long,
                      device=sg.device)
    ll = torch.tensor([p[1] for p in pairs], dtype=torch.long,
                      device=sg.device)
    dv = torch.zeros_like(sg.node_ok)
    dv[ss, ll] = True
    dead_out = sg.edge_ok & torch.gather(dv, 1, sg.src_local.long())
    node_ok, deg = sg.node_ok.clone(), sg.out_degree.clone()
    node_ok[ss, ll] = False
    deg[ss, ll] = 0
    sg = dataclasses.replace(sg, node_ok=node_ok,
                             edge_ok=sg.edge_ok & ~dead_out, out_degree=deg)
    dead_in = (sg.dst_gid == gid) & sg.edge_ok
    deg = sg.out_degree.scatter_add(1, sg.src_local.long(),
                                    -dead_in.to(torch.int32))
    sg = dataclasses.replace(sg, edge_ok=sg.edge_ok & ~dead_in,
                             out_degree=deg)
    ns.release(gid)
    if _can_patch(sg):
        sg = sg.with_slot_tombstones(dead_out | dead_in)
        return sg.with_csr() if _crowded(sg.tomb_count, sg) else sg
    return sg.invalidate_csr()


def vertex_touch(sg: ShardedGraph, ns: NameServer, gids):
    """Activation mask in shard layout for the given vertex ids.  Touching
    a split hub activates every member slot, so each member re-emits its
    stored share of the out-edges."""
    mask = torch.zeros((sg.n_shards, sg.n_per_shard), dtype=torch.bool,
                       device=sg.device)
    for g in np.atleast_1d(gids):
        for s, l in ns.members_of(int(g)) or [ns.resolve(int(g))]:
            mask[s, l] = True
    return mask


def edge_add(sg: ShardedGraph, ns: NameServer, u: int, v: int, w: float):
    """Insert directed edge u -> v with weight w into the lowest free slot
    of u's cell, and stage it into both views' delta segments (a full
    segment compacts first).  Split endpoints route by the rank hash: the
    edge is stored at the member ``route_edge`` picks and targets the
    member ``route_target`` picks, the slots the partition build uses."""
    su, lu = ns.route_edge(u, v)
    sv, lv = ns.route_target(v, u)
    can_patch = _can_patch(sg)
    if can_patch and int(sg.delta_count[su]) >= sg.delta_width:
        # compact BEFORE touching topology, while the views are consistent
        sg = sg.with_csr()
    free = ~sg.edge_ok[su]
    if not bool(free.any()):
        raise RuntimeError(f"compute cell {su} has no free edge slots")
    slot = int(free.to(torch.uint8).argmax())
    fields = {}
    for name, val in (("src_local", lu), ("dst_shard", sv),
                      ("dst_local", lv), ("dst_gid", v), ("weight", w),
                      ("edge_ok", True)):
        a = getattr(sg, name).clone()
        a[su, slot] = val
        fields[name] = a
    deg = sg.out_degree.clone()
    deg[su, lu] += 1
    sg = dataclasses.replace(sg, out_degree=deg, **fields)
    if can_patch:
        dev = sg.device
        return sg.with_staged_edges(
            _ints(su, device=dev), _ints(slot, device=dev),
            _ints(lu, device=dev), _ints(sv * sg.n_per_shard + lv,
                                         device=dev),
            _ints(0, device=dev), torch.ones(1, dtype=torch.bool,
                                             device=dev))
    return sg.invalidate_csr()


def edge_delete(sg: ShardedGraph, ns: NameServer, u: int, v: int):
    """Delete directed edge u -> v (first matching live slot) and
    tombstone its stream positions in both views; a crowded cell
    compacts.  A split source is probed at the member the rank hash
    stored the edge in."""
    su, lu = ns.route_edge(u, v)
    match = (sg.src_local[su] == lu) & (sg.dst_gid[su] == v) & sg.edge_ok[su]
    slot = int(match.to(torch.uint8).argmax())
    ok = bool(match[slot])
    if ok:
        edge_ok, deg = sg.edge_ok.clone(), sg.out_degree.clone()
        edge_ok[su, slot] = False
        deg[su, lu] -= 1
        sg = dataclasses.replace(sg, edge_ok=edge_ok, out_degree=deg)
    if _can_patch(sg):
        dev = sg.device
        sg = sg.with_edge_tombstones(
            _ints(su, device=dev), _ints(slot, device=dev),
            torch.tensor([ok], device=dev))
        return sg.with_csr() if _crowded(sg.tomb_count[su], sg) else sg
    return sg.invalidate_csr()


def edge_touch(sg: ShardedGraph, ns: NameServer, u: int):
    """Activate a vertex so it re-emits on all out-edges (the relax seed)."""
    return vertex_touch(sg, ns, [u])


def peek(sg: ShardedGraph, values: torch.Tensor, ns: NameServer, u: int):
    """The neighbours' values of vertex u (the paper's peek primitive):
    per out-edge slot of u's cell, the [S, Np] ``values`` at the edge's
    destination, NaN on other slots.  Returns [Ep] float32; a split hub's
    out-edges live across its member cells, so their rows concatenate
    ([R * Ep])."""
    rows = []
    for su, lu in ns.members_of(u) or [ns.resolve(u)]:
        mine = (sg.src_local[su] == lu) & sg.edge_ok[su]
        nb = values[sg.dst_shard[su].long(), sg.dst_local[su].long()]
        rows.append(torch.where(mine, nb.to(torch.float32), float("nan")))
    return rows[0] if len(rows) == 1 else torch.cat(rows)


# --------------------------------------------------------------------------
# Incremental SSSP over the primitives (dynamic graph processing)
# --------------------------------------------------------------------------

def _invalidate_subtrees(part: Partitioned, ns: NameServer, vstate,
                         root_gids):
    """Mark every vertex whose shortest-path tree passes through an
    invalidated root: chase the parent pointers through the global
    namespace until nothing changes (a host loop, one flag read a step)."""
    parent = vstate["parent"]            # [S, Np] parent gid, -1 = none
    dev = parent.device
    owner = torch.from_numpy(ns.owner).to(dev).long()
    local = torch.from_numpy(ns.local).to(dev).long()
    invalid = torch.zeros(parent.shape, dtype=torch.bool, device=dev)
    for g in root_gids:
        s, l = ns.resolve(int(g))
        invalid[s, l] = True
    has_parent = parent >= 0
    pg = parent.clamp(min=0).long()
    ps, pl = owner[pg], local[pg]
    while True:
        new = invalid | (invalid[ps, pl] & has_parent)
        changed = bool((new != invalid).any())
        invalid = new
        if not changed:
            return invalid


def incremental_sssp(part: Partitioned, ns: NameServer, vstate, source: int,
                     inserts=(), deletes=(), max_local_iters: int = 64):
    """Apply edge updates and repair the SSSP fixed point by re-diffusion.

    ``inserts``: (u, v, w) triples; ``deletes``: (u, v) pairs.  Returns
    (part with the updated graph, the repaired vstate, the repair
    diffusion's stats).  The fixed point is adopted into a transient
    session and one batch is committed through the session's repair path
    (the 'parents' strategy)."""
    from .diffuse import diffuse_from
    from .programs import sssp_program
    from .session import DiffusionSession

    sess = DiffusionSession(part, ns=ns, max_local_iters=max_local_iters)
    key = sess.adopt("sssp", vstate, source=source)
    batch = sess.update()
    for u, v in deletes:
        batch.delete_edge(u, v)
    for u, v, w in inserts:
        batch.add_edge(u, v, w)
    info = sess.commit()
    _, stats = info.repairs[key]
    vstate = sess.vertex_state("sssp", source=source)
    if stats is None:
        # an empty or all-phantom batch skips the repair; run the
        # (immediately quiescent) diffusion for real counters
        vstate, stats = diffuse_from(
            part.sg, sssp_program(source, track_parents=True), vstate,
            torch.zeros(vstate["dist"].shape, dtype=torch.bool,
                        device=vstate["dist"].device),
            max_local_iters=max_local_iters)
    return part, vstate, stats
