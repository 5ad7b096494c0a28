"""K1 as the per-destination tables: ``kernel.edge_relax_blocks`` of the
port against the JAX package's blocked Pallas kernel (interpret mode) and
its phase 2 (``ops._combine_blocks``), and the arithmetic of the CUDA
kernels' atomics (K1's sign-split 32-bit and packed 64-bit keys, K6's
folded frontier) emulated in numpy against the plain versions.

On the CPU the wrapper runs the plain version (the blocked partials and
``ref.combine_blocks``); the kernel itself is held against it on the card
in ``tests/test_torch_cuda.py``.  The emulations here pin what the kernel
computes: the atomics' order is random, min/max and integer counts are
order-free, so every order must give the plain version's bits — except
for -0.0, which the sign split ranks below +0.0 (shown below).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import NameServer, UpdateBatch
from repro.core import programs as jprograms
from repro.core.api import build as jbuild
from repro.core.diffuse import _sg_as_dict as j_sg_as_dict
from repro.core.generators import make_graph_family
from repro.kernels.edge_relax import kernel as jkernel
from repro.kernels.edge_relax import ops as jops
from repro_torch.core import programs as tprograms
from repro_torch.core.diffuse import _sg_as_dict as t_sg_as_dict
from repro_torch.core.graph import ShardedGraph
from repro_torch.kernels.edge_relax import kernel as tkernel
from repro_torch.kernels.edge_relax import ref as tref
from repro_torch.kernels.sssp_relax import ref as k6ref
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

torch.set_num_threads(1)

MINMAX = [
    ("sssp", {"source": 3}),
    ("sssp", {"source": 3, "track_parents": False}),
    ("bfs", {"source": 3}),
    ("cc", {}),
    ("widest", {"source": 3}),
    ("widest", {"source": 3, "track_parents": True}),
    ("reach", {"sources": (1, 5)}),
]
IDS = [f"{n}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
       for n, kw in MINMAX]


def _bits(a):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype.kind == "f" else a


def _graph(dirty: bool):
    """A JAX-built graph of 3 cells and its port twin; ``dirty`` adds
    tombstones and a staged (unsorted) delta segment in which one
    destination takes edges from several sources, so its key repeats
    across runs."""
    src, dst, w, n = make_graph_family("scale_free", 160, seed=11)
    part = jbuild(src, dst, n, w, n_cells=3, edge_slack=0.2)
    sg = part.sg
    if dirty:
        batch = UpdateBatch(NameServer(part))
        rng = np.random.default_rng(3)
        for i in rng.choice(src.shape[0], 12, replace=False):
            batch.delete_edge(int(src[i]), int(dst[i]))
        for i in range(12):
            v = int(dst[0]) if i % 2 else int(rng.integers(0, n))
            batch.add_edge(int(rng.integers(0, n)), v,
                           float(1 + 7 * rng.random()))
        sg, _ = batch.apply(sg)
        assert int(np.asarray(sg.delta_count).sum()) > 0
    tsg = ShardedGraph.from_state(
        {k: np.asarray(v) for k, v in sg.state_dict().items()},
        sg.meta_dict(), device="cpu")
    return sg, tsg


def _repeated_runs(key: np.ndarray, block_e: int) -> bool:
    """Whether some key opens two runs of one block."""
    for blk in key.reshape(-1, block_e):
        starts = blk[(blk >= 0) & (blk != np.r_[-2, blk[:-1]])]
        if np.unique(starts).size < starts.size:
            return True
    return False


@pytest.fixture(scope="module", params=[False, True], ids=["clean", "dirty"])
def graphs(request):
    return _graph(request.param)


def _state(jprog, shape, seed):
    """A random vertex state of the program's schema (values with +-inf
    entries) and a 60 % sending frontier."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, _ in jprog.fields:
        if k in ("dist", "width"):
            v = (rng.random(shape) * 40).astype(np.float32)
            v[rng.random(shape) < 0.2] = np.inf
            if k == "width":
                v[rng.random(shape) < 0.2] = -np.inf
        elif k == "reached":
            v = rng.integers(0, 2, shape).astype(np.int32)
        else:
            v = rng.integers(-1, 160, shape).astype(np.int32)
        out[k] = v
    return out, rng.random(shape) < 0.6


@pytest.mark.parametrize("name,kw", MINMAX, ids=IDS)
def test_k1_tables_match_pallas_blocks_and_combine(graphs, name, kw):
    """The wrapper's [S, n_keys] tables == the JAX blocked kernel
    (interpret) + its phase-2 scatter, bitwise on table, cnt and pay."""
    jsg, tsg = graphs
    jprog = jprograms.PROGRAMS[name].factory(**kw)
    tprog = tprograms.PROGRAMS[name].factory(**kw)
    state, senders = _state(jprog, (jsg.n_shards, jsg.n_per_shard), 2)
    jsgd, tsgd = j_sg_as_dict(jsg), t_sg_as_dict(tsg)
    n_keys = jsg.n_shards * jsg.n_per_shard
    if int(np.asarray(jsg.delta_count).sum()):
        assert _repeated_runs(tsgd["csr_key"].numpy(), jsg.csr_block)
    before = dict(tkernel.LAUNCHES)
    got = tkernel.edge_relax_blocks(
        tprog, {k: torch.from_numpy(v) for k, v in state.items()},
        torch.from_numpy(senders), tsgd["gid"], tsgd["csr_key"],
        tsgd["csr_src"], tsgd["csr_weight"], tsgd["csr_dst_gid"], n_keys)
    assert tkernel.LAUNCHES == before        # CPU tensors launch nothing
    assert got[0].shape == (jsg.n_shards, n_keys)
    assert (got[2] is None) == (not tprog.with_payload)
    for c in range(jsg.n_shards):
        parts = jkernel.edge_relax_blocks(
            jprog, {k: jnp.asarray(v[c]) for k, v in state.items()},
            jnp.asarray(senders[c]), jsgd["gid"][c], jsgd["csr_key"][c],
            jsgd["csr_src"][c], jsgd["csr_weight"][c],
            jsgd["csr_dst_gid"][c], block_e=jsg.csr_block, interpret=True)
        pay = parts[3] if len(parts) == 4 else None
        want = jops._combine_blocks(*parts[:3], pay, n_keys, jprog.combine,
                                    jprog.msg_dtype)
        for g, w, what in zip(got, want, ("table", "cnt", "pay")):
            assert (g is None) == (w is None), what
            if w is not None:
                assert np.array_equal(_bits(g[c]), _bits(w)), \
                    f"cell {c} {what}"


# --------------------------------------------------------------------------
# the kernels' atomics, emulated
# --------------------------------------------------------------------------

_SIGN = np.uint32(0x80000000)
_FULL = np.uint32(0xFFFFFFFF)


def _ord(x) -> np.uint32:
    """The order-preserving 32-bit image of a float32 or int32 scalar."""
    if isinstance(x, np.floating):
        b = np.float32(x).view(np.uint32)
        return ~b if b & _SIGN else b | _SIGN
    return np.int32(x).view(np.uint32) ^ _SIGN


def _from_ord(u: np.uint32, dtype):
    if dtype == np.float32:
        return (u & np.uint32(0x7FFFFFFF) if u & _SIGN else ~u).view(
            np.float32)
    return (u ^ _SIGN).view(np.int32)


def emulate_k1(part, cnt, uniq, pay, n_keys: int, combine: str, rng):
    """K1's atomics over run partials ``part``/``cnt``/``uniq``/``pay`` [R]
    in a random order: runs with cnt 0 or a key outside [0, n_keys)
    skipped, counts added, the messages folded by the sign-split 32-bit
    atomics (no payload) or as 64-bit keys ord(v) << 32 | lo, lo = ord(p)
    (max) or ~ord(p) (min), unpacked after (the epilogue)."""
    mx = combine == "max"
    dt = part.dtype
    ident = (dt.type(-np.inf) if mx else dt.type(np.inf)) \
        if dt == np.float32 else np.iinfo(np.int32).min if mx \
        else np.iinfo(np.int32).max
    table = np.full(n_keys, ident, dt)
    cnt_t = np.zeros(n_keys, np.int32)
    best = np.full(n_keys, 0 if mx else np.iinfo(np.uint64).max, np.uint64)
    for r in rng.permutation(part.shape[0]):
        k = int(uniq[r])
        if cnt[r] == 0 or not 0 <= k < n_keys:
            continue
        cnt_t[k] += cnt[r]
        if pay is not None:
            lo = _ord(np.int32(pay[r]))
            lo = lo if mx else _FULL - lo
            key = (np.uint64(_ord(part[r])) << np.uint64(32)) | np.uint64(lo)
            best[k] = max(best[k], key) if mx else min(best[k], key)
        elif dt == np.int32:
            table[k] = max(table[k], part[r]) if mx else min(table[k],
                                                             part[r])
        else:
            tb = table.view(np.int32)[k:k + 1]
            b = np.float32(part[r]).view(np.int32)
            if b >= 0:                       # signed int min/max
                tb[0] = max(tb[0], b) if mx else min(tb[0], b)
            else:                            # unsigned max/min, reversed
                ub, ut = np.uint32(b.view(np.uint32)), tb.view(np.uint32)
                ut[0] = min(ut[0], ub) if mx else max(ut[0], ub)
    pay_t = None
    if pay is not None:
        pay_t = np.full(n_keys, -1, np.int32)
        for k in np.nonzero(cnt_t > 0)[0]:
            u = np.uint64(best[k])
            table[k] = _from_ord(np.uint32(u >> np.uint64(32)), dt)
            lo = np.uint32(u & np.uint64(0xFFFFFFFF))
            pay_t[k] = _from_ord(lo if mx else _FULL - lo, np.int32)
    return table, cnt_t, pay_t


def _run_partials(dtype, combine: str, payload: bool, n_keys: int,
                  r: int, rng):
    """Random run partials as block_combine leaves them: a sending run
    (cnt > 0) holds a message from a small set (ties, negative floats,
    +-inf, int32 extremes) and a payload in [-1, 20]; a silent one the
    identity, 0 and -1; some keys -1 or past n_keys."""
    mx = combine == "max"
    if dtype == np.float32:
        pool = np.array([-7.5, -3.0, -3.0, -0.25, 0.0, 0.5, 2.0, 2.0, 9.0,
                         np.inf, -np.inf], np.float32)
        ident = np.float32(-np.inf if mx else np.inf)
    else:
        i32 = np.iinfo(np.int32)
        pool = np.array([i32.min, -40, -3, -3, 0, 1, 5, 5, 70, i32.max],
                        np.int32)
        ident = i32.min if mx else i32.max
    cnt = np.where(rng.random(r) < 0.3, 0, rng.integers(1, 6, r))
    part = np.where(cnt > 0, rng.choice(pool, r), ident).astype(dtype)
    uniq = rng.integers(-1, n_keys + 3, r).astype(np.int32)
    pay = None
    if payload:
        pay = np.where(cnt > 0, rng.integers(-1, 21, r), -1).astype(np.int32)
    return part, cnt.astype(np.int32), uniq, pay


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("payload", [False, True], ids=["values", "payload"])
@pytest.mark.parametrize("combine", ["min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32],
                         ids=["f32", "i32"])
def test_k1_atomics_in_any_order_equal_combine_blocks(dtype, combine,
                                                      payload, seed):
    rng = np.random.default_rng(seed)
    n_keys, r = 37, 900
    part, cnt, uniq, pay = _run_partials(dtype, combine, payload, n_keys, r,
                                         rng)
    as_t = lambda a: None if a is None else torch.from_numpy(a).view(
        1, 1, -1)
    want = tref.combine_blocks(as_t(part), as_t(cnt), as_t(uniq), as_t(pay),
                               n_keys, combine)
    for _ in range(3):                       # three orders of the atomics
        got = emulate_k1(part, cnt, uniq, pay, n_keys, combine, rng)
        for g, w, what in zip(got, want, ("table", "cnt", "pay")):
            assert (g is None) == (w is None), what
            if w is not None:
                assert np.array_equal(_bits(g), _bits(w[0])), what


def test_sign_split_ranks_negative_zero_below_positive_zero():
    """Two sending runs of one key holding +0.0 and -0.0: the kernel's
    sign-split atomics give -0.0 for min and +0.0 for max in either order
    (and, with the payload, the payload of that zero), while the plain
    scatter keeps whichever zero comes first and, since the two compare
    equal, the max payload of both.  No builtin emits -0.0 (ROADMAP
    queue 3)."""
    rng = np.random.default_rng(0)
    uniq = np.zeros(2, np.int32)
    cnt = np.ones(2, np.int32)
    for combine, zero_bits in (("min", np.int32(-2 ** 31)),
                               ("max", np.int32(0))):
        plain = set()
        for vals in ([0.0, -0.0], [-0.0, 0.0]):
            part = np.array(vals, np.float32)
            pay = np.array([5, 3] if vals[0] == 0.0 and not np.signbit(
                vals[0]) else [3, 5], np.int32)   # +0.0 carries 5
            for p in (None, pay):
                got = emulate_k1(part, cnt, uniq, p, 1, combine, rng)
                assert _bits(got[0])[0] == zero_bits
                if p is not None:
                    want_pay = 3 if combine == "min" else 5
                    assert got[2][0] == want_pay
            t = tref.combine_blocks(
                *(torch.from_numpy(a).view(1, 1, -1) for a in (
                    part, cnt, uniq, pay)), 1, combine)
            assert float(t[0][0, 0]) == 0.0 and int(t[2][0, 0]) == 5
            plain.add(int(_bits(t[0])[0, 0]))
        assert plain == {0, -2 ** 31}        # the first zero to land wins


@pytest.mark.parametrize("e,hub", [(4099, False), (20000, True),
                                   (1024, True)])
def test_k6_folded_frontier_equals_relax_ref(e, hub):
    """K6 gathers dm = active ? dist : +inf and drops runs whose min is
    not below +inf: emulated, that equals ``ref.relax_ref`` bitwise (a
    message from an inactive source is inf + w = inf, never sent)."""
    rng = np.random.default_rng(e)
    np_, n = 300, 900
    dist = np.where(rng.random(np_) < 0.7, rng.random(np_) * 10,
                    np.inf).astype(np.float32)
    active = rng.random(np_) < 0.5
    src = rng.integers(-2, np_ + 2, e).astype(np.int32)
    w = (rng.random(e) * 5).astype(np.float32)
    if hub:
        lengths = [11, e // 3] + rng.integers(1, 30, e).tolist()
        ids = np.repeat(np.arange(len(lengths)), lengths)[:e]
        dst = np.where(ids == 0, -1, np.sort(rng.integers(
            0, n + 40, ids[-1] + 1))[ids]).astype(np.int32)
    else:
        dst = np.sort(rng.integers(-1, n + 40, e)).astype(np.int32)
    dm = np.where(active, dist, np.float32(np.inf))
    s = np.clip(src, 0, np_ - 1)
    live = (dst >= 0) & (dst < n)
    cand = dm[s] + w
    out = np.full(n, np.inf, np.float32)
    keep = live & (cand < np.inf)
    np.minimum.at(out, dst[keep], cand[keep])
    want = k6ref.relax_ref(*(torch.from_numpy(a) for a in (
        dist, w, src, dst, active)), n)
    assert np.array_equal(_bits(out), _bits(want))
