"""The port's CUDA kernels on a GPU (marked ``cuda``; skipped without one).

Run on a machine with the card (no JAX needed):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain version on the same CUDA inputs —
K1-K3, K5 and K6 bitwise (K1's tables against the plain partials + phase
2, also on hub runs and repeated keys over five launches; K3 at
compaction caps with fill slots, K2 in both
input modes for every builtin's instance, solo and with 4 or 5 lanes on 4
cells; K5 in f32 and bf16, with the gather fused, over five launches), K4
within the tolerance stated at its tests — the
session on the card (pull, push and auto sweeps, and a commit's repairs)
against the session on the CPU, and the LM's prefill and decode on the
card against the CPU, and the same for a hub-split session, the triangle
count and the watchdog; the generic instances (programs without a
KernelEmit: the builtins stripped of theirs and user programs, a custom
monoid op and identity) bitwise their plain versions, a division by a
constant as torch's CUDA kernel does it, and the quickstart's reliability
through the session (push and auto bitwise pull, lanes bitwise solo, a
commit bitwise a fresh query).  Durability on the card: ``open(device=
"cuda")`` puts every tensor there, save + commits + open on the card is
bitwise the live session, the merge compaction is bitwise the full sort,
and a CPU and a CUDA session with one history write snapshots with equal
digests (graph, partition, NameServer, min/max entries; ppr within its
eps)."""

import numpy as np
import pytest
import torch

from repro_torch.core import DiffusionSession
from repro_torch.core.diffuse import _sg_as_dict
from repro_torch.core.generators import make_graph_family
from repro_torch.core.programs import PROGRAMS, make_laned
from repro_torch.core.relax import active_push_blocks, push_caps, select_bucket
from repro_torch.kernels.edge_relax import kernel, ops, ref

pytestmark = pytest.mark.cuda

MINMAX = [("sssp", {"source": 1}), ("sssp", {"source": 1,
                                             "track_parents": False}),
          ("bfs", {"source": 1}), ("cc", {}), ("widest", {"source": 1}),
          ("widest", {"source": 1, "track_parents": True}),
          ("reach", {"sources": (1, 2)})]


@pytest.fixture(scope="module")
def gpu_session():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    src, dst, w, n = make_graph_family("scale_free", 3000, seed=0)
    return DiffusionSession.from_edges(src, dst, n, w, n_cells=4,
                                       device="cuda"), (src, dst, w, n)


def _args(sess, prog, vstate, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    senders = (torch.rand(tuple(sess.sg.node_ok.shape), generator=g) < 0.5)
    senders = senders.to(sess.device) & sess.sg.node_ok
    sgd = _sg_as_dict(sess.sg)
    return (prog, vstate, senders, sgd["gid"], sgd["csr_key"],
            sgd["csr_src"], sgd["csr_weight"], sgd["csr_dst_gid"])


def _k1_plain(args, n_keys):
    """K1's plain version: the blocked partials and their scatter."""
    return ref.combine_blocks(
        *ref.edge_relax_blocks_ref(*args, block_e=kernel.BLOCK_E), n_keys,
        args[0].combine)


@pytest.mark.parametrize("name,kw", MINMAX)
def test_k1_kernel_matches_plain_bitwise(gpu_session, name, kw):
    """K1's per-destination tables against the plain partials + phase 2."""
    sess, _ = gpu_session
    prog = PROGRAMS[name].factory(**kw)
    sess.query(name, **kw)
    args = _args(sess, prog, sess.vertex_state(name, **kw), 3)
    n_keys = sess.sg.n_shards * sess.sg.n_per_shard
    n0 = kernel.LAUNCHES["edge_relax_blocks"]
    got = kernel.edge_relax_blocks(*args, n_keys)
    assert kernel.LAUNCHES["edge_relax_blocks"] == n0 + 1
    want = _k1_plain(args, n_keys)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.shape == (sess.sg.n_shards, n_keys)
            assert torch.equal(g, w)


def _k1_streams(cells, width, np_, seed, tail_keys):
    """K2's hub stream at a width that is a multiple of 128 (hub runs over
    whole 1024-position tiles, a tenth tombstoned, which splits runs of one
    key), its last 384 positions an unsorted tail of ``tail_keys`` keys
    drawn from the stream (a staged delta segment: one key in several runs
    of a tile).  Returns key, src, weight, gid."""
    key, skey, src, weight, gid = _hub_stream(cells, width, np_, seed)
    rng = np.random.default_rng(seed + 1)
    for c in range(cells):
        pick = rng.choice(skey[c, :width - 384].cpu().numpy(), tail_keys)
        key[c, width - 384:] = torch.from_numpy(
            rng.choice(pick, 384).astype(np.int32)).cuda()
    return key, src, weight, gid


@pytest.mark.parametrize("tail_keys", [2, 40])
@pytest.mark.parametrize("name,kw", MINMAX)
def test_k1_hub_stream_bitwise_and_repeatable(cuda, name, kw, tail_keys):
    """K1 on hub runs over many whole tiles and on one key in several runs
    of a tile, with n_keys below the stream's largest keys (dropped):
    bitwise against the plain version over five launches (the atomics
    land in any order)."""
    key, src, weight, gid = _k1_streams(4, 40 * 1024 + 3 * 128, 4096, 21,
                                        tail_keys)
    prog = PROGRAMS[name].factory(**kw)
    vstate, senders = _random_state(prog, tuple(gid.shape), 13)
    args = (prog, vstate, senders, gid, key, src, weight, key)
    n_keys = gid.numel() - 300
    want = _k1_plain(args, n_keys)
    runs = [kernel.edge_relax_blocks(*args, n_keys) for _ in range(5)]
    torch.cuda.synchronize()
    assert int(want[1].sum()) > 0
    for got in runs:
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                assert torch.equal(g, w)


def test_k1_refuses_unaligned_rows(gpu_session):
    """K1's 16-byte loads: a row stride that is no multiple of 4 raises
    (no scalar fallback)."""
    sess, _ = gpu_session
    prog = PROGRAMS["sssp"].factory(source=1)
    sess.query("sssp", source=1)
    args = list(_args(sess, prog, sess.vertex_state("sssp", source=1), 3))
    w = args[4].shape[-1]
    wide = lambda a: torch.nn.functional.pad(a, (0, 2))[..., :w]
    args[4:] = [wide(a) for a in args[4:]]
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernel.edge_relax_blocks(*args, sess.sg.n_shards * sess.sg.n_per_shard)


@pytest.mark.parametrize("name,kw", [("ppr", {"source": 1}),
                                     ("pagerank", {})])
def test_k2_kernel_matches_plain_bitwise_and_repeats(gpu_session, name, kw):
    sess, _ = gpu_session
    prog = PROGRAMS[name].factory(**kw)
    vstate, _ = prog.init(sess.sg)
    rng = np.random.default_rng(5)
    res = rng.random(tuple(vstate["residual"].shape)).astype(np.float32)
    vstate = dict(vstate, residual=torch.from_numpy(res).cuda() * 1e-3)
    args = list(_args(sess, prog, vstate, 4))
    es = sess.sg.sorted_width
    args[4:] = [a[..., :es] for a in args[4:]]
    skey = sess.sg.csr_key[..., :es]
    v1, c1, _ = kernel.edge_relax_scan(*args, skey=skey)
    v2, c2, _ = kernel.edge_relax_scan(*args, skey=skey)
    vr, cr, _ = ref.edge_relax_scan_ref(*args, skey=skey)
    torch.cuda.synchronize()
    assert torch.equal(v1, v2) and torch.equal(c1, c2)
    assert torch.equal(v1, vr) and torch.equal(c1, cr)


def test_session_on_gpu_matches_cpu(gpu_session):
    sess, (src, dst, w, n) = gpu_session
    cpu = DiffusionSession.from_edges(src, dst, n, w, n_cells=4,
                                      device="cpu")
    kernel.reset_launches()
    for name, kw in MINMAX + [("ppr", {"source": 1}), ("pagerank", {})]:
        a = sess.query(name, refresh=True, **kw)
        b = cpu.query(name, **kw)
        if name in ("ppr", "pagerank"):
            np.testing.assert_allclose(a.values, b.values, rtol=0, atol=1e-6)
        else:
            assert np.array_equal(a.values, b.values), name
            for k in b.extra:
                assert np.array_equal(a.extra[k], b.extra[k]), (name, k)
            assert int(a.stats.actions) == int(b.stats.actions), name
    assert kernel.LAUNCHES["edge_relax_blocks"] > 0
    assert kernel.LAUNCHES["edge_relax_scan"] > 0


@pytest.mark.parametrize("frac", [0.001, 0.05, 1.0])
@pytest.mark.parametrize("name,kw", MINMAX)
def test_k3_kernel_matches_plain_bitwise(gpu_session, name, kw, frac):
    sess, _ = gpu_session
    prog = PROGRAMS[name].factory(**kw)
    sess.query(name, **kw)
    vstate = sess.vertex_state(name, **kw)
    g = torch.Generator(device="cpu").manual_seed(7)
    senders = torch.rand(tuple(sess.sg.node_ok.shape), generator=g) < frac
    senders = senders.to(sess.device) & sess.sg.node_ok
    sgd = _sg_as_dict(sess.sg, with_push=True)
    nb = sgd["push_src"].shape[-1] // kernel.BLOCK_E
    count = int(active_push_blocks(senders, sgd["push_src"], 128).max())
    for cap in sorted({push_caps(nb)[select_bucket(count, nb, "push")], nb}):
        idx, valid = ref.compact_push_blocks(senders, sgd["push_src"], 128,
                                             cap)
        args = (prog, vstate, senders, sgd["gid"], sgd["push_key"],
                sgd["push_src"], sgd["push_weight"], sgd["push_dst_gid"],
                idx)
        n0 = kernel.LAUNCHES["edge_relax_push_blocks"]
        got = kernel.edge_relax_push_blocks(*args)
        assert kernel.LAUNCHES["edge_relax_push_blocks"] == n0 + 1
        want = ref.edge_relax_push_blocks_ref(*args, block_e=128)
        torch.cuda.synchronize()
        for a, b in zip(got, want):          # raw, fill slots included
            assert (a is None) == (b is None)
            if b is not None:
                assert torch.equal(a, b)
        for a, b in zip(ops._mask_fill_blocks(*got, valid),
                        ops._mask_fill_blocks(*want, valid)):
            assert (a is None and b is None) or torch.equal(a, b)


def test_k2_pre_emitted_mode_matches_stream_scan(gpu_session):
    sess, _ = gpu_session
    es = sess.sg.sorted_width
    skey = sess.sg.csr_key[..., :es]
    g = torch.Generator(device="cpu").manual_seed(3)
    cand = (torch.rand(tuple(skey.shape), generator=g) * 1e-3).cuda()
    send = (torch.rand(tuple(skey.shape), generator=g) < 0.3).cuda()
    cand = torch.where(send, cand, 0.0)
    monoid = PROGRAMS["pagerank"].factory().monoid
    n0 = kernel.LAUNCHES["edge_relax_scan"]
    v1, c1, _ = kernel.edge_relax_scan_pre(monoid, cand, send, skey)
    v2, c2, _ = kernel.edge_relax_scan_pre(monoid, cand, send, skey)
    assert kernel.LAUNCHES["edge_relax_scan"] == n0 + 2
    vr, cr, _ = ref.stream_scan(monoid, cand, send, skey)
    torch.cuda.synchronize()
    assert torch.equal(v1, v2) and torch.equal(c1, c2)
    assert torch.equal(v1, vr) and torch.equal(c1, cr)


def _random_state(prog, shape, seed):
    """A random vertex state of the program's schema and a 50 % sending
    frontier, both of ``shape`` ([S, Np] or [S, L, Np]), on the card."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    rand = lambda: torch.rand(shape, generator=g)
    out = {}
    for k, f in prog.fields:
        if k in ("dist", "width"):
            v = torch.where(rand() < 0.2, float("inf"), rand() * 40)
            if k == "width":
                v = torch.where(rand() < 0.2, float("-inf"), v)
        elif k in ("rank", "residual"):
            v = rand() * 1e-3
        elif k == "deg":
            v = torch.randint(1, 9, shape, generator=g).float()
        elif k == "reached":
            v = (rand() < 0.5).int()
        else:
            v = torch.randint(-1, 3000, shape, generator=g, dtype=torch.int32)
        out[k] = v.to(f.dtype).cuda()
    return out, (rand() < 0.5).cuda()


SCAN_CASES = MINMAX + [("ppr", {"source": 1}), ("pagerank", {})]


@pytest.mark.parametrize("lanes", [None, 4, 5], ids=["solo", "L4", "L5"])
@pytest.mark.parametrize("name,kw", SCAN_CASES)
def test_k2_every_instance_matches_plain_bitwise(gpu_session, name, kw,
                                                 lanes):
    """Both input modes of K2 for each builtin's (form, monoid, dtype,
    payload) instance, solo and laned (L equal to and different from the
    4 cells), against the plain versions, and each mode against the
    other."""
    sess, _ = gpu_session
    prog = PROGRAMS[name].factory(**kw)
    if lanes:
        prog = make_laned([prog] * lanes)
    S, Np = sess.sg.node_ok.shape
    shape = (S, Np) if lanes is None else (S, lanes, Np)
    vstate, senders = _random_state(prog, shape, 11)
    sgd = _sg_as_dict(sess.sg)
    es = sess.sg.sorted_width
    args = (prog, vstate, senders, sgd["gid"]) + tuple(
        sgd[k][..., :es] for k in ("csr_key", "csr_src", "csr_weight",
                                   "csr_dst_gid"))
    skey = sgd["csr_skey"][..., :es]
    kernel.reset_launches()
    got = kernel.edge_relax_scan(*args, skey=skey)
    want = ref.edge_relax_scan_ref(*args, skey=skey)
    cand, send, pay = ref.edge_messages(*args)
    pre = kernel.edge_relax_scan_pre(prog.monoid, cand, send, skey, pay)
    pre_want = ref.stream_scan(prog.monoid, cand, send, skey, pay)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["edge_relax_scan"] == 2
    variant = ("sum" if prog.combine == "sum" else "min/max") + (
        "+payload" if prog.with_payload else "") + ("/laned" if lanes else "")
    assert kernel.SCAN_LAUNCHES[variant] == 2
    for out in (got, want, pre, pre_want):
        assert out[0].shape == shape[:-1] + (es,)
        assert (out[2] is None) == (not prog.with_payload)
    for a, b, c, d in zip(got, want, pre, pre_want):
        if b is not None:
            assert torch.equal(a, b) and torch.equal(c, d)
            assert torch.equal(a, c)


def _hub_stream(cells, width, np_, seed):
    """A synthetic destination-sorted stream [cells, width] on the card:
    per cell a hub run of 3.5 tiles from position 0, short runs, a hub of
    4 tiles that opens mid-tile, then short runs; a tenth of the
    positions tombstoned (``key`` -1, ``skey`` keeps the run)."""
    rng = np.random.default_rng(seed)
    tile = ref.SCAN_TILE
    skey, key = [], []
    for c in range(cells):
        lengths = [3 * tile + tile // 2]
        lengths += rng.integers(1, 40, 100 + c).tolist()
        lengths += [4 * tile + 3]
        lengths += rng.integers(1, 60, width).tolist()
        ids = np.repeat(np.arange(len(lengths)), lengths)[:width]
        ids = np.sort(rng.choice(cells * np_, ids[-1] + 1,
                                 replace=False))[ids]
        skey.append(ids)
        key.append(np.where(rng.random(width) < 0.1, -1, ids))
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.int32)).cuda()
    src = rng.integers(0, np_, (cells, width))
    weight = torch.from_numpy(
        (1 + 7 * rng.random((cells, width))).astype(np.float32)).cuda()
    gid = as_t(np.arange(cells * np_).reshape(cells, np_))
    return as_t(key), as_t(skey), as_t(src), weight, gid


@pytest.mark.parametrize("lanes", [None, 1, 4, 5, 16],
                         ids=["solo", "L1", "L4", "L5", "L16"])
@pytest.mark.parametrize("name,kw", SCAN_CASES)
def test_k2_hub_stream_bitwise_and_repeatable(cuda, name, kw, lanes):
    """K2 in both input modes on a stream whose hub runs span 3 and 4 whole
    tiles (the look-back walks over them), bitwise against the plain
    versions, one launch per call, and five repeated launches bitwise
    equal (tiles run in any order)."""
    S, E, Np = 4, 12 * ref.SCAN_TILE + 77, 3000
    key, skey, src, weight, gid = _hub_stream(S, E, Np, 17)
    prog = PROGRAMS[name].factory(**kw)
    if lanes:
        prog = make_laned([prog] * lanes)
    shape = (S, Np) if lanes is None else (S, lanes, Np)
    vstate, senders = _random_state(prog, shape, 23)
    args = (prog, vstate, senders, gid, key, src, weight, key)
    kernel.reset_launches()
    runs = [kernel.edge_relax_scan(*args, skey=skey) for _ in range(5)]
    assert kernel.LAUNCHES["edge_relax_scan"] == 5
    want = ref.edge_relax_scan_ref(*args, skey=skey)
    cand, send, pay = ref.edge_messages(*args)
    pre = [kernel.edge_relax_scan_pre(prog.monoid, cand, send, skey, pay)
           for _ in range(5)]
    pre_want = ref.stream_scan(prog.monoid, cand, send, skey, pay)
    torch.cuda.synchronize()
    for out in runs + pre:
        for a, b, c in zip(out, want, pre_want):
            assert (a is None) == (b is None)
            if b is not None:
                assert torch.equal(a, b) and torch.equal(b, c)


def test_push_sweeps_and_commit_on_gpu_match_cpu(gpu_session):
    _, (src, dst, w, n) = gpu_session
    kw = dict(n_cells=4, edge_slack=0.2, node_slack=0.05)
    gpu = DiffusionSession.from_edges(src, dst, n, w, device="cuda", **kw)
    cpu = DiffusionSession.from_edges(src, dst, n, w, device="cpu", **kw)
    kernel.reset_launches()
    for sweep in ("push", "auto"):
        for name, q in MINMAX + [("ppr", {"source": 1})]:
            a = gpu.query(name, sweep=sweep, **q)
            b = cpu.query(name, sweep=sweep, **q)
            if name == "ppr":
                np.testing.assert_allclose(a.values, b.values, rtol=0,
                                           atol=1e-6)
                continue
            assert np.array_equal(a.values, b.values), (name, sweep)
            assert int(a.stats.push_iters) == int(b.stats.push_iters)
    assert kernel.LAUNCHES["edge_relax_push_blocks"] > 0
    rng = np.random.default_rng(2)
    for sess in (gpu, cpu):
        for name, q in (("sssp", {"source": 1}), ("cc", {})):
            sess.query(name, **q)
    live = list(zip(src.tolist(), dst.tolist()))
    dels = [live[i] for i in rng.choice(len(live), 20, replace=False)]
    ins = [(int(a), int(b), 2.5) for a, b in rng.integers(0, n, (20, 2))]
    for sess in (gpu, cpu):
        for u, v in dels:
            sess.delete_edge(u, v)
        for u, v, x in ins:
            sess.add_edge(u, v, x)
        sess.touch(5)
    a_info, b_info = gpu.commit(), cpu.commit()
    assert a_info.applied == b_info.applied
    for k, arr in cpu.sg.state_dict().items():
        assert torch.equal(gpu.sg.state_dict()[k].cpu(), arr), k
    for name, q in (("sssp", {"source": 1}), ("cc", {})):
        a, b = gpu.query(name, **q), cpu.query(name, **q)
        assert np.array_equal(a.values, b.values), name
        assert int(a.stats.push_iters) == int(b.stats.push_iters)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_split_session_triangles_and_watchdog_on_gpu_match_cpu(cuda):
    """Hub replicas on the card: every sweep, a laned query and a commit
    around a hub give the CPU session's bits (sums: 1e-6); the triangle
    count and the watchdog behave as on the CPU."""
    from repro_torch.core import ConvergenceError

    src, dst, w, n = make_graph_family("scale_free", 3000, seed=0)
    kw = dict(n_cells=4, edge_slack=0.2, node_slack=0.05,
              replica_threshold=64)
    gpu = DiffusionSession.from_edges(src, dst, n, w, device="cuda", **kw)
    cpu = DiffusionSession.from_edges(src, dst, n, w, device="cpu", **kw)
    assert gpu.part.replica is not None
    kernel.reset_launches()
    for sweep in ("pull", "push", "auto"):
        for name, q in MINMAX + [("ppr", {"source": 1}), ("pagerank", {})]:
            a = gpu.query(name, sweep=sweep, **q)
            b = cpu.query(name, sweep=sweep, **q)
            if name in ("ppr", "pagerank"):
                np.testing.assert_allclose(a.values, b.values, rtol=0,
                                           atol=1e-6)
                continue
            assert np.array_equal(a.values, b.values), (name, sweep)
            for k in b.extra:
                assert np.array_equal(a.extra[k], b.extra[k]), (name, k)
            assert int(a.stats.actions) == int(b.stats.actions)
    lanes = gpu.query("sssp", sources=[1, 7, 99], refresh=True)
    for root, lane in zip((1, 7, 99), lanes):
        assert np.array_equal(lane.values,
                              cpu.query("sssp", source=root).values)
    for k in ("edge_relax_blocks", "edge_relax_scan",
              "edge_relax_push_blocks"):
        assert kernel.LAUNCHES[k] > 0, k
    hub = int(gpu.part.replica.hub_gid[0])
    for sess in (gpu, cpu):
        sess.max_cache_entries = 2
        sess.query("sssp", source=1, refresh=True)
        sess.query("cc", refresh=True)
        for v in (3, 50, 400):
            sess.add_edge(v, hub, 0.5)
            sess.add_edge(hub, v, 0.5)
        sess.delete_edge(int(src[np.flatnonzero(src == hub)[0]]),
                         int(dst[np.flatnonzero(src == hub)[0]]))
        sess.delete_vertex(77)
    a_info, b_info = gpu.commit(), cpu.commit()
    assert a_info.applied == b_info.applied
    for k, arr in cpu.sg.state_dict().items():
        assert torch.equal(gpu.sg.state_dict()[k].cpu(), arr), k
    for name, q in (("sssp", {"source": 1}), ("cc", {})):
        a, b = gpu.query(name, **q), cpu.query(name, **q)
        assert np.array_equal(a.values, b.values), name
    assert gpu.query("triangles").extra == cpu.query("triangles").extra
    cut = DiffusionSession(gpu.part, max_rounds=1, on_budget="raise")
    with pytest.raises(ConvergenceError):
        cut.query("sssp", source=1)
    gpu.query("sssp", source=1, validate=True)


# K4's tolerance against its plain version ``flash_attention_ref``.  f32:
# 2e-5 max abs (the same online softmax, sums in other orders).  bf16, per
# element: |got - want| <= 2^-7 |want| + 2^-8 A + 2e-5, where A is
# ``flash_attention_ref(q, k, |v|)`` under the same masks.  The kernel
# rounds P to bf16 before P V (the plain version keeps it in f32): each
# weight moves by at most 2^-9 of itself, so an output moves by at most
# 2^-9 (sum_j p_j |v_j|) / l = 2^-9 A; the limit takes twice that, one
# bf16 ulp of the output (2^-7 relative: both sides round their f32 result
# once) and the f32 limit.  An output near zero averages |v| of order 1,
# so a limit without the A term would fail there.
K4_F32_TOL = 2e-5


def _k4_ok(got, want, q, k, v, **kw):
    from repro_torch.kernels.flash_attention import ref as r4

    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        return bool((diff <= K4_F32_TOL).all()), float(diff.max())
    a = r4.flash_attention_ref(q, k, v.abs(), **kw).float()
    limit = 2.0 ** -7 * want.float().abs() + 2.0 ** -8 * a + K4_F32_TOL
    return bool((diff <= limit).all()), float(diff.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,sq,skv,d,causal,softcap", [
    (4, 4, 128, 128, 64, True, 0.0), (8, 1, 200, 200, 64, True, 30.0),
    (4, 2, 100, 260, 128, True, 0.0), (4, 4, 64, 64, 128, False, 30.0),
    (32, 4, 1, 77, 64, True, 0.0)])
def test_k4_kernel_matches_plain(cuda, dtype, hq, hkv, sq, skv, d, causal,
                                 softcap):
    """Within the tolerance of :func:`_k4_ok` (f32 2e-5; bf16 with the P
    rounding term)."""
    from repro_torch.kernels.flash_attention import kernel as k4, ref as r4

    g = torch.Generator(device="cpu").manual_seed(sq + skv + d)
    q, k, v = (torch.randn(shape, generator=g).to(cuda, dtype) for shape in
               ((2, hq, sq, d), (2, hkv, skv, d), (2, hkv, skv, d)))
    kw = dict(causal=causal, softcap=softcap, q_offset=skv - sq)
    n0 = k4.LAUNCHES["flash_attention"]
    got = k4.flash_attention(q, k, v, **kw)
    assert k4.LAUNCHES["flash_attention"] == n0 + 1
    want = r4.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    ok, err = _k4_ok(got, want, q, k, v, **kw)
    assert ok, err


@pytest.mark.parametrize("kv_len", [None, 150, 0], ids=["full", "kv150",
                                                        "kv0"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", [(192, 192), (100, 300)])
@pytest.mark.parametrize("groups", [1, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_k4_bf16_wgmma_within_the_stated_tolerance(cuda, d, groups, sq, skv,
                                                   causal, softcap, kv_len):
    """The bf16 kernel over phase 2b's grid, with kv_len masks: kv_len 150
    at sq == skv leaves the causal rows 0..149 partly and, with q_offset
    -60 as well, rows that see no key (output 0); kv_len 0 masks every
    row.  The launch counter moves once per call."""
    from repro_torch.kernels.flash_attention import kernel as k4, ref as r4

    g = torch.Generator(device="cpu").manual_seed(d + groups + sq)
    q, k, v = (torch.randn(shape, generator=g).to(cuda, torch.bfloat16)
               for shape in ((2, 2 * groups, sq, d), (2, 2, skv, d),
                             (2, 2, skv, d)))
    offsets = [skv - sq] if kv_len is None else [skv - sq, -60]
    for off in offsets:
        kw = dict(causal=causal, softcap=softcap, kv_len=kv_len,
                  q_offset=off)
        n0 = k4.LAUNCHES["flash_attention"]
        got = k4.flash_attention(q, k, v, **kw)
        assert k4.LAUNCHES["flash_attention"] == n0 + 1
        want = r4.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        ok, err = _k4_ok(got, want, q, k, v, **kw)
        assert ok, (off, err)
        dead = want.float().abs().amax(dim=-1) == 0
        if kv_len == 0 or (causal and off < 0):
            assert bool(dead.any())
        assert bool((got.float().abs().amax(dim=-1)[dead] == 0).all())


def test_k4_kernel_kv_len_and_dead_rows(cuda):
    from repro_torch.kernels.flash_attention import kernel as k4, ref as r4

    g = torch.Generator(device="cpu").manual_seed(1)
    q, k, v = (torch.randn(s, generator=g).to(cuda) for s in
               ((1, 4, 96, 64), (1, 2, 160, 64), (1, 2, 160, 64)))
    for kv_len, off in ((70, 0), (160, -30), (0, 0)):
        got = k4.flash_attention(q, k, v, causal=True, kv_len=kv_len,
                                 q_offset=off)
        want = r4.flash_attention_ref(q, k, v, causal=True, kv_len=kv_len,
                                      q_offset=off)
        assert float((got - want).abs().max()) <= 2e-5
    with pytest.raises(ValueError, match="head dims"):
        k4.flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                           v[..., :32].contiguous())


def _k5_bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("f", [1, 70, 128, 640])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_kernel_matches_plain(cuda, dtype, f):
    """Bitwise its plain version (the fixed order: row-order groups of
    ``CHUNK`` rows, their sums grouped and folded again, one rounding) on
    a sorted stream with -1 first, empty segments, a hub of three groups
    and 5 rows, one of more than ``CHUNK**2`` rows (three levels), and ids
    >= N last: on the presorted values, with the gather fused (``order``),
    and on rows with a stride (one column at a time); five repeated
    launches give equal bits; one launch counted a call."""
    from repro_torch.kernels.segment_reduce import kernel as k5

    g = torch.Generator(device="cpu").manual_seed(f)
    n = 3000
    lens = torch.randint(0, 4, (n,), generator=g)
    lens[1234] = 3 * k5.CHUNK + 5
    lens[2000] = k5.CHUNK ** 2 + 3 * k5.CHUNK + 1
    ids = torch.cat([torch.full((7,), -1),
                     torch.repeat_interleave(torch.arange(n), lens),
                     torch.full((9,), n + 5)]).to(torch.int32)
    e = ids.shape[0]
    vals = torch.randn((e, f), generator=g).to(dtype)
    perm = torch.randperm(e, generator=g)
    shuffled = torch.empty_like(vals)
    shuffled[perm] = vals
    wide = torch.zeros((e, f + 2), dtype=dtype)
    wide[:, 1:f + 1] = vals
    ids, vals, perm, shuffled, wide = (
        t.to(cuda) for t in (ids, vals, perm.to(torch.int32), shuffled,
                             wide))
    want = k5.ref.segment_sum_sorted_ref(vals, ids, n)
    n0 = k5.LAUNCHES["segment_sum_sorted"]
    got = k5.segment_sum_sorted(vals, ids, n)
    assert k5.LAUNCHES["segment_sum_sorted"] == n0 + 1
    fused = k5.segment_sum_sorted(shuffled, ids, n, order=perm)
    strided = k5.segment_sum_sorted(wide[:, 1:f + 1], ids, n)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (n, f)
    for out in (got, fused, strided):
        assert torch.equal(_k5_bits(out), _k5_bits(want))
    for _ in range(5):
        assert torch.equal(_k5_bits(k5.segment_sum_sorted(vals, ids, n)),
                           _k5_bits(got))
    oracle = k5.ref.segment_sum_ref(vals.float(), ids, n)
    mag = k5.ref.segment_sum_ref(vals.float().abs(), ids, n)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    assert bool(((got.float() - oracle).abs() <= tol * mag + 1e-30).all())


def test_k5_edge_shapes(cuda):
    """N = 0 launches nothing; E = 0 writes zeros to every segment (the
    output is not zeroed before); F = 1 over one segment of 169,984 rows
    (the one-graph pool of a sampled block: three levels) is bitwise its
    plain version."""
    from repro_torch.kernels.segment_reduce import kernel as k5

    n0 = k5.LAUNCHES["segment_sum_sorted"]
    ids = torch.tensor([-1, 0, 2], dtype=torch.int32, device=cuda)
    assert k5.segment_sum_sorted(torch.ones((3, 4), device=cuda), ids,
                                 0).shape == (0, 4)
    assert k5.LAUNCHES["segment_sum_sorted"] == n0
    torch.full((1 << 20,), float("nan"), device=cuda)   # dirty the pool
    empty = k5.segment_sum_sorted(
        torch.zeros((0, 70), dtype=torch.bfloat16, device=cuda),
        torch.zeros((0,), dtype=torch.int32, device=cuda), 5)
    torch.cuda.synchronize()
    assert empty.shape == (5, 70) and not _k5_bits(empty).any()
    g = torch.Generator(device="cpu").manual_seed(3)
    pool = torch.randn((169984, 1), generator=g).to(cuda)
    one = torch.zeros((169984,), dtype=torch.int32, device=cuda)
    got = k5.segment_sum_sorted(pool, one, 1)
    want = k5.ref.segment_sum_sorted_ref(pool, one, 1)
    assert torch.equal(_k5_bits(got), _k5_bits(want))


@pytest.mark.parametrize("shape,n", [((5000, 70), 1201), ((3000, 5, 8), 77),
                                     ((4096,), 128)],
                         ids=["2d", "3d", "1d"])
def test_gnn_segment_sum_on_k5_matches_plain(cuda, shape, n):
    """The GNN models' ``segment_sum`` on CUDA tensors runs K5 (one launch)
    and equals its plain version (``index_add``) on the same tensors
    within 1e-5 of the segments' sums of |values| (``index_add``'s float
    atomics, another order);
    its gradient, a row gather, equals the plain one bitwise, the spare
    segment n (masked edges) included, as the models use it."""
    from repro_torch.kernels.segment_reduce import kernel as k5
    from repro_torch.models.gnn import common

    g = torch.Generator(device="cpu").manual_seed(shape[0])
    ids = torch.randint(0, n + 1, shape[:1], generator=g).to(cuda)
    vals = torch.randn(shape, generator=g).to(cuda)
    co = torch.randn((n + 1,) + shape[1:], generator=g).to(cuda)
    out = {}
    for tag, fn in (("k5", common.segment_sum),
                    ("plain", lambda v, i, m: common.segment_sum_plain(
                        v.reshape(v.shape[0], -1), i, m).reshape(
                        (m,) + v.shape[1:]))):
        v = vals.clone().requires_grad_(True)
        n0 = k5.LAUNCHES["segment_sum_sorted"]
        got = fn(v, ids, n + 1)
        launched = k5.LAUNCHES["segment_sum_sorted"] - n0
        (grad,) = torch.autograd.grad((got[:n] * co[:n]).sum(), (v,))
        out[tag] = (got.detach(), grad, launched)
    (got, g_k5, l_k5), (want, g_plain, l_plain) = out["k5"], out["plain"]
    assert (l_k5, l_plain) == (1, 0)
    mag = common.segment_sum_plain(vals.abs().reshape(shape[0], -1), ids,
                                   n + 1).reshape(want.shape)
    assert bool(((got - want).abs() <= 1e-5 * mag + 1e-30).all())
    assert torch.equal(g_k5, g_plain)
    assert not g_k5[ids == n].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bag_len", [1, 16])
def test_k5_gathered_bags_and_table_grad_match_plain(cuda, dtype, bag_len):
    """``gather_segment_sum`` (the embedding bag) on CUDA tensors: one K5
    launch forward (the slots sorted by bag, the table read through them)
    and one for the dense table gradient (the slots sorted by table row,
    the output gradient read through them), each bitwise K5's plain
    version on the same sorted arguments; against the plain bag (masked
    gather + ``index_add``, in float32) within 1e-5 (f32) or 2^-8 (bf16:
    K5 sums in float32 and rounds once) of the sums of |rows|
    (``index_add``'s atomics add in another order); the counts equal.
    Pads (-1), rows past the table (>= V: dropped like pads, forward and
    backward), an all-pad bag, a hot table row read by a quarter of the
    slots (a segment of the gradient longer than ``CHUNK^2``) and rows no
    slot reads (zero gradient, written)."""
    from repro_torch.kernels.segment_reduce import kernel as k5, ops

    g = torch.Generator(device="cpu").manual_seed(bag_len)
    vocab, n_bags, d = 5000, 20000 // bag_len, 64
    rows = torch.randint(-1, vocab // 2, (n_bags * bag_len,), generator=g)
    rows[torch.rand(rows.shape, generator=g) < 0.25] = 7
    rows[torch.rand(rows.shape, generator=g) < 0.02] = vocab + 3
    rows[-1] = 2 ** 31 - 1
    rows[:bag_len] = -1
    rows = rows.to(torch.int32).to(cuda)
    bags = (torch.arange(rows.shape[0], dtype=torch.int32) //
            bag_len).to(cuda)
    table = torch.randn((vocab, d), generator=g).to(cuda, dtype)
    cot = torch.randn((n_bags, d), generator=g).to(cuda, dtype)
    out = {}
    for tag, fn, dt in (("k5", ops.gather_segment_sum, dtype),
                        ("plain", ops.gather_segment_sum_plain,
                         torch.float32)):
        t = table.to(dt).requires_grad_(True)
        n0 = k5.LAUNCHES["segment_sum_sorted"]
        sums, counts = fn(t, rows, bags, n_bags)
        fwd = k5.LAUNCHES["segment_sum_sorted"] - n0
        (grad,) = torch.autograd.grad(sums, (t,), cot.to(dt))
        out[tag] = (sums.detach(), counts, grad,
                    fwd, k5.LAUNCHES["segment_sum_sorted"] - n0 - fwd)
    (sums, counts, grad, fwd, bwd), plain = out["k5"], out["plain"]
    assert (fwd, bwd) == (1, 1) and plain[3:] == (0, 0)
    keys = ops.slot_keys(rows, bags, n_bags, vocab)
    s = ops.bag_order(rows, keys, n_bags)
    want = k5.ref.segment_sum_sorted_ref(table, s.sorted_ids, n_bags,
                                         order=s.order, offsets=s.offsets)
    s = ops.table_order(rows, keys, n_bags, vocab)
    want_grad = k5.ref.segment_sum_sorted_ref(
        cot, s.sorted_ids, vocab, order=s.order, offsets=s.offsets)
    assert torch.equal(_k5_bits(sums), _k5_bits(want))
    assert torch.equal(_k5_bits(grad), _k5_bits(want_grad))
    assert torch.equal(counts, plain[1])
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    mag, _ = ops.gather_segment_sum_plain(table.float().abs(), rows, bags,
                                          n_bags)
    assert bool(((sums.float() - plain[0]).abs()
                 <= tol * mag + 1e-30).all())
    gmag = torch.zeros((vocab, d), device=cuda).index_add_(
        0, torch.where(keys < n_bags, rows, 0).long(),
        cot.float().abs()[keys.clamp(max=n_bags - 1).long()]
        * (keys < n_bags)[:, None])
    assert bool(((grad.float() - plain[2]).abs()
                 <= tol * gmag + 1e-30).all())
    assert not sums[0].any() and not grad[vocab // 2:].any()


def test_two_tower_bags_run_k5_on_the_card(cuda):
    """The two-tower loss on CUDA tensors (smoke widths) launches K5 for
    the user bags and the item lookup, forward and for both tables'
    gradients (four launches), and matches the same loss and gradients on
    the CPU within 1e-5 abs + 1e-4 of the leaf's largest magnitude."""
    from repro_torch.data.pipeline import RecsysPipeline
    from repro_torch.kernels.segment_reduce import kernel as k5
    from repro_torch.launch import steps
    from repro_torch.models import recsys

    cell = steps.build_cell("two-tower-retrieval", "train_batch",
                            smoke=True, batch=64, device="cpu")
    host = next(RecsysPipeline(64, cell.config, seed=1))
    res = {}
    for dev in ("cpu", cuda):
        params = cell.init_params(0).to(dev).requires_grad_(True)
        tree = params.tree()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        n0 = k5.LAUNCHES["segment_sum_sorted"]
        loss = recsys.loss_fn(params, batch, cell.config)
        leaves = [tree["user_table"], tree["item_table"],
                  tree["user_mlp"][0]["w"]]
        grads = torch.autograd.grad(loss, leaves)
        res[str(dev)] = (loss.detach().cpu(), [x.cpu() for x in grads],
                         k5.LAUNCHES["segment_sum_sorted"] - n0)
    (l0, g0, n_cpu), (l1, g1, n_gpu) = res["cpu"], res[str(cuda)]
    assert (n_cpu, n_gpu) == (0, 4)
    assert abs(float(l0) - float(l1)) <= 1e-5
    for a, b in zip(g0, g1):
        assert torch.allclose(b, a, rtol=0,
                              atol=1e-5 + 1e-4 * float(a.abs().max()))


def test_gnn_segments_sorted_once_serve_several_sums_on_k5(cuda):
    """``common.segments`` sorts the ids once on the card; each sum over it
    is one K5 launch that reads the values where they lie: no
    ``index_select``, cast, pad or copy of them; it equals the sum that
    sorts for itself bitwise, and the plain version (``index_add``) within
    1e-5 of the segments' sums of |values| (``index_add``'s atomics); both
    gradients are the row gather, bitwise."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.kernels.segment_reduce import kernel as k5
    from repro_torch.models.gnn import common

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.add(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    n, e = 1201, 5000
    g = torch.Generator(device="cpu").manual_seed(5)
    ids = torch.randint(0, n + 1, (e,), generator=g).to(cuda)
    seg = common.segments(ids, n + 1)
    assert seg.sorted is not None
    for f, dtype in ((70, torch.float32), (9, torch.float32),
                     (640, torch.bfloat16)):
        vals = torch.randn((e, f), generator=g).to(cuda, dtype)
        v1 = vals.clone().requires_grad_(True)
        v2 = vals.clone().requires_grad_(True)
        n0 = k5.LAUNCHES["segment_sum_sorted"]
        with Ops() as seen:
            got = common.segment_sum(v1, seg)
        assert k5.LAUNCHES["segment_sum_sorted"] == n0 + 1
        assert not seen.names & {"aten.index_select", "aten.index",
                                 "aten._to_copy", "aten.constant_pad_nd",
                                 "aten.copy_", "aten.clone", "aten.zeros",
                                 "aten.zero_", "aten.fill_"}, seen.names
        own = common.segment_sum(v2, ids, n + 1)
        assert got.dtype == dtype
        assert torch.equal(_k5_bits(got), _k5_bits(own))
        want = common.segment_sum_plain(vals.float(), ids, n + 1)
        mag = common.segment_sum_plain(vals.float().abs(), ids, n + 1)
        tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
        assert bool(((got.float() - want).abs() <= tol * mag + 1e-30).all())
        co = torch.randn((n + 1, f), generator=g).to(cuda, dtype)
        (g1,) = torch.autograd.grad((got * co).sum(), (v1,))
        (g2,) = torch.autograd.grad((own * co).sum(), (v2,))
        assert torch.equal(g1, g2) and torch.equal(g1, co[ids])


def _k6_hub(np_, e, n, seed):
    """A sorted dst stream of ``e`` edges: dead edges first, hub runs of
    3,000 and 9,000 edges (over many 1024-edge tiles) among short runs."""
    rng = np.random.default_rng(seed)
    lengths = [17, 3000] + rng.integers(1, 30, 200).tolist() + [9000] \
        + rng.integers(1, 40, e).tolist()
    ids = np.repeat(np.arange(len(lengths)), lengths)[:e]
    keys = np.sort(rng.integers(0, n, ids[-1] + 1))
    return torch.from_numpy(np.where(ids == 0, -1, keys[ids]).astype(
        np.int32))


@pytest.mark.parametrize("e,hub", [(40000, False), (40003, False),
                                   (1021, False), (7, False), (50001, True),
                                   (65536, True)])
def test_k6_kernel_matches_plain_bitwise(cuda, e, hub):
    """K6 against its plain version, bitwise: edge counts that are and are
    not multiples of the 1024-edge tile and of 8 (the ragged thread), a
    hub stream whose runs cross many tiles, sources outside the cell."""
    from repro_torch.kernels.sssp_relax import kernel as k6

    g = torch.Generator(device="cpu").manual_seed(6)
    np_ = 5000
    dist = torch.where(torch.rand(np_, generator=g) < 0.7,
                       torch.rand(np_, generator=g) * 10, float("inf"))
    active = torch.rand(np_, generator=g) < 0.5
    src = torch.randint(-2, np_ + 2, (e,), generator=g, dtype=torch.int32)
    dst = _k6_hub(np_, e, 3 * np_, e) if hub else torch.sort(torch.randint(
        -1, 3 * np_, (e,), generator=g, dtype=torch.int32)).values
    w = torch.rand(e, generator=g) * 5
    args = [t.to(cuda) for t in (dist, active, w, src, dst)]
    n0 = k6.LAUNCHES["relax_sorted"]
    got = k6.relax_sorted(*args, 3 * np_)
    assert k6.LAUNCHES["relax_sorted"] == n0 + 1
    want = k6.ref.relax_ref(args[0], args[2], args[3], args[4], args[1],
                            3 * np_)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_lm_on_gpu_matches_cpu(cuda):
    """The qwen2 smoke config (qkv bias, D = 16 is not a K4 instance, so
    head_dim 64 here) in f32: prefill on K4 and decode on the card against
    the same weights on the CPU, 1e-4 max abs on the logits."""
    import dataclasses

    from repro_torch.configs import qwen2_7b
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(qwen2_7b.smoke_config(), head_dim=64)
    cpu = tf.init_params(cfg, seed=0, device="cpu")
    gpu = tf.params_from_numpy(_numpy_tree(cpu), cfg, device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(0))
    n0 = k4.LAUNCHES["flash_attention"]
    lg, cg = tf.prefill(gpu, toks.to(cuda), cfg, max_len=48)
    assert k4.LAUNCHES["flash_attention"] == n0 + cfg.n_layers
    lc, cc = tf.prefill(cpu, toks, cfg, max_len=48)
    assert float((lg.cpu() - lc).abs().max()) <= 1e-4
    nxt = toks[:, -1:]
    dg, _ = tf.decode_step(gpu, nxt.to(cuda), cg, 40, cfg)
    dc, _ = tf.decode_step(cpu, nxt, cc, 40, cfg)
    assert float((dg.cpu() - dc).abs().max()) <= 1e-4


def _numpy_tree(model):
    """``model``'s parameters as the reference's params tree: numpy
    leaves, the layers' stacked on a leading L axis."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return node.detach().numpy()
    return conv(model.tree())


# ---- the generic instances: programs without a KernelEmit ---------------

def _strip(name, kw):
    """A builtin lowered without its KernelEmit: the generic instance."""
    import dataclasses

    from repro_torch.core import programs as P

    handle = {"sssp": P.sssp, "bfs": P.bfs, "cc": P.cc, "ppr": P.ppr,
              "pagerank": P.pagerank, "widest": P.widest,
              "reach": P.reach}[name]
    spec = dataclasses.replace(handle.fn(**kw), kernel_emit=None)
    return P.lower(spec, name=f"{name}-generic")


def _user_program(name):
    """Programs written without a KernelEmit: the quickstart's
    reliability, an emit reading dst_gid through where, a min-class int32
    program with a custom identity, and an int32 sum with a custom op."""
    from repro_torch.core import programs as P
    from repro_torch.core.monoid import Monoid

    f32, i32 = torch.float32, torch.int32
    keep = lambda s, ib, h, p, ok: (s, h & ok)  # noqa: E731
    if name == "reliability":
        return P.lower(P.DiffusiveProgram(
            monoid="max", msg_dtype=f32,
            state={"rel": P.Field(f32, init=0.0, on_dead=0.0)},
            emit=lambda s, w, sg, dg: s["rel"] * w, receive=keep), name)
    if name == "dst_where":
        return P.lower(P.DiffusiveProgram(
            monoid="min", msg_dtype=f32,
            state={"dist": P.Field(f32, init=0.0)},
            emit=lambda s, w, sg, dg: torch.where(dg > sg, s["dist"] + w,
                                                  s["dist"] * 2.0 + 1.0),
            payload=lambda s, sg: sg, receive=keep), name)
    if name == "ident_min":
        m = Monoid("min1000", "min", identity_of=lambda dt: 1000)
        return P.lower(P.DiffusiveProgram(
            monoid=m, msg_dtype=i32, state={"hops": P.Field(i32, init=0)},
            emit=lambda s, w, sg, dg: torch.clamp_max(s["hops"] + 1, 1000),
            receive=keep), name)
    bf16 = torch.bfloat16
    if name == "logrel":
        return P.lower(P.DiffusiveProgram(
            monoid="min", msg_dtype=f32, state={"dist": P.Field(f32)},
            emit=lambda s, w, sg, dg: s["dist"] - torch.log(w),
            receive=keep), name)
    if name == "bf16_min_payload":
        return P.lower(P.DiffusiveProgram(
            monoid="min", msg_dtype=bf16, state={"dist": P.Field(bf16)},
            emit=lambda s, w, sg, dg: s["dist"] + w.to(bf16) * 1.5,
            payload=lambda s, sg: sg, receive=keep), name)
    if name == "bf16_sum":
        # both verifiers refuse a 16-bit sum (not associative on their
        # samples); the kernels compute it in a fixed order all the same
        import os
        old = os.environ.get("REPRO_VERIFY")
        os.environ["REPRO_VERIFY"] = "0"
        try:
            return P.lower(P.DiffusiveProgram(
                monoid="sum", msg_dtype=bf16,
                state={"residual": P.Field(bf16), "deg": P.Field(bf16)},
                emit=lambda s, w, sg, dg: (s["residual"] * 0.85) / s["deg"],
                receive=keep), name)
        finally:
            if old is None:
                os.environ.pop("REPRO_VERIFY")
            else:
                os.environ["REPRO_VERIFY"] = old
    if name == "wide_record":
        def pick(s, w, sg, dg):
            out = s["dist"] + w
            for k in range(12):
                out = out + torch.where(dg % 12 == k, s[f"f{k}"], 0.0)
            return out
        return P.lower(P.DiffusiveProgram(
            monoid="max", msg_dtype=f32,
            state={"dist": P.Field(f32),
                   **{f"f{k}": P.Field(f32) for k in range(12)}},
            emit=pick, payload=lambda s, sg: sg, receive=keep), name)
    assert name == "capsum"
    return P.lower(P.DiffusiveProgram(
        monoid=Monoid("capsum", "sum", op=_capped), msg_dtype=i32, state={"pending": P.Field(i32)},
        emit=lambda s, w, sg, dg: s["pending"], receive=keep), name)


def _capped(a, b):
    return torch.clamp_max(a + b, 1000)


GENERIC = ([("strip", n, kw) for n, kw in MINMAX + [("ppr", {"source": 1}),
                                                    ("pagerank", {})]]
           + [("user", n, {}) for n in ("reliability", "dst_where",
                                        "ident_min", "capsum", "logrel",
                                        "bf16_min_payload", "bf16_sum",
                                        "wide_record")])


def _generic_prog(kind, name, kw):
    return _strip(name, kw) if kind == "strip" else _user_program(name)


def _generic_state(prog, shape, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    out = {}
    for k, f in prog.fields:
        if f.dtype.is_floating_point:
            v = torch.rand(shape, generator=g) * 40
            v = torch.where(torch.rand(shape, generator=g) < 0.1,
                            float("inf"), v)
        else:
            v = torch.randint(0, 1200, shape, generator=g)
        out[k] = v.to(f.dtype).cuda()
    if "residual" in out:
        out["residual"] = out["residual"] * 1e-4
    if "deg" in out:
        out["deg"] = out["deg"].clamp(1, 8).floor()
    return out, (torch.rand(shape, generator=g) < 0.5).cuda()


@pytest.mark.parametrize("kind,name,kw", GENERIC,
                         ids=[f"{k}-{n}-{len(kw)}" for k, n, kw in GENERIC])
def test_generic_instances_match_plain_bitwise(gpu_session, kind, name, kw):
    """K1 and K3 (min/max programs), K2 in both input modes, solo and with
    4 lanes: the generic instance against the plain version on the same
    CUDA inputs, bitwise, each launch counted under its /generic key."""
    sess, _ = gpu_session
    prog = _generic_prog(kind, name, kw)
    assert kernel._generic(prog) is prog.kernel_gen
    S, Np = sess.sg.node_ok.shape
    n_keys = S * sess.sg.n_per_shard
    sgd = _sg_as_dict(sess.sg, with_push=True)
    es = sess.sg.sorted_width
    kernel.reset_launches()
    if prog.combine != "sum":
        vstate, senders = _generic_state(prog, (S, Np), 3)
        senders &= sess.sg.node_ok
        args = (prog, vstate, senders, sgd["gid"], sgd["csr_key"],
                sgd["csr_src"], sgd["csr_weight"], sgd["csr_dst_gid"])
        for g, w in zip(kernel.edge_relax_blocks(*args, n_keys),
                        _k1_plain(args, n_keys)):
            assert (g is None) == (w is None)
            assert w is None or torch.equal(g, w)
        nb = sgd["push_src"].shape[-1] // kernel.BLOCK_E
        idx, _ = ref.compact_push_blocks(senders, sgd["push_src"],
                                         kernel.BLOCK_E, nb)
        pargs = (prog, vstate, senders, sgd["gid"], sgd["push_key"],
                 sgd["push_src"], sgd["push_weight"], sgd["push_dst_gid"],
                 idx)
        for g, w in zip(kernel.edge_relax_push_blocks(*pargs),
                        ref.edge_relax_push_blocks_ref(
                            *pargs, block_e=kernel.BLOCK_E)):
            assert w is None or torch.equal(g, w)
        assert kernel.LAUNCHES["edge_relax_blocks/generic"] == 1
        assert kernel.LAUNCHES["edge_relax_push_blocks/generic"] == 1
    for lanes in (None, 4):
        p = prog if lanes is None else make_laned([prog] * lanes)
        shape = (S, Np) if lanes is None else (S, lanes, Np)
        vstate, senders = _generic_state(p, shape, 5)
        args = (p, vstate, senders, sgd["gid"]) + tuple(
            sgd[k][..., :es] for k in ("csr_key", "csr_src", "csr_weight",
                                       "csr_dst_gid"))
        skey = sgd["csr_skey"][..., :es]
        got = kernel.edge_relax_scan(*args, skey=skey)
        want = ref.edge_relax_scan_ref(*args, skey=skey)
        cand, send, pay = ref.edge_messages(*args)
        pre = kernel.edge_relax_scan_pre(p.monoid, cand, send, skey, pay)
        pre_want = ref.stream_scan(p.monoid, cand, send, skey, pay)
        torch.cuda.synchronize()
        for a, b, c, d in zip(got, want, pre, pre_want):
            assert (a is None) == (b is None)
            if b is not None:
                assert torch.equal(a, b) and torch.equal(c, d)
    assert kernel.LAUNCHES["edge_relax_scan/generic"] >= 2
    assert kernel.LAUNCHES["edge_relax_scan"] == (
        0 if kernel._custom(prog.monoid) else 2)


def test_k2_custom_op_folds_with_the_monoid_op(gpu_session):
    """A sum-class monoid with a custom op (min(a + b, 1000)) on K2, both
    input modes: bitwise its plain version, which folds with the op; the
    class's native sum (what K2 computed before the generic combine)
    differs on these inputs."""
    sess, _ = gpu_session
    prog = _user_program("capsum")
    S, Np = sess.sg.node_ok.shape
    vstate, senders = _generic_state(prog, (S, Np), 9)
    sgd = _sg_as_dict(sess.sg)
    es = sess.sg.sorted_width
    args = (prog, vstate, senders, sgd["gid"]) + tuple(
        sgd[k][..., :es] for k in ("csr_key", "csr_src", "csr_weight",
                                   "csr_dst_gid"))
    skey = sgd["csr_skey"][..., :es]
    got = kernel.edge_relax_scan(*args, skey=skey)
    want = ref.edge_relax_scan_ref(*args, skey=skey)
    cand, send, _ = ref.edge_messages(*args)
    pre = kernel.edge_relax_scan_pre(prog.monoid, cand, send, skey)
    native = ref.stream_scan(PROGRAMS["pagerank"].factory().monoid,
                             cand, send, skey)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(pre[0], want[0])
    assert not torch.equal(native[0].to(torch.int32), want[0])


def test_generic_division_by_a_constant_matches_torch_cuda(gpu_session):
    """The generated text divides by a constant as torch's CUDA kernel
    does (times the float32 reciprocal): K1 bitwise its plain version."""
    from repro_torch.core import programs as P

    sess, _ = gpu_session
    prog = P.lower(P.DiffusiveProgram(
        monoid="min", msg_dtype=torch.float32,
        state={"x": P.Field(torch.float32)},
        emit=lambda s, w, sg, dg: s["x"] / 3 + w / 7,
        receive=lambda s, ib, h, p, ok: (s, h & ok)), "div_const")
    S, Np = sess.sg.node_ok.shape
    vstate, senders = _generic_state(prog, (S, Np), 13)
    args = _args(sess, prog, vstate, 13)
    n_keys = S * sess.sg.n_per_shard
    got = kernel.edge_relax_blocks(*args, n_keys)
    want = _k1_plain(args, n_keys)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_reliability_sweeps_lanes_and_commit_on_gpu(gpu_session):
    """The quickstart's reliability (no KernelEmit) through the session on
    the card: push and auto bitwise pull, bitwise the CPU session, lanes
    bitwise solo, a commit's repair bitwise a fresh query; the generic
    K1, K2 and K3 instances launched."""
    from repro_torch.core import programs as P

    _, (src, dst, w, n) = gpu_session

    @P.diffusive("card_test_reliability", value_key="rel", monotone=True,
                 lane_param="source")
    def reliability(source: int):
        def receive(vstate, inbox, has_msg, payload, node_ok):
            better = has_msg & (inbox > vstate["rel"]) & node_ok
            return {"rel": torch.where(better, inbox, vstate["rel"])}, better

        return P.DiffusiveProgram(
            monoid="max", msg_dtype=torch.float32,
            state={"rel": P.Field(torch.float32, init=lambda v: torch.where(
                v.gid == source, 1.0, 0.0), on_dead=0.0)},
            init_active=lambda v: v.gid == source,
            emit=lambda s, weight, src_gid, dst_gid: s["rel"] * weight,
            receive=receive)

    probs = np.clip(w / w.max(), 0.05, 1.0).astype(np.float32)
    kw = dict(n_cells=4, edge_slack=0.2, node_slack=0.05)
    gpu = DiffusionSession.from_edges(src, dst, n, probs, device="cuda", **kw)
    cpu = DiffusionSession.from_edges(src, dst, n, probs, device="cpu", **kw)
    kernel.reset_launches()
    name = "card_test_reliability"
    pull = gpu.query(name, source=1)
    for sweep in ("push", "auto"):
        r = gpu.query(name, source=1, sweep=sweep, refresh=True)
        assert np.array_equal(r.values, pull.values), sweep
        assert int(r.stats.actions) == int(pull.stats.actions), sweep
    assert np.array_equal(cpu.query(name, source=1).values, pull.values)
    roots = [1, 2, 7, 30]
    for lane, r in zip(gpu.query(name, sources=roots, refresh=True), roots):
        solo = gpu.query(name, source=r, refresh=True)
        assert np.array_equal(lane.values, solo.values), r
    for k in ("edge_relax_blocks/generic", "edge_relax_push_blocks/generic",
              "edge_relax_scan/generic"):
        assert kernel.LAUNCHES[k] > 0, k
    assert kernel.LAUNCHES["edge_relax_blocks"] == 0
    gpu.query(name, source=1)
    rng = np.random.default_rng(3)
    for u, v in rng.integers(0, n, (16, 2)):
        gpu.add_edge(int(u), int(v), 0.9)
    gpu.delete_edge(int(src[0]), int(dst[0]))
    gpu.commit()
    repaired = gpu.query(name, source=1)
    fresh = gpu.query(name, source=1, refresh=True)
    assert np.array_equal(repaired.values, fresh.values)


# ---------------------------------------------------------------------------
# durability and the merge compaction on the card
# ---------------------------------------------------------------------------


def _durable_history(sess, src, dst, n):
    """Queries, then one commit of deletes, adds and a new vertex."""
    for name, q in (("sssp", {"source": 1}), ("bfs", {"source": 1}),
                    ("cc", {}), ("ppr", {"source": 1})):
        sess.query(name, **q)
    rng = np.random.default_rng(5)
    for i in rng.choice(len(src), 20, replace=False):
        sess.delete_edge(int(src[i]), int(dst[i]))
    for a, b in rng.integers(0, n, (20, 2)):
        sess.add_edge(int(a), int(b), 2.5)
    g = sess.add_vertex()
    sess.add_edge(g, 3, 1.0)
    sess.add_edge(4, g, 1.0)
    sess.commit()


def _sessions_equal(a, b):
    sa, sb = a.sg.state_dict(), b.sg.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k].cpu(), sb[k].cpu()), k
    na, nb = a.ns.state_dict(), b.ns.state_dict()
    assert sorted(na) == sorted(nb)
    for k in na:
        assert np.array_equal(na[k], nb[k]), k
    assert list(a._cache) == list(b._cache)
    for key, ea in a._cache.items():
        eb = b._cache[key]
        for f in ea.vstate:
            assert torch.equal(ea.vstate[f].cpu(), eb.vstate[f].cpu()), key
        for x, y in zip(ea.stats, eb.stats):
            assert torch.equal(x.cpu(), y.cpu()), key


def test_open_on_the_card_places_every_tensor_there(gpu_session, tmp_path):
    _, (src, dst, w, n) = gpu_session
    cpu = DiffusionSession.from_edges(src, dst, n, w, n_cells=4,
                                      edge_slack=0.2, node_slack=0.05,
                                      device="cpu")
    _durable_history(cpu, src, dst, n)
    cpu.save(str(tmp_path))
    got = DiffusionSession.open(str(tmp_path))
    assert got.device.type == "cuda"
    for k, t in got.sg.state_dict().items():
        assert t.is_cuda, k
    assert got.part.owner.is_cuda and got.part.local.is_cuda
    for key, entry in got._cache.items():
        for f, t in entry.vstate.items():
            assert t.is_cuda, (key, f)
        for t in entry.stats:
            assert t.is_cuda, key
    _sessions_equal(cpu, got)


def test_save_and_open_on_the_card_bitwise(gpu_session, tmp_path):
    """Save on the card, two journaled commits, open on the card: the
    replayed session (K3 launched by its repairs) is the live one."""
    _, (src, dst, w, n) = gpu_session
    live = DiffusionSession.from_edges(src, dst, n, w, n_cells=4,
                                       edge_slack=0.2, node_slack=0.05,
                                       device="cuda")
    _durable_history(live, src, dst, n)
    live.save(str(tmp_path))
    rng = np.random.default_rng(8)
    for _ in range(2):
        for i in rng.choice(len(src), 10, replace=False):
            live.delete_edge(int(src[i]), int(dst[i]))
        for a, b in rng.integers(0, n, (10, 2)):
            live.add_edge(int(a), int(b), 1.5)
        live.commit()
    kernel.reset_launches()
    got = DiffusionSession.open(str(tmp_path), device="cuda")
    assert kernel.LAUNCHES["edge_relax_push_blocks"] > 0
    _sessions_equal(live, got)
    for name, q in (("sssp", {"source": 1}), ("cc", {}),
                    ("ppr", {"source": 1})):
        a = live.query(name, refresh=True, **q)
        b = got.query(name, refresh=True, **q)
        assert np.array_equal(a.values, b.values), name


def test_merge_compaction_on_the_card_is_the_full_sort(cuda):
    from repro_torch.core.api import build
    from repro_torch.core.dynamic import NameServer, edge_add, edge_delete

    src, dst, w, n = make_graph_family("scale_free", 2500, seed=17)
    dirty = {}
    for dev in ("cpu", "cuda"):
        part = build(src, dst, n, w, n_cells=2, edge_slack=0.3, device=dev)
        sg, ns = part.sg, NameServer(part)
        rng = np.random.default_rng(0)
        for i in rng.choice(src.shape[0] // 2, 40, replace=False):
            sg = edge_delete(sg, ns, int(src[i]), int(dst[i]))
        for _ in range(30):
            u, v = int(rng.integers(0, n)), int(rng.integers(0, n))
            if u != v:
                sg = edge_add(sg, ns, u, v, 0.5)
        dirty[dev] = sg
    sg = dirty["cuda"]
    assert sg.sorted_width >= 4096 and int(sg.tomb_count.sum()) > 0
    merged = sg._merge_compact()
    full = sg.with_csr()
    on_cpu = dirty["cpu"]._merge_compact()
    for f in ("csr_perm", "csr_key", "csr_live", "csr_inv", "push_perm",
              "push_src", "push_pos", "push_inv"):
        a = getattr(merged, f)
        assert a.is_cuda and torch.equal(a, getattr(full, f)), f
        assert torch.equal(a.cpu(), getattr(on_cpu, f)), f
    assert merged.with_csr() is merged


def test_cpu_and_card_snapshots_have_equal_digests(gpu_session, tmp_path):
    import json

    _, (src, dst, w, n) = gpu_session
    dirs = {}
    for dev in ("cpu", "cuda"):
        sess = DiffusionSession.from_edges(src, dst, n, w, n_cells=4,
                                           edge_slack=0.2, node_slack=0.05,
                                           device=dev)
        _durable_history(sess, src, dst, n)
        dirs[dev] = str(tmp_path / dev)
        step = sess.save(dirs[dev])
    man = {}
    for dev, d in dirs.items():
        with open(f"{d}/step_{step}/manifest.json") as f:
            man[dev] = json.load(f)["leaves"]
    assert sorted(man["cpu"]) == sorted(man["cuda"])
    meta = json.loads(np.load(f"{dirs['cpu']}/step_{step}/session_meta.npy")
                      .tobytes())
    kinds = {str(i): em["name"] for i, em in enumerate(meta["cache"])}
    assert sorted(kinds.values()) == ["bfs", "cc", "ppr", "sssp"]
    for leaf, m in man["cpu"].items():
        top = leaf.split("/")[0]
        if top == "cache" and kinds[leaf.split("/")[1]] == "ppr":
            if "/vstate/" in leaf:
                a, b = (np.load(f"{d}/step_{step}/{man[dev][leaf]['file']}")
                        for dev, d in dirs.items())
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
            continue
        if top in ("graph", "part", "ns", "cache"):
            assert m["digest"] == man["cuda"][leaf]["digest"], leaf


# --------------------------------------------------------------------------
# the SPMD engine's per-rank shapes and the sanitizer on the card
# --------------------------------------------------------------------------

# a warm sssp query's host reads besides one poll a round and a
# sub-iteration and the last round's check: the watchdog's converged
# flag, the results' copies (dist, parent, the two live-id arrays) and,
# on a graph with a staged-delta capacity, its counters
SSSP_QUERY_SYNCS = 6


@pytest.mark.parametrize("kind", ["K1", "K2 laned", "K3"])
def test_per_rank_relax_matches_plain_and_logical_rows(gpu_session, kind):
    """The SPMD engine's relaxation on rank c: one source cell ``[c:c+1]``
    against keys over every cell.  Each kernel at that shape is bitwise
    its plain version on CPU copies of the same inputs, and bitwise row
    ``[c]`` of the logical engine's [S, S, (L,) Np] tables."""
    from repro_torch.core.diffuse import sweep_streams
    from repro_torch.core.relax import make_relax

    sess, _ = gpu_session
    sg = sess.sg
    S, Np, block = sg.n_shards, sg.n_per_shard, sg.csr_block
    g = torch.Generator(device="cpu").manual_seed(7)
    p = 0.02 if kind == "K3" else 0.5
    if kind == "K2 laned":
        prog = make_laned([PROGRAMS["sssp"].factory(source=s)
                           for s in (1, 5, 9, 40)])
        sess.query("sssp", sources=[1, 5, 9, 40])
        vstate = {k: torch.stack([sess.vertex_state("sssp", source=s)[k]
                                  for s in (1, 5, 9, 40)], dim=1)
                  for k in ("dist", "parent")}
        shape = (S, 4, Np)
    else:
        prog = PROGRAMS["sssp"].factory(source=1)
        sess.query("sssp", source=1)
        vstate = sess.vertex_state("sssp", source=1)
        shape = (S, Np)
    senders = (torch.rand(shape, generator=g) < p).cuda() & (
        sg.node_ok[:, None] if kind == "K2 laned" else sg.node_ok)
    sweep = "push" if kind == "K3" else "pull"
    sgd, delta_e = sweep_streams(sg, with_push=kind == "K3")
    relax = make_relax(prog, S, Np, block, delta_e=delta_e, sweep=sweep)
    nb = sgd["push_src"].shape[-1] // block if kind == "K3" else 0

    def bucket(s, d):
        if kind != "K3":
            return None
        got = int(active_push_blocks(s, d["push_src"], block).max())
        return select_bucket(got, nb, "push")

    whole = relax(vstate, senders, sgd, bucket(senders, sgd))
    counter = {"K1": "edge_relax_blocks", "K2 laned": "edge_relax_scan",
               "K3": "edge_relax_push_blocks"}[kind]
    for c in range(S):
        row = {k: v[c:c + 1] for k, v in sgd.items()}
        vs = {k: v[c:c + 1] for k, v in vstate.items()}
        b = bucket(senders[c:c + 1], row)
        n0 = kernel.LAUNCHES[counter]
        got = relax(vs, senders[c:c + 1], row, b)
        assert kernel.LAUNCHES[counter] > n0
        cpu = lambda d: {k: v.cpu() for k, v in d.items()}
        plain = relax(cpu(vs), senders[c:c + 1].cpu(), cpu(row), b)
        for x, y, w in zip(got, plain, whole):
            assert x.shape[:2] == (1, S)
            assert torch.equal(x.cpu(), y)
            assert torch.equal(x, w[c:c + 1])


def test_warm_query_syncs_within_budget_and_no_rebuilds(cuda):
    """The port's engine reads the host by design (one poll a round and a
    sub-iteration): a warm sssp query under ``sanitize(transfers="log")``
    makes at most rounds + local_iters + 1 + SSSP_QUERY_SYNCS synchronizing
    calls, and rebuilds no kernel cache."""
    from repro_torch.analysis import sanitize

    src, dst, w, n = make_graph_family("scale_free", 3000, seed=4)
    sess = DiffusionSession.from_edges(src, dst, n, w, n_cells=4,
                                       device="cuda")
    sess.query("sssp", source=0)                    # builds the kernels
    with sanitize(transfers="log") as rep:
        res = sess.query("sssp", source=7)
    st = res.stats
    budget = int(st.rounds) + int(st.local_iters) + 1 + SSSP_QUERY_SYNCS
    assert rep.guarded
    assert int(st.rounds) < rep.syncs() <= budget, rep.sync_sites()
    assert rep.total_retraces() == 0


def test_disallow_raises_on_a_host_read(cuda):
    from repro_torch.analysis import sanitize

    x = torch.arange(8, device=cuda)
    with pytest.raises(RuntimeError, match="synchronizing"):
        with sanitize(transfers="disallow", retraces=False):
            x.sum().item()
    # the mode is restored: the same read outside the block is fine
    assert int(x.sum().item()) == 28


def test_world_of_one_follows_the_session_device(cuda):
    """``engine="spmd"`` on a one-cell session starts its world of one on
    the backend of the session's device, and starts it anew when the next
    one-cell session lives on the other device: CPU (gloo), card (NCCL),
    CPU again; each query bitwise the session's logical engine."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import cells_group

    src, dst, w, n = make_graph_family("scale_free", 500, seed=2)
    for device, backend in (("cpu", "gloo"), ("cuda", "nccl"),
                            ("cpu", "gloo")):
        sess = DiffusionSession.from_edges(src, dst, n, w, n_cells=1,
                                           device=device)
        got = sess.query("sssp", engine="spmd", source=0)
        assert dist.get_backend(cells_group(1, device)) == backend
        want = sess.query("sssp", engine="sharded", source=0)
        assert np.array_equal(np.asarray(got.values).view(np.int32),
                              np.asarray(want.values).view(np.int32))
