"""The port's CUDA kernels on a GPU (marked ``cuda``; skipped without one).

Run on a machine with the card (no JAX needed):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain version on the same CUDA inputs —
K1-K3 and K6 bitwise (K3 at compaction caps with fill slots, K2 in both
input modes), K4 and K5 within the tolerances stated at their tests — the
session on the card (pull, push and auto sweeps, and a commit's repairs)
against the session on the CPU, and the LM's prefill and decode on the
card against the CPU."""

import numpy as np
import pytest
import torch

from repro_torch.core import DiffusionSession
from repro_torch.core.diffuse import _sg_as_dict
from repro_torch.core.generators import make_graph_family
from repro_torch.core.programs import PROGRAMS
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


@pytest.mark.parametrize("name,kw", MINMAX)
def test_k1_kernel_matches_plain_bitwise(gpu_session, name, kw):
    sess, _ = gpu_session
    prog = PROGRAMS[name].factory(**kw)
    sess.query(name, **kw)
    args = _args(sess, prog, sess.vertex_state(name, **kw), 3)
    n0 = kernel.LAUNCHES["edge_relax_blocks"]
    got = kernel.edge_relax_blocks(*args)
    assert kernel.LAUNCHES["edge_relax_blocks"] == n0 + 1
    want = ref.edge_relax_blocks_ref(*args, block_e=kernel.BLOCK_E)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert torch.equal(g, w)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,sq,skv,d,causal,softcap", [
    (4, 4, 128, 128, 64, True, 0.0), (8, 1, 200, 200, 64, True, 30.0),
    (4, 2, 100, 260, 128, True, 0.0), (4, 4, 64, 64, 128, False, 30.0),
    (32, 4, 1, 77, 64, True, 0.0)])
def test_k4_kernel_matches_plain(cuda, dtype, hq, hkv, sq, skv, d, causal,
                                 softcap):
    """f32: 2e-5 max abs (the same online softmax, other summation
    orders); bf16: 3e-2 (one bf16 rounding of O(1) outputs, 2^-8
    relative, plus the inputs' own rounding is shared)."""
    from repro_torch.kernels.flash_attention import kernel as k4, ref as r4

    g = torch.Generator(device="cpu").manual_seed(sq + skv + d)
    q, k, v = (torch.randn(shape, generator=g).to(cuda, dtype) for shape in
               ((2, hq, sq, d), (2, hkv, skv, d), (2, hkv, skv, d)))
    n0 = k4.LAUNCHES["flash_attention"]
    got = k4.flash_attention(q, k, v, causal=causal, softcap=softcap,
                             q_offset=skv - sq)
    assert k4.LAUNCHES["flash_attention"] == n0 + 1
    want = r4.flash_attention_ref(q, k, v, causal=causal, softcap=softcap,
                                  q_offset=skv - sq)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    assert got.dtype == dtype
    assert float((got.float() - want.float()).abs().max()) <= tol


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


@pytest.mark.parametrize("e,f,n", [(4096, 128, 300), (1000, 7, 5000),
                                   (128 * 40, 16, 3)])
def test_k5_kernel_matches_plain(cuda, e, f, n):
    """Equal where a segment has at most two blocks' partials; else within
    (k - 1) ulps of the sum of |values| (atomics' order)."""
    from repro_torch.kernels.segment_reduce import kernel as k5, ops as o5

    g = torch.Generator(device="cpu").manual_seed(e)
    ids = torch.sort(torch.randint(-1, n, (e,), generator=g,
                                   dtype=torch.int32)).values.to(cuda)
    vals = torch.randn((e, f), generator=g).to(cuda)
    pad = (-e) % 128
    ids_p = torch.nn.functional.pad(ids, (0, pad), value=-1)
    vals_p = torch.nn.functional.pad(vals, (0, 0, 0, pad))
    n0 = k5.LAUNCHES["segment_sum_sorted"]
    got = k5.segment_sum_sorted(vals_p, ids_p, n)
    assert k5.LAUNCHES["segment_sum_sorted"] == n0 + 1
    want = k5.ref.segment_sum_sorted_ref(vals_p, ids_p, n)
    mag = o5.segment_sum(vals.abs(), ids, n)
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 1e-6 * mag + 1e-30).all())


def test_k6_kernel_matches_plain_bitwise(cuda):
    from repro_torch.kernels.sssp_relax import kernel as k6

    g = torch.Generator(device="cpu").manual_seed(6)
    np_, e = 5000, 40000
    dist = torch.where(torch.rand(np_, generator=g) < 0.7,
                       torch.rand(np_, generator=g) * 10, float("inf"))
    active = torch.rand(np_, generator=g) < 0.5
    src = torch.randint(0, np_, (e,), generator=g, dtype=torch.int32)
    dst = torch.sort(torch.randint(-1, 3 * np_, (e,), generator=g,
                                   dtype=torch.int32)).values
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
    out: dict = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            if parts[1] != "0":
                continue
            parts = ["layers"] + parts[2:]
            leaf = np.stack([dict(layer.named_parameters())[
                ".".join(parts[1:])].numpy() for layer in model.layers])
        else:
            leaf = p.numpy()
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    return out
