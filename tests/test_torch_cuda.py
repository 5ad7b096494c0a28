"""The port's CUDA kernels on a GPU (marked ``cuda``; skipped without one).

Run on a machine with the card (no JAX needed):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held bitwise against its plain version on the same CUDA
inputs, and the session on the card against the session on the CPU."""

import numpy as np
import pytest
import torch

from repro_torch.core import DiffusionSession
from repro_torch.core.diffuse import _sg_as_dict
from repro_torch.core.generators import make_graph_family
from repro_torch.core.programs import PROGRAMS
from repro_torch.kernels.edge_relax import kernel, ref

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
