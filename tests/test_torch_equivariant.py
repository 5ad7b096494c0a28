"""The port's equivariant blocks (``repro_torch/models/gnn/equivariant.py``)
against the JAX package's: the float64 constants bit for bit (the Wigner
``K`` matrices from the seeded least squares, the ``Xz`` masks, the CG
couplings), the spherical harmonics, Wigner blocks, rotations (on the
same blocks) and radial bases on float32 inputs within 1e-6 (one f32
recurrence in another order), and the port's mace and equiformer-v2
invariant under a rotation of the positions, as the reference's
``tests/test_models.py`` holds its own (1e-3 of the output's scale:
float32 through two layers).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.gnn import equivariant as jeq
from repro_torch.models.gnn import equivariant as teq
from repro_torch.models.gnn import equiformer_v2, mace
from repro_torch.models.gnn.common import GraphBatch
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

TOL = 1e-6
L_MAX = 3


def _vectors(seed, n=64):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    v[0] = 0.0                        # the degenerate direction
    v[1] = [0.0, 0.0, 2.0]            # on the z axis
    return v


@pytest.mark.parametrize("l", range(L_MAX + 3))
def test_wigner_K_and_xz_masks_bitwise(l):
    np.testing.assert_array_equal(teq.wigner_K(l), jeq.wigner_K(l))
    for got, want in zip(teq._xz_masks(l), jeq._xz_masks(l)):
        np.testing.assert_array_equal(got, want)


def test_cg_couplings_bitwise():
    for l1, l2, l3 in itertools.product(range(L_MAX + 1), repeat=3):
        got, want = teq.cg_coupling(l1, l2, l3), jeq.cg_coupling(l1, l2, l3)
        if want is None:
            assert got is None, (l1, l2, l3)
        else:
            assert got.dtype == np.float64
            np.testing.assert_array_equal(got, want)


def test_sph_harm_np_bitwise_and_sph_harm_within_tolerance():
    v = _vectors(0)
    np.testing.assert_array_equal(teq.sph_harm_np(6, v),
                                  jeq.sph_harm_np(6, v))
    got = teq.sph_harm(6, torch.from_numpy(v))
    want = np.asarray(jeq.sph_harm(6, jnp.asarray(v)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_wigner_blocks_and_rotate_irreps():
    v = _vectors(1)
    got = teq.wigner_blocks(L_MAX, torch.from_numpy(v))
    want = jeq.wigner_blocks(L_MAX, jnp.asarray(v))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL)
    # rotate_irreps on the same blocks (the reference's)
    same = [torch.from_numpy(np.array(w)) for w in want]
    feats = np.random.default_rng(2).normal(
        size=(64, teq.n_sph(L_MAX), 5)).astype(np.float32)
    for inverse in (False, True):
        g = teq.rotate_irreps(torch.from_numpy(feats), same, L_MAX,
                              inverse=inverse)
        w = jeq.rotate_irreps(jnp.asarray(feats), want, L_MAX,
                              inverse=inverse)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL)


def test_radial_bases():
    r = np.abs(np.random.default_rng(3).normal(size=50) * 3).astype(
        np.float32)
    r[0] = 0.0
    np.testing.assert_allclose(
        teq.bessel_basis(torch.from_numpy(r), 8, 5.0).numpy(),
        np.asarray(jeq.bessel_basis(jnp.asarray(r), 8, 5.0)), rtol=1e-6,
        atol=TOL)
    np.testing.assert_allclose(
        teq.poly_cutoff(torch.from_numpy(r), 5.0).numpy(),
        np.asarray(jeq.poly_cutoff(jnp.asarray(r), 5.0)), rtol=0, atol=TOL)


@pytest.mark.parametrize("model,cfg", [
    (mace, mace.MACEConfig(n_layers=2, d_hidden=8, n_species=5)),
    (equiformer_v2, equiformer_v2.EquiformerV2Config(
        n_layers=2, d_hidden=16, l_max=3, n_heads=2, n_species=5, d_out=2)),
], ids=["mace", "equiformer-v2"])
def test_rotation_invariance(model, cfg):
    rng = np.random.default_rng(0)
    n, e = 40, 128
    kw = dict(senders=torch.from_numpy(rng.integers(0, n, e)),
              receivers=torch.from_numpy(rng.integers(0, n, e)), n_nodes=n,
              species=torch.from_numpy(rng.integers(0, 5, n)),
              graph_ids=torch.zeros(n, dtype=torch.int32), n_graphs=1)
    pos = rng.normal(size=(n, 3))
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    p = model.init_params(cfg, seed=0, device="cpu")
    with torch.no_grad():
        o1 = model.apply(p, GraphBatch(positions=torch.tensor(
            pos, dtype=torch.float32), **kw), cfg)
        o2 = model.apply(p, GraphBatch(positions=torch.tensor(
            pos @ Q.T, dtype=torch.float32), **kw), cfg)
    scale = max(1.0, float(o1.abs().max()))
    assert float((o1 - o2).abs().max()) / scale < 1e-3
