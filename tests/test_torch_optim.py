"""The port's optimizers (``repro_torch.optim``) against the JAX package's
(``repro.optim``) on the CPU.

Parameters and gradients are drawn with numpy from seeds on a tree shaped
like tinyllama-1.1b's smoke parameters in the reference's layout (layers
stacked on a leading L axis), and go through both packages in float32.
Tolerance 1e-6 abs + 1e-5 of the leaf's largest magnitude on updates and
states (the same elementwise f32 math; reductions summed in other orders,
and the schedule and bias corrections in double on the port's host side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tinyllama_1_1b as jtiny
from repro.models import transformer as jtf
from repro.optim import optimizers as jopt
from repro_torch import optim
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

ATOL, RTOL_OF_MAX = 1e-6, 1e-5


def _shapes():
    return jax.tree_util.tree_map(
        lambda a: a.shape,
        jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0),
                                               jtiny.smoke_config())))


def _draw(shapes, rng, scale=1.0):
    return jax.tree_util.tree_map(
        lambda s: (scale * rng.normal(size=s)).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))


def _to_torch(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _close(got, want, what):
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    gl = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in wl] == [p for p, _ in gl], what
    for (path, w), (_, g) in zip(wl, gl):
        w = np.asarray(w)
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, (what, path)
        tol = ATOL + RTOL_OF_MAX * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, atol=tol, rtol=0,
                                   err_msg=f"{what} {path}")


OPTIMIZERS = {
    "adamw_wd_cosine": lambda m: m.adamw(
        lr=m.cosine_schedule(3e-3, total_steps=5, warmup=2),
        weight_decay=0.1),
    "adafactor": lambda m: m.adafactor(lr=1e-2),
    "sgd": lambda m: m.sgd(lr=1e-2, momentum=0.9),
    "sgd_nesterov": lambda m: m.sgd(lr=1e-2, momentum=0.9, nesterov=True),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_five_steps_match_reference(name):
    rng = np.random.default_rng(sorted(OPTIMIZERS).index(name))
    shapes = _shapes()
    params = _draw(shapes, rng, 0.1)
    j, t = OPTIMIZERS[name](jopt), OPTIMIZERS[name](optim)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), _to_torch(params)
    js, ts = j.init(jp), t.init(tp)
    _close(ts, js, "init")
    for step in range(5):
        g = _draw(shapes, rng, 10.0 ** (step - 2))
        ju, js = j.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                          jnp.asarray(step))
        tu, ts = t.update(_to_torch(g), ts, tp, step)
        _close(tu, ju, f"updates step {step}")
        _close(ts, js, f"state step {step}")
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, ju)
        tp = optim.tree_map(lambda p, u: p + u, tp, tu)


def test_adafactor_leaves_are_the_stacked_ones():
    """A stacked norm scale [L, d] is factored (``vr [L]``, ``vc [d]``),
    and the update's RMS clip runs over all L layers: one layer with large
    gradients sets the clip for both.  The reference agrees with the
    stacked leaf and not with a per-layer application."""
    rng = np.random.default_rng(7)
    p = {"scale": rng.normal(size=(2, 8)).astype(np.float32),
         "w": rng.normal(size=(2, 8, 4)).astype(np.float32)}
    g = {"scale": rng.normal(size=(2, 8)).astype(np.float32),
         "w": rng.normal(size=(2, 8, 4)).astype(np.float32)}
    # one layer's gradient ~1000x the other's: its update RMS exceeds 1
    for k in g:
        g[k][1] *= 1000.0
    j, t = jopt.adafactor(lr=1.0), optim.adafactor(lr=1.0)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    ju, js = j.update(jax.tree_util.tree_map(jnp.asarray, g), j.init(jp),
                      jp, jnp.asarray(0))
    tp = _to_torch(p)
    ts0 = t.init(tp)
    assert ts0["scale"]["vr"].shape == (2,)
    assert ts0["scale"]["vc"].shape == (8,)
    tu, ts = t.update(_to_torch(g), ts0, tp, 0)
    _close(tu, ju, "stacked updates")
    _close(ts, js, "stacked state")
    # per layer: the norm scale unfactored, each layer clipped alone
    for i in range(2):
        pi = {k: torch.from_numpy(v[i]) for k, v in p.items()}
        ui, si = t.update({k: torch.from_numpy(v[i]) for k, v in g.items()},
                          t.init(pi), pi, 0)
        assert set(si["scale"]) == {"v"}
        assert not np.allclose(ui["scale"].numpy(), np.asarray(
            ju["scale"][i]), atol=1e-3)


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 101, 500, 999, 1000,
                                  5000])
def test_schedules_match_reference(step):
    for make in (lambda m: m.cosine_schedule(1e-3, 1000, warmup=100),
                 lambda m: m.cosine_schedule(2e-4, 50, warmup=0,
                                             final_frac=0.0),
                 lambda m: m.linear_warmup(3e-4, warmup=200)):
        want = float(make(jopt)(jnp.asarray(step)))
        assert make(optim)(step) == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_global_norm_and_clip():
    rng = np.random.default_rng(8)
    tree = {"a": rng.normal(size=(5, 3)).astype(np.float32),
            "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = _to_torch(tree)
    assert float(optim.global_norm(tt)) == pytest.approx(
        float(jopt.global_norm(jt)), rel=1e-6)
    for max_norm in (0.5, 100.0):
        jc, jg = jopt.clip_by_global_norm(jt, max_norm)
        tc, tg = optim.clip_by_global_norm(tt, max_norm)
        assert float(tg) == pytest.approx(float(jg), rel=1e-6)
        _close(tc, jc, f"clip {max_norm}")


def test_clip_keeps_bf16_leaves_bf16():
    tree = {"w": torch.randn(16, 8, dtype=torch.bfloat16),
            "s": torch.randn(8, dtype=torch.float32)}
    clipped, norm = optim.clip_by_global_norm(tree, 1.0)
    assert clipped["w"].dtype == torch.bfloat16
    assert clipped["s"].dtype == torch.float32
    assert norm.dtype == torch.float32
    assert float(optim.global_norm(clipped)) == pytest.approx(1.0, rel=1e-2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_int8_bitwise(seed):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(64, 33)) * 10.0 ** (seed - 1)).astype(np.float32)
    err = (rng.normal(size=(64, 33)) * 1e-3).astype(np.float32)
    jq, js, je = jopt.compress_int8(jnp.asarray(g), jnp.asarray(err))
    tq, ts, te = optim.compress_int8(torch.from_numpy(g),
                                     torch.from_numpy(err))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(
        optim.decompress_int8(tq, ts).numpy(),
        np.asarray(jopt.decompress_int8(jq, js)))


def test_grad_accumulator_matches_reference():
    rng = np.random.default_rng(9)
    shapes = {"w": (4, 3), "b": (3,)}
    params = _draw(shapes, rng)
    ja, ta = jopt.GradAccumulator(3), optim.GradAccumulator(3)
    jacc = ja.init(jax.tree_util.tree_map(jnp.asarray, params))
    tacc = ta.init(_to_torch(params))
    for _ in range(3):
        g = _draw(shapes, rng)
        jacc = ja.add(jacc, jax.tree_util.tree_map(jnp.asarray, g))
        tacc = ta.add(tacc, _to_torch(g))
    _close(tacc, jacc, "accumulated")


def test_tree_helpers():
    tree = {"b": torch.ones(2), "a": {"y": torch.zeros(1), "x": torch.ones(3)}}
    assert [t.shape[0] for t in optim.tree_leaves(tree)] == [3, 1, 2]
    doubled = optim.tree_map(lambda t: 2 * t, tree)
    assert doubled["a"]["x"].tolist() == [2.0, 2.0, 2.0]
