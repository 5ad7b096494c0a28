"""The sharded LM on ``gloo`` CPU ranks against the JAX package.

One run of ``tests/torch_dist_worker.py`` (a world of one, then 4 ranks
in one spawn) produces every number; each test holds one part of it
against the reference, which runs here on the same numpy inputs:

* the narrow tinyllama-shaped LM on the meshes (2, 2) and (1, 4) (its 2
  KV heads divide ``model`` on the first and not on the second): loss
  and every gradient against ``loss_fn`` and ``jax.grad``, and one
  adafactor train step against the reference's ``_make_train_step`` (its
  clip, update and ``p + u`` on those gradients), within 1e-5 (max abs,
  scaled by 1 + |x|);
* the phi3.5-moe-shaped MoE layer under the plan against ``moe_ffn``:
  the routing and the kept rows (rows are dropped) exactly the
  reference's, outputs and router statistics within 1e-5;
* the pipeline (``tanh(x @ w)``, M 4, S 2) against the sequential stages
  within 1e-5, ``bubble_fraction`` equal;
* ``compressed_psum_mean`` on 2 ranks against the reference under
  ``jax.vmap(axis_name="dp")``: the int8 values equal, means and errors
  within 1 ulp;
* the world of one bitwise the unsharded port, ``ElasticScaler`` bitwise
  the saved tensors;

and, in process, ``logical_constraint`` is the identity outside a
context and on plain tensors."""

import dataclasses
import json
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tinyllama_1_1b as jtiny
from repro.dist.compressed_dp import _compress_leaf as jcompress_leaf
from repro.dist.compressed_dp import compressed_psum_mean as jcompressed
from repro.dist.pipeline import bubble_fraction as jbubble
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.optim import adafactor as jadafactor
from repro.optim import clip_by_global_norm as jclip
from repro_torch.dist.pipeline import bubble_fraction
from repro_torch.dist.sharding import logical_constraint, sharding_context
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)
import torch_dist_worker as W

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5


def _flat(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/" + "/".join(str(p.key) for p in path)] = \
            np.asarray(leaf, np.float32)
    return out


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.max(np.abs(got - want) / (1.0 + np.abs(want)))
    assert err <= tol, f"{what}: {err:.3g} > {tol}"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, results, arrays) of one worker run."""
    out = tmp_path_factory.mktemp("dist")
    jcfg = dataclasses.replace(jtiny.smoke_config(), **W.NARROW)
    tree = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)

    def redraw(path, a):
        # random norm scales, so their gradients count
        return ((0.1 * rng.normal(size=a.shape)).astype(np.float32)
                if "scale" in str(path[-1]) else a)
    tree = jax.tree_util.tree_map_with_path(redraw, tree)
    inputs = _flat(tree, "lm")
    inputs["tokens"] = rng.integers(0, W.NARROW["vocab"],
                                    (W.BATCH, W.SEQ)).astype(np.int32)
    inputs["labels"] = rng.integers(0, W.NARROW["vocab"],
                                    (W.BATCH, W.SEQ)).astype(np.int32)
    mcfg = jmoe.MoEConfig(**W.MOE)
    inputs.update(_flat(jmoe.init_moe(jax.random.PRNGKey(1), W.MOE_D,
                                      mcfg), "moe"))
    inputs["moe_x"] = rng.normal(size=(W.MOE_T, W.MOE_D)).astype(
        np.float32)
    inputs["pipe_ws"] = (rng.normal(size=(2, 8, 8)) * 0.5).astype(
        np.float32)
    inputs["pipe_xs"] = rng.normal(size=(4, 3, 8)).astype(np.float32)
    inputs["cdp_g"] = rng.normal(size=(2, 64)).astype(np.float32)
    np.savez(out / "inputs.npz", **inputs)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, str(ROOT / "tests" /
                                               "torch_dist_worker.py"),
                           str(out)], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    res = json.loads((out / "one.json").read_text())
    res.update(json.loads((out / "results.json").read_text()))
    return (inputs, tree, jcfg), res, dict(np.load(out / "out.npz"))


def _check(res, name):
    ok, detail = res[name]
    assert ok, f"{name}: {detail}"


@pytest.mark.parametrize("name", ["one_train_step_bitwise",
                                  "one_moe_prefill_decode_bitwise",
                                  "elastic_rank0", "elastic_rank1",
                                  "embed_sharded-2x2", "embed_sharded-1x4",
                                  "refusals_rank0", "refusals_rank3",
                                  "decode_split_rank0",
                                  "decode_split_rank3"])
def test_rank_checks(run, name):
    """The checks the ranks make themselves: a world of one bitwise the
    unsharded port (train step; MoE prefill and decode under the plan),
    ``ElasticScaler`` restoring the 4-rank snapshot onto 2 ranks bitwise,
    the embedding really split, decode on a cache whose positions are
    split over ranks, and the refusals (no fallback)."""
    _, res, _ = run
    assert "ranks" not in res, res.get("ranks")
    _check(res, name)


@pytest.fixture(scope="module")
def ref_grads(run):
    (inputs, tree, jcfg), _, _ = run
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    fn = jax.jit(jax.value_and_grad(partial(jtf.loss_fn, cfg=jcfg)))
    return fn(params, jnp.asarray(inputs["tokens"]),
              jnp.asarray(inputs["labels"]))


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_loss_and_grads_match_reference(run, ref_grads, mesh):
    _, _, arrays = run
    loss, grads = ref_grads
    _close(arrays[f"loss-{mesh}"], loss, "loss")
    for key, want in _flat(grads, f"grad-{mesh}").items():
        _close(arrays[key], want, key)


def test_train_step_matches_reference(run, ref_grads):
    """The reference's ``_make_train_step`` at ``n_micro`` 1 (clip to 1.0,
    adafactor 1e-3, ``p + u``), on the gradients ``ref_grads`` took."""
    (_, tree, _), _, arrays = run
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    loss, grads = ref_grads
    opt = jadafactor(lr=1e-3)

    @jax.jit
    def step(params, grads):
        grads, _ = jclip(grads, 1.0)
        updates, _ = opt.update(grads, opt.init(params), params, 0)
        return jax.tree_util.tree_map(lambda p, u: p + u.astype(p.dtype),
                                      params, updates)

    new = step(params, grads)
    _close(arrays["step-loss"], loss, "loss")
    for key, want in _flat(new, "step").items():
        _close(arrays[key], want, key)


def test_moe_layer_matches_reference(run):
    (inputs, _, _), _, arrays = run
    cfg = jmoe.MoEConfig(**W.MOE)
    params = {k.split("/")[1]: jnp.asarray(v) for k, v in inputs.items()
              if k.startswith("moe/")}
    x = jnp.asarray(inputs["moe_x"])
    y, aux = jax.jit(partial(jmoe.moe_ffn, cfg=cfg))(params, x)
    # the reference's routing (top_k of the softmax) and the rows its
    # capacity keeps (the first cap of each expert's group in its stable
    # sort): the sharded layer's, and rows are dropped
    probs = jax.nn.softmax(x @ params["router"], axis=-1)
    idx = np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])
    flat = idx.reshape(-1)
    order = np.asarray(jnp.argsort(jnp.asarray(flat), stable=True))
    sizes = np.bincount(flat, minlength=cfg.n_experts)
    pos = np.empty_like(flat)
    pos[order] = np.arange(flat.size) - (np.cumsum(sizes) - sizes)[
        flat[order]]
    cap = max(128, -(-int(cfg.capacity_factor * W.MOE_T * cfg.top_k
                          / cfg.n_experts) // 128) * 128)
    kept = (pos < cap).reshape(idx.shape)
    np.testing.assert_array_equal(arrays["moe-idx"], idx)
    np.testing.assert_array_equal(arrays["moe-kept"], kept)
    assert (~kept).any(), (sizes, cap)
    _close(arrays["moe-y"], y, "moe outputs")
    for k, v in aux.items():
        _close(arrays[f"moe-aux-{k}"], v, k)


def test_pipeline_matches_sequential(run):
    (inputs, _, _), _, arrays = run
    ws, xs = inputs["pipe_ws"], inputs["pipe_xs"]
    want = np.stack([np.asarray(jnp.tanh(jnp.tanh(x @ ws[0]) @ ws[1]))
                     for x in xs])
    for rank in range(4):
        _close(arrays[f"pipe-ys-{rank}"], want, f"rank {rank}")
    assert bubble_fraction(W.N_MICRO, W.N_STAGES) == \
        jbubble(W.N_MICRO, W.N_STAGES)


def test_compressed_mean_matches_reference(run):
    (inputs, _, _), _, arrays = run
    g = jnp.asarray(inputs["cdp_g"])
    mean, err = jax.vmap(
        lambda gi, ei: jcompressed({"g": gi}, {"g": ei}, "dp", 2),
        axis_name="dp")(g, jnp.zeros_like(g))
    q = jax.vmap(lambda gi, ei: jcompress_leaf(gi, ei, "dp")[0],
                 axis_name="dp")(g, jnp.zeros_like(g))
    ulp = np.spacing(np.abs(np.asarray(mean["g"])).max())
    for rank in range(4):
        stage = rank // 2
        np.testing.assert_array_equal(arrays[f"cdp-q-{rank}"], q[stage])
        np.testing.assert_allclose(arrays[f"cdp-mean-{rank}"],
                                   mean["g"][stage], rtol=0, atol=ulp)
        np.testing.assert_allclose(
            arrays[f"cdp-err-{rank}"], err["g"][stage], rtol=0,
            atol=np.spacing(np.abs(inputs["cdp_g"]).max()))


def test_logical_constraint_is_identity_without_context_or_dtensor():
    x = torch.randn(4, 6, 8)
    assert logical_constraint(x, "batch", "heads", "seq") is x
    from repro_torch.dist.rules import AbstractMesh
    mesh = AbstractMesh((2, 4), ("data", "model"))
    with sharding_context(mesh, {"batch": "data", "heads": "model"}):
        assert logical_constraint(x, "batch", "heads", "seq") is x
        assert logical_constraint(x, "batch") is x      # rank mismatch
