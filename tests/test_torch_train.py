"""The port's training path against the JAX package's (CPU, float32):
``loss_fn`` and every parameter's gradient on the five smoke LMs, remat
on and off, ``_make_train_step`` at ``n_micro`` 1, 2 and 4, the cells
(every architecture's train cell builds; command-r-plus's smoke train
cell takes the reference cell's step) and the ``repro_torch.launch.train``
CLI.

Weights come from the reference's ``init_params`` (norm scales and qkv
biases redrawn with numpy so their gradients count) and reach the port
through ``params_from_numpy``; gradients are those of the module's own
tree (``Transformer.tree``), the reference's layout.  Tolerances: loss 1e-5 abs
(one f32 cross entropy over ~10^2 tokens); gradients 2e-5 abs + 1e-4 of
the leaf's largest magnitude (two layers of f32 products and the chunked
attention backward, summed in other orders by XLA and torch).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import command_r_plus_104b as jcmdr
from repro.configs import grok_1_314b as jgrok
from repro.configs import registry as jregistry
from repro.configs import phi3_5_moe_42b as jphi
from repro.configs import qwen2_7b as jqwen, tinyllama_1_1b as jtiny
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro.optim import adafactor as jadafactor
from repro_torch.configs import registry
from repro_torch.launch import steps, train
from repro_torch.models import transformer as tf
from repro_torch.optim import adafactor
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL_OF_MAX = 2e-5, 1e-4
ARCHS = [("tinyllama-1.1b", jtiny), ("qwen2-7b", jqwen),
         ("grok-1-314b", jgrok), ("phi3.5-moe-42b-a6.6b", jphi),
         ("command-r-plus-104b", jcmdr)]


def _params(jmod, seed=0):
    """(jax cfg, port cfg, jax params, numpy tree) with random norm scales
    and biases."""
    jcfg = jmod.smoke_config()
    tree = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)

    def redraw(path, a):
        name = str(path[-1])
        if "scale" in name or "bias" in name or "'b" in name:
            return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return a
    tree = jax.tree_util.tree_map_with_path(redraw, tree)
    cfg = registry.get_module(jcfg.name.removesuffix("-smoke")).smoke_config()
    return jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, tree), tree


def _tokens(cfg, b=2, s=32, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))


def _port_grads(tp, cfg, toks, labels):
    tree = tp.requires_grad_(True).tree()
    leaves = jax.tree_util.tree_leaves(tree)
    loss = tf.loss_fn(tp, torch.from_numpy(toks), torch.from_numpy(labels),
                      cfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss, jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree), grads)


def _close_tree(got: dict, want, what: str, atol=GRAD_ATOL,
                rtol_of_max=GRAD_RTOL_OF_MAX):
    flat_w = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
              jax.tree_util.tree_flatten_with_path(
                  jax.tree_util.tree_map(lambda t: t.detach().numpy(),
                                         got))[0]}
    assert flat_g.keys() == flat_w.keys()
    for name, w in flat_w.items():
        g = flat_g[name]
        assert g.shape == w.shape, name
        tol = atol + rtol_of_max * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, atol=tol, rtol=0,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("arch,jmod", ARCHS, ids=[a for a, _ in ARCHS])
def test_loss_and_grads_match_reference(arch, jmod):
    jcfg, cfg, jp, tree = _params(jmod)
    toks, labels = _tokens(cfg)
    jl, jg = jax.value_and_grad(jtf.loss_fn)(
        jp, jnp.asarray(toks), jnp.asarray(labels), jcfg)
    tp = tf.params_from_numpy(tree, cfg, device="cpu")
    loss, grads = _port_grads(tp, cfg, toks, labels)
    assert abs(loss.item() - float(jl)) <= LOSS_TOL
    _close_tree(grads, jg, arch)


@pytest.mark.parametrize("policy", [None, "dots"])
@pytest.mark.parametrize("arch,jmod", ARCHS, ids=[a for a, _ in ARCHS])
def test_remat_gives_the_same_grads_bitwise(arch, jmod, policy):
    _, cfg, _, tree = _params(jmod, seed=3)
    toks, labels = _tokens(cfg, seed=4)
    out = []
    for c in (dataclasses.replace(cfg, remat=False),
              dataclasses.replace(cfg, remat=True, remat_policy=policy)):
        tp = tf.params_from_numpy(tree, c, device="cpu")
        loss, grads = _port_grads(tp, c, toks, labels)
        out.append((loss, grads))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(jax.tree_util.tree_leaves(g0),
                    jax.tree_util.tree_leaves(g1)):
        assert torch.equal(a, b)


def test_remat_policy_is_checked():
    cfg = dataclasses.replace(registry.get_module(
        "tinyllama-1.1b").smoke_config(), remat_policy="everything")
    tp = tf.init_params(cfg, device="cpu").requires_grad_(True)
    with pytest.raises(ValueError, match="remat_policy"):
        tf.loss_fn(tp, torch.zeros((1, 4), dtype=torch.int32),
                   torch.zeros((1, 4), dtype=torch.int32), cfg)


def test_params_to_numpy_inverts_params_from_numpy():
    _, cfg, _, tree = _params(jphi)
    got = tf.params_to_numpy(tf.params_from_numpy(tree, cfg, device="cpu"),
                             cfg)
    for (pw, w), (pg, g) in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0],
            jax.tree_util.tree_flatten_with_path(got)[0]):
        assert pw == pg
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_train_step_matches_reference(n_micro):
    """Three steps of ``_make_train_step`` (adafactor 1e-3, clip 1.0) on
    the same batches: losses, grad norms, parameters and the optimizer
    state.  n_micro 4 accumulates in bf16 on both sides, so a gradient
    may round one bf16 ulp (2^-8 relative) apart, and its update element
    with it (adafactor's update is scale-free): a parameter moves by up to
    3 steps x lr x 2^-8 x |u|, with |u| up to ~8 for an update of unit
    RMS, so 1e-4; the second-moment state by 1e-3 of its largest value;
    the later steps' losses by up to 1e-4 (one measured 2e-5)."""
    jcfg, cfg, jp, tree = _params(jtiny, seed=5)
    rng = np.random.default_rng(6)
    batches = [{"tokens": rng.integers(0, cfg.vocab, (4, 16)).astype(
        np.int32), "labels": rng.integers(0, cfg.vocab, (4, 16)).astype(
        np.int32)} for _ in range(3)]
    jopt = jadafactor(lr=1e-3)
    jstep = jax.jit(jsteps._make_train_step(
        lambda p, b: jtf.loss_fn(p, b["tokens"], b["labels"], jcfg), jopt,
        n_micro=n_micro))
    opt = adafactor(lr=1e-3)
    step = steps._make_train_step(
        lambda p, b: tf.loss_fn(p, b["tokens"], b["labels"], cfg), opt,
        n_micro=n_micro)
    tp = tf.params_from_numpy(tree, cfg, device="cpu")
    js, ts = jopt.init(jp), opt.init(tp.tree())
    for i, b in enumerate(batches):
        jp, js, jm = jstep(jp, js, jnp.asarray(i),
                           {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = step(tp, ts, i, {k: torch.from_numpy(v)
                                       for k, v in b.items()})
        tol = LOSS_TOL if i == 0 or n_micro <= 2 else 1e-4
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= tol
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-4 * float(jm["grad_norm"])
    bf16 = n_micro > 2
    _close_tree(tp.tree(), jp, "params",
                atol=1e-4 if bf16 else GRAD_ATOL)
    _close_tree(ts, js, "adafactor state",
                rtol_of_max=1e-3 if bf16 else GRAD_RTOL_OF_MAX)


def test_train_cell_state_has_the_reference_shapes():
    cell = steps.build_cell("tinyllama-1.1b", "train_4k", smoke=True,
                            device="cpu")
    cfg = cell.config
    state = cell.init_opt(cell.init_params(0))
    L, d, h, hd = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd
    assert state["layers"]["attn"]["wq"]["vr"].shape == (L, d, h)
    assert state["layers"]["attn"]["wq"]["vc"].shape == (L, d, hd)
    assert state["layers"]["ln1"]["scale"]["vr"].shape == (L,)
    assert state["layers"]["ln1"]["scale"]["vc"].shape == (d,)
    assert state["final_norm"]["scale"]["v"].shape == (d,)
    assert cell.input_specs()["tokens"] == steps.Spec((2, 64), torch.int32)
    full = steps.build_cell("tinyllama-1.1b", "train_4k", batch=8,
                            device="cpu")
    assert full.input_specs()["labels"].shape == (8, 4096)
    assert steps._LM_MICROBATCHES == jsteps._LM_MICROBATCHES
    assert steps.pad_to(1000, 512) == jsteps.pad_to(1000, 512) == 1024


def test_prefill_and_decode_cells():
    pre = steps.build_cell("qwen2-7b", "prefill_32k", smoke=True,
                           device="cpu")
    params = pre.init_params(1)
    toks = torch.zeros(pre.input_specs()["tokens"].shape, dtype=torch.int32)
    logits, cache = pre.step(params, {"tokens": toks})
    assert logits.shape == (2, 1, pre.config.vocab)
    dec = steps.build_cell("qwen2-7b", "decode_32k", smoke=True,
                           device="cpu")
    spec = dec.input_specs()
    assert spec["cache"]["k"].shape == tuple(cache["k"].shape)
    logits, _ = dec.step(params, {"token": torch.zeros((2, 1),
                                                       dtype=torch.int32),
                                  "cache": cache, "cache_len": 63})
    assert logits.shape == (2, 1, dec.config.vocab)


@pytest.mark.parametrize("arch", ["two-tower-retrieval",
                                  "command-r-plus-104b"])
def test_unported_families_raise_naming_item_12(arch):
    """The two architectures this test once found unported now build: the
    train cell of each (smoke, CPU) runs one step to a finite loss, and an
    unknown architecture still raises ``KeyError``."""
    shape = next(iter(registry.shapes_for(arch)))
    cell = steps.build_cell(arch, shape, smoke=True, device="cpu")
    assert (cell.mode, cell.family) == ("train", jsteps.build_cell(
        arch, shape, smoke=True).family)
    params = cell.init_params(0)
    batch = next(train.on_device(train.data_for(cell), "cpu"))
    _, _, m = cell.step(params, cell.init_opt(params), 0, batch)
    assert np.isfinite(float(m["loss"]))
    with pytest.raises(KeyError):
        registry.shapes_for(arch + "-no-such")


@pytest.mark.parametrize("arch", sorted(jregistry.ARCHS))
def test_every_reference_arch_builds_its_train_cell(arch):
    """Every architecture of the reference's registry is the port's, and
    its train shape's cell builds (smoke, CPU) with the reference cell's
    family, mode and input specs."""
    assert arch in registry.ARCHS
    assert registry.shapes_for(arch).keys() == \
        jregistry.shapes_for(arch).keys()
    shape = next(iter(registry.shapes_for(arch)))      # each family's train
    cell = steps.build_cell(arch, shape, smoke=True, device="cpu")
    jcell = jsteps.build_cell(arch, shape, smoke=True)
    assert (cell.family, cell.mode) == (jcell.family, jcell.mode)
    assert cell.mode == "train" and cell.init_opt is not None
    spec, jspec = cell.input_specs(), jcell.input_specs()
    if not isinstance(spec, dict):                      # a GraphBatch
        spec = spec.fields()
        jspec = {k: getattr(jspec, k) for k in spec}
    assert spec.keys() == jspec.keys()
    for k, v in spec.items():
        assert v.shape == jspec[k].shape, k


def test_unknown_arch_raises_key_error():
    for fn in (registry.get_module, registry.shapes_for):
        with pytest.raises(KeyError, match="unknown arch"):
            fn("no-such-arch")
    with pytest.raises(KeyError):
        steps.build_cell("no-such-arch", "train_4k", smoke=True,
                         device="cpu")


def test_command_r_plus_train_cell_matches_reference():
    """One step of command-r-plus's smoke train_4k cell (adafactor 1e-3,
    clip 1.0, the parallel block, LayerNorm, logit_scale, tied embeddings)
    against the reference cell's step on the same weights and batch: loss
    within LOSS_TOL, grad norm 1e-4 relative, the parameters after it as
    ``test_train_step_matches_reference``."""
    jcell = jsteps.build_cell("command-r-plus-104b", "train_4k", smoke=True)
    cell = steps.build_cell("command-r-plus-104b", "train_4k", smoke=True,
                            device="cpu")
    _, cfg, jp, tree = _params(jcmdr, seed=7)
    rng = np.random.default_rng(8)
    shape = cell.input_specs()["tokens"].shape
    assert shape == jcell.input_specs()["tokens"].shape
    b = {k: rng.integers(0, cfg.vocab, shape).astype(np.int32)
         for k in ("tokens", "labels")}
    jp2, _, jm = jax.jit(jcell.step)(jp, jcell.init_opt(jp), 0,
                                     {k: jnp.asarray(v) for k, v in
                                      b.items()})
    tp = tf.params_from_numpy(tree, cfg, device="cpu")
    tp, _, m = cell.step(tp, cell.init_opt(tp), 0,
                         {k: torch.from_numpy(v) for k, v in b.items()})
    assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_TOL
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
        1e-4 * float(jm["grad_norm"])
    _close_tree(tp.tree(), jp2, "params")


def test_train_cli_runs_and_resumes(tmp_path, capsys):
    args = ["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--log", str(tmp_path / "log.jsonl")]
    _, _, last = train.main(args + ["--steps", "3"])
    assert last == 2
    _, _, last = train.main(args + ["--steps", "5"])
    assert last == 4
    out = capsys.readouterr().out
    assert [ln.split(":")[0] for ln in out.splitlines()] == [
        f"step {i}" for i in range(5)]
    import json
    logged = [json.loads(ln) for ln in
              (tmp_path / "log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in logged] == list(range(5))
    assert all(np.isfinite(r["loss"]) for r in logged)


def test_train_module_entry_point(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "tinyllama-1.1b", "--smoke", "--device", "cpu", "--steps", "2",
         "--ckpt-dir", str(tmp_path)], capture_output=True, text=True,
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                       "PATH": "/usr/bin:/bin"}, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "step 1: loss=" in proc.stdout
    assert (tmp_path / "tinyllama-1.1b" / "step_1" / "manifest.json").exists()
