"""The port's training runtime against the JAX package's on the CPU: the
counterparts of ``tests/test_runtime.py`` (checkpoint round trip,
corruption and fallbacks, ``train_loop`` resume and preemption, the
straggler and heartbeat monitors, ``largest_mesh_shape``, the preemption
guard's handlers), bfloat16 snapshots in the reference's layout,
``train_loop`` directories resumed across the two packages (float32),
and ``TokenPipeline`` batches against the reference's.
"""

import os
import signal

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.data import pipeline as jpipeline
from repro.optim import adamw as jadamw
from repro.runtime.trainer import train_loop as jtrain_loop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import pipeline
from repro_torch.optim import adamw, tree_map
from repro_torch.runtime.fault_tolerance import (
    HeartbeatMonitor,
    PreemptionGuard,
    StragglerMonitor,
    largest_mesh_shape,
)
from repro_torch.runtime.trainer import train_loop
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    while True:
        x = rng.normal(size=(8, 4)).astype(np.float32)
        yield {"x": x, "y": x.sum(1, keepdims=True) * np.ones((1, 4),
                                                             np.float32)}


def _toy():
    """The reference test's toy regression, in torch: (params, state,
    step, data)."""
    params = {"w": torch.ones((4, 4)), "b": torch.zeros((4,))}
    opt = adamw(lr=0.1)

    def step(params, opt_state, step_no, batch):
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        x, y = (torch.from_numpy(batch[k]) for k in ("x", "y"))
        loss = ((x @ p["w"] + p["b"] - y) ** 2).mean()
        g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        upd, opt_state = opt.update(g, opt_state, params, step_no)
        params = tree_map(lambda a, u: a + u, params, upd)
        return params, opt_state, {"loss": loss.detach(),
                                    "grad_norm": loss.detach()}

    return params, opt.init(params), step, _data()


def _jtoy():
    params = {"w": jnp.ones((4, 4)), "b": jnp.zeros((4,))}
    opt = jadamw(lr=0.1)

    def loss(p, batch):
        return jnp.mean((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2)

    def step(params, opt_state, step_no, batch):
        l, g = jax.value_and_grad(loss)(params, batch)
        upd, opt_state = opt.update(g, opt_state, params, step_no)
        params = jax.tree_util.tree_map(lambda a, u: a + u, params, upd)
        return params, opt_state, {"loss": l, "grad_norm": l}

    return params, opt.init(params), step, _data()


# -- checkpoints ------------------------------------------------------------

def test_checkpoint_roundtrip_and_integrity(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(10.0), "nested": {"b": torch.ones((3, 3))},
            "t": (torch.zeros(2), np.arange(3))}
    for s in (5, 7, 9):
        ckpt.save(s, tree, wait=True)
    assert ckpt.all_steps() == [7, 9]          # retention pruned step 5
    restored, step = ckpt.restore(tree)
    assert step == 9
    assert isinstance(restored["t"], tuple)
    assert torch.equal(restored["a"], tree["a"])
    assert torch.equal(restored["nested"]["b"], tree["nested"]["b"])
    assert torch.equal(restored["t"][0], tree["t"][0])
    np.testing.assert_array_equal(restored["t"][1], tree["t"][1])
    flat, _ = ckpt.restore(device="cpu")
    assert sorted(flat) == ["a", "nested/b", "t/0", "t/1"]


def test_checkpoint_detects_corruption(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    tree = {"a": torch.arange(4.0)}
    ckpt.save(1, tree, wait=True)
    f = os.path.join(str(tmp_path), "step_1", "a.npy")
    arr = np.load(f)
    arr[0] = 999.0
    np.save(f, arr)
    with pytest.raises(IOError):
        ckpt.restore(tree)


def test_restore_checks_names_and_shapes(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, {"a": torch.zeros(3)}, wait=True)
    with pytest.raises(KeyError):
        ckpt.restore({"b": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore({"a": torch.zeros(4)})


def _save_steps(tmp_path, values=(1, 2, 3)):
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    tree = None
    for s in values:
        tree = {"a": torch.arange(4.0) * s, "b": torch.ones((2, 2)) * s}
        ckpt.save(s, tree, wait=True)
    return ckpt, tree


def _assert_restored_step(ckpt, tree, expected_step):
    with pytest.warns(UserWarning, match="damaged"):
        restored, step = ckpt.restore(tree)
    assert step == expected_step
    np.testing.assert_array_equal(restored["a"].numpy(),
                                  np.arange(4.0) * expected_step)


def _truncate_manifest(tmp_path):
    mf = os.path.join(str(tmp_path), "step_3", "manifest.json")
    with open(mf, "rb+") as f:
        f.truncate(os.path.getsize(mf) // 2)


def _remove_leaf(tmp_path):
    os.remove(os.path.join(str(tmp_path), "step_3", "a.npy"))


def _flip_a_byte(tmp_path):
    leaf = os.path.join(str(tmp_path), "step_3", "b.npy")
    raw = bytearray(open(leaf, "rb").read())
    raw[-1] ^= 0xFF
    open(leaf, "wb").write(bytes(raw))


@pytest.mark.parametrize("damage", [_truncate_manifest, _remove_leaf,
                                    _flip_a_byte])
def test_checkpoint_fallback(tmp_path, damage):
    ckpt, tree = _save_steps(tmp_path)
    damage(tmp_path)
    _assert_restored_step(ckpt, tree, 2)


def test_checkpoint_fallback_walks_past_two_damaged_steps(tmp_path):
    ckpt, tree = _save_steps(tmp_path)
    for s in (2, 3):
        os.remove(os.path.join(str(tmp_path), f"step_{s}", "a.npy"))
    _assert_restored_step(ckpt, tree, 1)


def test_checkpoint_explicit_step_never_falls_back(tmp_path):
    ckpt, tree = _save_steps(tmp_path)
    _remove_leaf(tmp_path)
    with pytest.raises(IOError):
        ckpt.restore(tree, step=3)


# -- bfloat16 in the reference's layout -------------------------------------

def _bf16_tree(seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(3, 5)).astype(ml_dtypes.bfloat16)
    w[0, 0] = np.float32("inf")
    w[0, 1] = -0.0
    return {"w": w, "nested": {"s": rng.normal(size=(4,)).astype(
        np.float32)}}


def test_reference_bf16_snapshot_restores_bitwise(tmp_path):
    tree = _bf16_tree(0)
    JManager(str(tmp_path)).save(3, jax.tree_util.tree_map(jnp.asarray,
                                                           tree), wait=True)
    flat, step = CheckpointManager(str(tmp_path)).restore(device="cpu")
    assert step == 3 and flat["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(flat["w"].view(torch.int16).numpy(),
                                  tree["w"].view(np.int16))
    target = {"w": torch.zeros((3, 5), dtype=torch.bfloat16),
              "nested": {"s": torch.zeros(4)}}
    restored, _ = CheckpointManager(str(tmp_path)).restore(target)
    assert torch.equal(restored["w"].view(torch.int16), flat["w"].view(
        torch.int16))
    np.testing.assert_array_equal(restored["nested"]["s"].numpy(),
                                  tree["nested"]["s"])


def test_port_files_equal_the_reference_files(tmp_path):
    tree = _bf16_tree(1)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    JManager(str(jdir)).save(0, jax.tree_util.tree_map(jnp.asarray, tree),
                             wait=True)
    CheckpointManager(str(tdir)).save(0, {
        "w": torch.from_numpy(tree["w"].view(np.int16)).view(torch.bfloat16),
        "nested": {"s": torch.from_numpy(tree["nested"]["s"])}}, wait=True)
    names = sorted(os.listdir(jdir / "step_0"))
    assert names == sorted(os.listdir(tdir / "step_0"))
    assert "manifest.json" in names
    for name in names:
        assert (jdir / "step_0" / name).read_bytes() == \
            (tdir / "step_0" / name).read_bytes(), name


def test_other_unnumpyable_dtypes_are_refused(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    with pytest.raises(TypeError, match="numpy"):
        ckpt.save(0, {"f8": torch.zeros(2, dtype=torch.float8_e4m3fn)})


# -- train_loop ---------------------------------------------------------------

def test_train_loop_resumes_after_kill(tmp_path):
    params, state, step, data = _toy()
    ck = str(tmp_path / "ck")
    p1, s1, last = train_loop(step, params, state, data, 10, ck,
                              ckpt_every=4)
    assert last == 9
    assert CheckpointManager(ck).all_steps() == [3, 7, 9]
    p2, s2, last2 = train_loop(step, params, state, data, 12, ck,
                               ckpt_every=4)
    assert last2 == 11   # resumed at 10, ran 10..11


def test_train_loop_log_lines(tmp_path):
    import json

    params, state, step, data = _toy()
    log = tmp_path / "log.jsonl"
    train_loop(step, params, state, data, 3, str(tmp_path / "ck"),
               log_path=str(log))
    rows = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1, 2]
    assert set(rows[0]) == {"step", "loss", "grad_norm", "seconds"}


def test_preemption_checkpoints_and_stops(tmp_path):
    params, state, step, data = _toy()
    guard = PreemptionGuard()
    calls = []

    def on_metrics(s, m, dt):
        calls.append(s)
        if s == 3:
            guard.trigger()

    _, _, last = train_loop(step, params, state, data, 100,
                            str(tmp_path / "ck2"), ckpt_every=50,
                            guard=guard, on_metrics=on_metrics)
    assert last == 3 and calls == [0, 1, 2, 3]
    assert CheckpointManager(str(tmp_path / "ck2")).latest_step() == 3
    guard.uninstall()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_train_loop_directories_resume_across_packages(tmp_path, writer):
    """A float32 ``train_loop`` directory written by one package resumes
    in the other, at the next step, with the saved state bit for bit."""
    ck = str(tmp_path / "ck")
    jparams, jstate, jstep, jdata = _jtoy()
    tparams, tstate, tstep, tdata = _toy()
    if writer == "reference":
        jp, js, last = jtrain_loop(jstep, jparams, jstate, jdata, 4, ck)
        saved = jax.tree_util.tree_map(np.asarray, (jp, js))
        restored, at = CheckpointManager(ck).restore((tparams, tstate))
        assert at == last == 3
        for w, g in zip(jax.tree_util.tree_leaves(saved),
                        jax.tree_util.tree_leaves(restored)):
            np.testing.assert_array_equal(g.numpy(), w)
        seen = []
        _, _, last2 = train_loop(tstep, tparams, tstate, tdata, 6, ck,
                                 on_metrics=lambda i, m, dt: seen.append(i))
        assert seen == [4, 5] and last2 == 5
    else:
        tp, ts, last = train_loop(tstep, tparams, tstate, tdata, 4, ck)
        (jp, js), at = JManager(ck).restore((jparams, jstate))
        assert at == last == 3
        for g, w in zip(jax.tree_util.tree_leaves((jp, js)),
                        jax.tree_util.tree_leaves((tp, ts))):
            np.testing.assert_array_equal(np.asarray(g), w.numpy())
        seen = []
        _, _, last2 = jtrain_loop(jstep, jparams, jstate, jdata, 6, ck,
                                  on_metrics=lambda i, m, dt: seen.append(i))
        assert seen == [4, 5] and last2 == 5


def test_lm_train_loop_names_are_the_references(tmp_path):
    """An LM's snapshot stacks the layers: ``0/layers/attn/wq`` [L, d, h,
    hd] and ``1/layers/attn/wq/vr``."""
    from repro_torch.launch import steps

    cell = steps.build_cell("tinyllama-1.1b", "train_4k", smoke=True,
                            device="cpu")
    params = cell.init_params(0)
    state = cell.init_opt(params)
    CheckpointManager(str(tmp_path)).save(0, (params, state), wait=True)
    flat, _ = CheckpointManager(str(tmp_path)).restore(device="cpu")
    cfg = cell.config
    assert flat["0/layers/attn/wq"].shape == (cfg.n_layers, cfg.d_model,
                                              cfg.n_heads, cfg.hd)
    assert flat["1/layers/attn/wq/vr"].shape == (cfg.n_layers, cfg.d_model,
                                                 cfg.n_heads)
    assert flat["1/layers/ln1/scale/vc"].shape == (cfg.d_model,)
    other = cell.init_params(1)
    (back, _), _ = CheckpointManager(str(tmp_path)).restore((other, state))
    assert back is other
    for (_, a), (_, b) in zip(params.named_parameters(),
                              other.named_parameters()):
        assert torch.equal(a, b)


# -- monitors -----------------------------------------------------------------

def test_straggler_monitor_flags_slow_steps():
    fired = []
    mon = StragglerMonitor(window=20, factor=2.0, patience=2,
                           on_straggle=lambda *a: fired.append(a))
    for i in range(20):
        mon.record(i, 0.1)
    assert not mon.record(20, 0.15)
    assert mon.record(21, 0.5)
    assert mon.record(22, 0.5)
    assert fired
    assert mon.flagged_steps == [21, 22]


def test_heartbeat_failure_detection():
    hb = HeartbeatMonitor(timeout_s=10.0)
    hb.beat("host0", t=100.0)
    hb.beat("host1", t=100.0)
    hb.beat("host0", t=105.0)
    assert hb.dead_nodes(now=112.0) == ["host1"]
    assert hb.alive_nodes(now=112.0) == ["host0"]


@pytest.mark.parametrize("n,mp", [(512, 16), (256, 16), (248, 16), (7, 16),
                                  (96, 8), (1, 16)])
def test_largest_mesh_shape_matches_reference(n, mp):
    from repro.runtime.fault_tolerance import largest_mesh_shape as jlms

    assert largest_mesh_shape(n, mp) == jlms(n, mp)


def test_preemption_guard_restores_prior_handlers():
    prior_term = signal.getsignal(signal.SIGTERM)
    prior_int = signal.getsignal(signal.SIGINT)
    with PreemptionGuard() as guard:
        assert signal.getsignal(signal.SIGTERM) is not prior_term
        assert not guard.should_stop
        guard.trigger()
        assert guard.should_stop
    assert signal.getsignal(signal.SIGTERM) is prior_term
    assert signal.getsignal(signal.SIGINT) is prior_int


def test_train_loop_leaves_the_signal_handlers_as_it_found_them(tmp_path):
    prior = signal.getsignal(signal.SIGTERM)
    params, state, step, data = _toy()
    train_loop(step, params, state, data, 2, str(tmp_path))
    assert signal.getsignal(signal.SIGTERM) is prior


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("shard", [0, 1])
@pytest.mark.parametrize("seed", [0, 5])
def test_token_pipeline_matches_reference(seed, shard):
    j = jpipeline.TokenPipeline(4, 16, 1000, shard_id=shard, num_shards=2,
                                seed=seed)
    t = pipeline.TokenPipeline(4, 16, 1000, shard_id=shard, num_shards=2,
                               seed=seed)
    for _ in range(3):
        a, b = next(j), next(t)
        assert a.keys() == b.keys()
        for k in a:
            assert b[k].dtype == np.int32
            np.testing.assert_array_equal(b[k], a[k])


def test_token_pipeline_memmap(tmp_path):
    path = tmp_path / "tokens.bin"
    np.arange(1000, dtype=np.int32).tofile(path)
    for shard in (0, 1):
        j = jpipeline.TokenPipeline(2, 7, 1000, shard_id=shard,
                                    num_shards=2, memmap_path=str(path))
        t = pipeline.TokenPipeline(2, 7, 1000, shard_id=shard, num_shards=2,
                                   memmap_path=str(path))
        for _ in range(40):       # past the end: wraps to the shard start
            a, b = next(j), next(t)
            np.testing.assert_array_equal(b["tokens"], a["tokens"])
            np.testing.assert_array_equal(b["labels"], a["labels"])
        np.testing.assert_array_equal(b["labels"][:, :-1],
                                      b["tokens"][:, 1:])


def test_prefetcher_keeps_the_order_and_ends():
    got = list(pipeline.Prefetcher(iter(range(10)), depth=2))
    assert got == list(range(10))


def test_recsys_pipeline_matches_reference():
    from repro.configs import two_tower_retrieval as jtt

    cfg = jtt.smoke_config()
    a = next(jpipeline.RecsysPipeline(8, cfg, seed=3))
    b = next(pipeline.RecsysPipeline(8, cfg, seed=3))
    for k in a:
        np.testing.assert_array_equal(b[k], a[k])
