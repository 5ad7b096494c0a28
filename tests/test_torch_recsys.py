"""The port's two-tower retrieval (``repro_torch.models.recsys``, its cells
and its launcher) against the JAX package's at the smoke config (CPU,
float32): D 16, vocab 500, 3 fields of 4 slots, MLP 32-16.

Weights come from the reference's ``init_params`` and reach the port
through ``params_from_numpy``; batches from ``RecsysPipeline`` (the same
numpy stream in both packages), with -1 pads and one all-pad bag where a
bag is tested.  The gathered segment sum is checked in both of its forms
on the CPU: the plain one (masked gather + ``index_add``) and the K5 form
(``bag_order`` / ``table_order`` through K5's plain version, the exact
arguments the card's launches take).

Tolerances: bags 1e-6 abs (sums of at most 4 rows of magnitude 0.01-1 in
another order); towers, scores and loss 1e-5 abs (two f32 layers and a
norm); gradients 1e-5 abs + 1e-4 of the leaf's largest magnitude; three
adamw steps as ``test_torch_gnn_train.py`` (loss 1e-5 abs + 2e-6 of it,
grad norm 1e-4 relative, parameters 2e-5 abs + 1e-4 of the leaf's largest
magnitude: adamw's first update is about lr * sign(g)); top-k indices
equal and scores 1e-5.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import two_tower_retrieval as jconf
from repro.data.pipeline import RecsysPipeline as JPipeline
from repro.launch import steps as jsteps
from repro.models import recsys as jrec
from repro_torch.configs import two_tower_retrieval as conf
from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.kernels.segment_reduce import ops
from repro_torch.launch import steps, train
from repro_torch.models import recsys as rec
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

BAG_TOL, TOL = 1e-6, 1e-5
GRAD_ATOL, GRAD_RTOL_OF_MAX = 1e-5, 1e-4
ARCH = "two-tower-retrieval"


def _params(seed=0):
    jcfg, cfg = jconf.smoke_config(), conf.smoke_config()
    jp = jrec.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, cfg, jp, rec.params_from_numpy(tree, cfg, device="cpu")


def _batch(cfg, b=8, seed=0):
    host = next(JPipeline(b, cfg, seed=seed))
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.from_numpy(v) for k, v in host.items()})


def _ids(rng, shape, vocab):
    """ids with -1 pads, the first bag all pads."""
    ids = rng.integers(-1, vocab, shape).astype(np.int32)
    ids.reshape(-1, shape[-1])[0] = -1
    return ids


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=0)


def _close_tree(got, want, what, atol=GRAD_ATOL,
                rtol_of_max=GRAD_RTOL_OF_MAX):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_leaves(got)
    assert len(flat_w) == len(flat_g)
    for (path, w), g in zip(flat_w, flat_g):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(
            g.detach().numpy(), w, rtol=0,
            atol=atol + rtol_of_max * float(np.abs(w).max()),
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def test_config_mirrors_the_reference():
    for make in ("make_config", "smoke_config"):
        j, p = getattr(jconf, make)(), getattr(conf, make)()
        for f in dataclasses.fields(p):
            if f.name != "dtype":
                assert getattr(p, f.name) == getattr(j, f.name), f.name
        assert p.dtype == torch.float32
    assert conf.ARCH_ID == jconf.ARCH_ID and conf.FAMILY == jconf.FAMILY


def test_init_params_has_the_reference_tree():
    jcfg, cfg, jp, _ = _params()
    port = rec.init_params(cfg, seed=0, device="cpu")
    want = jax.tree_util.tree_map(lambda a: a.shape, jp)
    got = jax.tree_util.tree_map(lambda t: tuple(t.shape), port.tree())
    assert got == want
    assert not any(p.requires_grad for p in port.parameters())
    big = dataclasses.replace(cfg, user_vocab=20000, embed_dim=64)
    t = rec.init_params(big, seed=1, device="cpu")["user_table"]
    assert abs(float(t.std()) - 0.01) < 2e-4


@pytest.mark.parametrize("combine", ["sum", "mean", "max"])
def test_embedding_bag_matches_reference(combine):
    rng = np.random.default_rng(1)
    table = rng.normal(size=(500, 16)).astype(np.float32)
    ids = _ids(rng, (6, 3, 4), 500)
    want = jrec.embedding_bag(jnp.asarray(table), jnp.asarray(ids), combine)
    got = rec.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                            combine)
    assert tuple(got.shape) == want.shape == (6, 3, 16)
    _close(got, want, BAG_TOL)
    assert not got[0, 0].any()                   # the all-pad bag


@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_embedding_bag_ragged_matches_reference(combine):
    rng = np.random.default_rng(2)
    table = rng.normal(size=(500, 16)).astype(np.float32)
    flat = _ids(rng, (40,), 500)
    bags = rng.integers(0, 9, 40).astype(np.int32)
    bags[bags == 8] = 7                          # bag 8 stays empty
    want = jrec.embedding_bag_ragged(jnp.asarray(table), jnp.asarray(flat),
                                     jnp.asarray(bags), 9, combine)
    got = rec.embedding_bag_ragged(torch.from_numpy(table),
                                   torch.from_numpy(flat),
                                   torch.from_numpy(bags), 9, combine)
    _close(got, want, BAG_TOL)
    assert not got[8].any()


def _k5_form(table, rows, seg_ids, n):
    """``gather_segment_sum``'s CUDA route on CPU tensors: the sorts and
    K5's arguments as on the card, K5's plain version in its place."""
    keys = ops.slot_keys(rows, seg_ids, n, table.shape[0])
    return ops._GatherSegmentSum.apply(table, rows, keys, n)


@pytest.mark.parametrize("form", ["plain", "k5"])
def test_gathered_segment_sum_and_table_grad_match_jax_grad(form):
    """Forward, counts and the dense table gradient of fixed bags against
    the reference's ``embedding_bag`` and its ``jax.grad``; slots past the
    table (>= V) are dropped like pads (the reference, whose ``jnp.take``
    fills them with NaN, gets them as pads)."""
    rng = np.random.default_rng(3)
    table = rng.normal(size=(500, 16)).astype(np.float32)
    table[:] *= rng.choice([1e-3, 1.0, 30.0], (500, 1))
    ids = _ids(rng, (12, 3, 4), 40)              # repeated rows
    padded = ids.copy()
    ids.reshape(-1)[[5, 17, 40]] = [500, 731, 2 ** 31 - 1]
    padded.reshape(-1)[[5, 17, 40]] = -1
    cot = rng.normal(size=(12, 3, 16)).astype(np.float32)
    want, vjp = jax.vjp(
        lambda t: jrec.embedding_bag(t, jnp.asarray(padded)),
        jnp.asarray(table))
    (want_grad,) = vjp(jnp.asarray(cot))
    t = torch.from_numpy(table).requires_grad_(True)
    flat = torch.from_numpy(ids).reshape(-1)
    bags = torch.arange(flat.shape[0], dtype=torch.int32) // 4
    fn = ops.gather_segment_sum_plain if form == "plain" else _k5_form
    out, counts = fn(t, flat, bags, 36)
    np.testing.assert_array_equal(counts.numpy(),
                                  (padded >= 0).reshape(36, 4).sum(-1))
    assert counts.dtype == torch.int32
    np.testing.assert_allclose(out.detach().numpy().reshape(12, 3, 16),
                               np.asarray(want), rtol=2e-6, atol=1e-6)
    (grad,) = torch.autograd.grad(out, t, torch.from_numpy(cot).reshape(
        36, 16))
    assert tuple(grad.shape) == (500, 16)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad),
                               atol=1e-6, rtol=1e-6)
    assert not grad[40:].any()                   # rows no slot reads


@pytest.mark.parametrize("combine", ["sum", "mean", "max"])
def test_embedding_bag_drops_ids_past_the_table_like_pads(combine):
    """An id >= V reads nothing and counts as no slot, in every combine:
    the port's bag equals the reference's with those ids set to -1."""
    rng = np.random.default_rng(7)
    table = rng.normal(size=(500, 16)).astype(np.float32)
    ids = _ids(rng, (6, 3, 4), 500)
    padded = ids.copy()
    ids[2, 1] = [500, 2 ** 31 - 1, 3, 9999]       # one live slot left
    ids[4, 0] = 600                              # a bag past the table
    padded[2, 1] = [-1, -1, 3, -1]
    padded[4, 0] = -1
    want = jrec.embedding_bag(jnp.asarray(table), jnp.asarray(padded),
                              combine)
    got = rec.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                            combine)
    assert np.isfinite(np.asarray(want)).all()
    _close(got, want, BAG_TOL)
    assert not got[4, 0].any()


def test_k5_form_is_the_plain_form_bitwise_at_one_row_a_bag():
    """A bag of one slot (the item tower's lookup) copies its row in both
    forms; the table gradient of distinct rows is the output gradient."""
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.normal(size=(50, 8)).astype(np.float32))
    ids = torch.from_numpy(rng.permutation(50)[:20].astype(np.int32))
    seg = torch.arange(20, dtype=torch.int32)
    t = table.clone().requires_grad_(True)
    out, _ = _k5_form(t, ids, seg, 20)
    assert torch.equal(out, table[ids.long()])
    g = torch.randn(20, 8)
    (grad,) = torch.autograd.grad(out, t, g)
    assert torch.equal(grad[ids.long()], g)


@pytest.mark.parametrize("what", ["user_tower", "item_tower", "score",
                                  "loss_fn"])
def test_towers_score_and_loss_match_reference(what):
    jcfg, cfg, jp, tp = _params()
    jb, tb = _batch(cfg)
    if what == "user_tower":
        want = jrec.user_tower(jp, jb["user_ids"], jb["user_dense"], jcfg)
        got = rec.user_tower(tp, tb["user_ids"], tb["user_dense"], cfg)
    elif what == "item_tower":
        want = jrec.item_tower(jp, jb["item_ids"], jb["item_dense"], jcfg)
        got = rec.item_tower(tp, tb["item_ids"], tb["item_dense"], cfg)
    else:
        want = getattr(jrec, what)(jp, jb, jcfg)
        got = getattr(rec, what)(tp, tb, cfg)
    assert tuple(got.shape) == tuple(np.shape(want))
    _close(got, want)


def test_retrieval_topk_matches_reference():
    jcfg, cfg, jp, tp = _params(seed=1)
    jb, tb = _batch(cfg, b=1, seed=1)
    cand = np.random.default_rng(5).normal(size=(300, 16)).astype(
        np.float32)
    jv, ji = jrec.retrieval_topk(
        jp, {**jb, "cand_emb": jnp.asarray(cand)}, jcfg, k=20)
    tv, ti = rec.retrieval_topk(tp, {**tb, "cand_emb": torch.from_numpy(
        cand)}, cfg, k=20)
    assert ti.dtype == torch.int32 and tv.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tv, jv)


@pytest.mark.parametrize("loss_rows", [rec.LOSS_ROWS, 3])
def test_loss_gradients_match_reference_on_every_leaf(loss_rows,
                                                      monkeypatch):
    """Every leaf of the params tree, the two tables' dense gradients
    among them; the in-batch softmax's row chunks whole and of 3 rows (the
    last chunk shorter)."""
    monkeypatch.setattr(rec, "LOSS_ROWS", loss_rows)
    jcfg, cfg, jp, tp = _params(seed=2)
    jb, tb = _batch(cfg, seed=2)
    jl, jg = jax.value_and_grad(jrec.loss_fn)(jp, jb, jcfg)
    tree = tp.requires_grad_(True).tree()
    leaves = jax.tree_util.tree_leaves(tree)
    loss = rec.loss_fn(tp, tb, cfg)
    grads = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree),
        torch.autograd.grad(loss, leaves))
    assert abs(loss.item() - float(jl)) <= TOL
    assert float(np.abs(np.asarray(jg["user_table"])).max()) > 0
    _close_tree(grads, jg, "grad")


def test_train_cell_three_steps_match_reference():
    jcell = jsteps.build_cell(ARCH, "train_batch", smoke=True)
    cell = steps.build_cell(ARCH, "train_batch", smoke=True, device="cpu")
    _, cfg, jp, tp = _params(seed=3)
    js, ts = jcell.init_opt(jp), cell.init_opt(tp)
    jstep = jax.jit(jcell.step)
    pipe = JPipeline(8, cfg, seed=3)
    for i in range(3):
        host = next(pipe)
        jp, js, jm = jstep(jp, js, i, {k: jnp.asarray(v)
                                       for k, v in host.items()})
        tp, ts, m = cell.step(tp, ts, i, {k: torch.from_numpy(v)
                                          for k, v in host.items()})
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            1e-5 + 2e-6 * abs(float(jm["loss"]))
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-4 * float(jm["grad_norm"])
    _close_tree(tp.tree(), jp, "params", atol=2e-5)
    _close_tree(ts, js, "adamw state", atol=1e-6)


@pytest.mark.parametrize("shape", ["serve_p99", "serve_bulk",
                                   "retrieval_cand"])
def test_serve_and_retrieval_cells_match_reference(shape):
    jcell = jsteps.build_cell(ARCH, shape, smoke=True)
    cell = steps.build_cell(ARCH, shape, smoke=True, device="cpu")
    assert (cell.family, cell.mode) == (jcell.family, jcell.mode)
    spec, jspec = cell.input_specs(), jcell.input_specs()
    assert spec.keys() == jspec.keys()
    for k, v in spec.items():
        assert v.shape == jspec[k].shape, k
        assert str(v.dtype).removeprefix("torch.") == jspec[k].dtype.name
    _, cfg, jp, tp = _params(seed=4)
    host = next(JPipeline(spec["user_ids"].shape[0], cfg, seed=4))
    host = {k: host[k] for k in spec if k in host}
    if "cand_emb" in spec:
        host["cand_emb"] = np.random.default_rng(6).normal(
            size=spec["cand_emb"].shape).astype(np.float32)
    want = jcell.step(jp, {k: jnp.asarray(v) for k, v in host.items()})
    got = cell.step(tp, {k: torch.from_numpy(v) for k, v in host.items()})
    if shape == "retrieval_cand":
        assert got[1].shape == (100,)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        got, want = got[0], want[0]
    assert not got.requires_grad
    _close(got, want)


def test_full_cells_have_the_reference_specs():
    for shape in RECSYS_SHAPES:
        cell = steps.build_cell(ARCH, shape, device="cpu")
        jspec = jsteps.build_cell(ARCH, shape).input_specs()
        assert {k: v.shape for k, v in cell.input_specs().items()} == \
            {k: v.shape for k, v in jspec.items()}
    cut = steps.build_cell(ARCH, "train_batch", batch=4096, device="cpu")
    assert cut.input_specs()["user_ids"].shape == (4096, 8, 16)


def test_data_for_is_the_reference_pipeline_bitwise():
    cell = steps.build_cell(ARCH, "train_batch", smoke=True, device="cpu")
    ours = train.data_for(cell)
    theirs = JPipeline(8, jconf.smoke_config())
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_train_cli_runs_and_resumes(tmp_path, capsys):
    args = ["--arch", ARCH, "--smoke", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--log", str(tmp_path / "log.jsonl")]
    _, _, last = train.main(args + ["--steps", "3"])
    assert last == 2
    _, _, last = train.main(args + ["--steps", "5"])
    assert last == 4
    out = capsys.readouterr().out
    assert [ln.split(":")[0] for ln in out.splitlines()] == [
        f"step {i}" for i in range(5)]
    logged = [json.loads(ln) for ln in
              (tmp_path / "log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in logged] == list(range(5))
    assert all(np.isfinite(r["loss"]) for r in logged)


def test_train_cli_saves_no_snapshot_at_ckpt_every_0(tmp_path):
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "0"]
    assert train.main(args)[2] == 1
    assert not any((tmp_path / ARCH).glob("step_*"))
    assert train.main(args)[2] == 1              # nothing to resume from


def test_in_batch_softmax_takes_one_backward():
    """Its backward turns the saved logits into their gradient in place, so
    a second backward through a retained graph raises rather than read
    the changed buffer."""
    _, cfg, _, tp = _params(seed=5)
    _, tb = _batch(cfg, seed=5)
    tree = tp.requires_grad_(True).tree()
    loss = rec.loss_fn(tp, tb, cfg)
    torch.autograd.grad(loss, tree["user_table"], retain_graph=True)
    with pytest.raises(RuntimeError, match="first backward"):
        torch.autograd.grad(loss, tree["user_table"])


def test_first_adamw_step_raises_its_batch_loss_at_full_width(monkeypatch):
    """At the published widths (D 256, MLPs 1024-512-256; vocab cut to
    1000, batch 512) the train cell's first adamw(1e-3) update, about
    1e-3 * sign(g) on every weight a slot reaches, raises the loss on its
    own batch in the reference and in the port alike, while a plain step of
    1e-3 along the gradient lowers it in both: descent at step 0 is checked
    with the plain step.  The three losses agree within 1e-5 relative."""
    small = dict(user_vocab=1000, item_vocab=1000)
    for mod in (conf, jconf):
        monkeypatch.setattr(mod, "make_config",
                            lambda m=mod.make_config: dataclasses.replace(
                                m(), **small))
    jcell = jsteps.build_cell(ARCH, "train_batch")
    cell = steps.build_cell(ARCH, "train_batch", batch=512, device="cpu")
    jcfg, cfg = jcell.config, cell.config
    jp = jcell.init_params(jax.random.PRNGKey(0))
    tp = rec.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                               device="cpu")
    jb, tb = _batch(cfg, b=512, seed=0)
    jloss = jax.jit(lambda p: jrec.loss_fn(p, jb, jcfg))
    jg = jax.grad(lambda p: jrec.loss_fn(p, jb, jcfg))(jp)
    j_plain = jax.tree_util.tree_map(lambda a, g: a - 1e-3 * g, jp, jg)
    j_adamw = jax.jit(jcell.step)(jp, jcell.init_opt(jp), 0, jb)[0]
    want = [float(jloss(p)) for p in (jp, j_plain, j_adamw)]

    leaves = jax.tree_util.tree_leaves(tp.requires_grad_(True).tree())
    grads = torch.autograd.grad(rec.loss_fn(tp, tb, cfg), leaves)
    got = []
    with torch.no_grad():
        got.append(float(rec.loss_fn(tp, tb, cfg)))
        saved = [x.clone() for x in leaves]
        for x, g in zip(leaves, grads):
            x.sub_(g, alpha=1e-3)
        got.append(float(rec.loss_fn(tp, tb, cfg)))
        for x, s in zip(leaves, saved):
            x.copy_(s)
    tp = cell.step(tp, cell.init_opt(tp), 0, tb)[0]
    with torch.no_grad():
        got.append(float(rec.loss_fn(tp, tb, cfg)))
    for before, plain, adamw in (want, got):
        assert plain < before < adamw
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-5 * abs(w), (got, want)
