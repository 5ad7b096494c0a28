"""The sharded LM's ranks on the CPU, for ``tests/test_torch_dist.py``.

``python tests/torch_dist_worker.py OUT_DIR`` reads ``OUT_DIR/inputs.npz``
(the JAX package's weights and data, written by the test), runs a world
of one in this process, then spawns 4 ``gloo`` ranks
(``torch.multiprocessing``, a file store under OUT_DIR) that run every
multi-rank check in one start:

* the narrow tinyllama-shaped LM (:data:`NARROW`) through its train cell
  under ``cell.context(mesh)``: loss and gradients on (1, 4), then one
  train step (adafactor) on (2, 2), whose loss and gradients (the tree it
  clips) stand for that mesh's; decode with the cache's positions split;
* the phi3.5-moe-shaped MoE layer (:data:`MOE`) through ``moe_apply``
  under the plan on (2, 2);
* the pipeline and ``compressed_psum_mean`` on the 2-rank ``pod`` groups
  of a (2, 2) mesh;
* ``ElasticScaler``: the step's params and optimizer state saved from the
  4-rank mesh, restored onto ranks 0 and 1.

The world of one holds the sharded train step, prefill and decode
bitwise against the unsharded port.  Rank 0 writes ``results.json``
(check -> [passed, detail]) and ``out.npz`` (the numbers the test holds
against the JAX package).  Imports only ``repro_torch``."""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# the narrow LM: tinyllama's shape at widths where param_sharding splits
# the embedding, the unembedding and the FFN (leaves of 1024 and more)
NARROW = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=1024,
              vocab=2048, head_dim=64, norm="rmsnorm", act="silu",
              tie_embeddings=False)
BATCH, SEQ = 4, 64
# the MoE layer: phi3.5-moe's routing (16 -> 4 experts, top 2) with an
# expert d_ff the model axis splits and a capacity that drops rows
MOE = dict(n_experts=4, top_k=2, d_ff=1024, capacity_factor=0.25)
MOE_D, MOE_T = 256, 512
N_MICRO, N_STAGES = 4, 2


def unflatten(flat: dict, prefix: str) -> dict:
    """{"a/b/c": x} (keys under ``prefix/``) -> nested dicts."""
    out: dict = {}
    for key, val in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        *path, last = key[len(prefix) + 1:].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = val
    return out


def _flatten(tree, prefix: str) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _configs():
    from repro_torch.configs import tinyllama_1_1b
    from repro_torch.models.moe import MoEConfig

    cfg = dataclasses.replace(tinyllama_1_1b.smoke_config(), **NARROW)
    return cfg, MoEConfig(**MOE)


def _full(t):
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


def _np(tree):
    from repro_torch.optim import tree_map
    return tree_map(lambda t: _full(t).numpy(), tree)


def _lm(inputs, cfg):
    from repro_torch.models import transformer
    return transformer.params_from_numpy(unflatten(inputs, "lm"), cfg,
                                         device="cpu")


def _batch(inputs):
    return {"tokens": torch.from_numpy(inputs["tokens"]),
            "labels": torch.from_numpy(inputs["labels"])}


def _place_batch(batch, specs):
    from repro_torch.launch.steps import place
    return place(batch, specs)


def _grads(cell, params, batch):
    """(loss, gradient tree) of the cell's loss under its context.  The
    backward runs on another thread, which has no sharding context (the
    autograd engine's device thread on the card): the remat recompute
    must bind the forward's."""
    import threading

    from repro_torch.models import transformer
    from repro_torch.optim import laid_out_as, tree_map

    tree = params.requires_grad_(True).tree()
    leaves = []
    tree_map(leaves.append, tree)
    loss = transformer.loss_fn(params, batch["tokens"], batch["labels"],
                               cell.config)
    out = []
    t = threading.Thread(target=lambda: out.append(
        torch.autograd.grad(loss, leaves)))
    t.start()
    t.join()
    if not out:
        raise RuntimeError("the backward failed on its thread")
    got = iter(out[0])
    return loss, tree_map(lambda p: laid_out_as(next(got), p), tree)


# ---------------------------------------------------------------------------
# a world of one: bitwise the unsharded port
# ---------------------------------------------------------------------------

def world_of_one(inputs) -> dict:
    """The sharded entry points on a (1, 1) mesh against the unsharded
    ones on the same inputs, bit for bit: the train step (loss and every
    parameter after it) and a MoE LM's prefill and two decode steps under
    the plan."""
    from repro_torch.configs import phi3_5_moe_42b
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import lm_mesh
    from repro_torch.models import transformer

    res = {}
    cfg, _ = _configs()
    mesh = lm_mesh((1, 1), device="cpu")
    try:
        cell = steps.build_cell("tinyllama-1.1b", "train_4k", batch=BATCH,
                                device="cpu", config=cfg)
        batch = _batch(inputs)
        outs = []
        for sharded in (False, True):
            params = _lm(inputs, cfg)
            opt = cell.init_opt(params)
            b = batch
            if sharded:
                params = steps.place(params, cell.param_shardings(mesh,
                                                                  params))
                opt = cell.init_opt(params)
                b = _place_batch(batch, cell.batch_spec_fn(mesh))
                with cell.context(mesh):
                    params, opt, m = cell.step(params, opt, 0, b)
            else:
                params, opt, m = cell.step(params, opt, 0, b)
            outs.append((_full(m["loss"]), _np(params.tree())))
        (l0, p0), (l1, p1) = outs
        same = bool(torch.equal(l0, l1)) and all(
            np.array_equal(a, b) for a, b in zip(
                _flatten(p0, "p").values(), _flatten(p1, "p").values()))
        res["one_train_step_bitwise"] = [same, f"loss {float(l0)} "
                                               f"{float(l1)}"]

        mcfg = dataclasses.replace(phi3_5_moe_42b.smoke_config(),
                                   remat=False)
        mcell = steps.build_cell("phi3.5-moe-42b-a6.6b", "decode_32k",
                                 smoke=True, device="cpu", config=mcfg)
        toks = torch.randint(0, mcfg.vocab, (2, 16),
                             generator=torch.Generator().manual_seed(4))
        runs = []
        for sharded in (False, True):
            p, t = mcell.init_params(3), toks
            if sharded:
                p = steps.place(p, mcell.param_shardings(mesh, p))
                t = _place_batch({"t": toks}, {"t": steps.NamedSharding(
                    mesh, (("data",), None))})["t"]
            with (mcell.context(mesh) if sharded else
                  contextlib.nullcontext()):
                logits, cache = transformer.prefill(p, t, mcfg, 20)
                seq = [_full(logits)]
                tok = t[:, -1:]
                for i in range(2):
                    lg, cache = transformer.decode_step(p, tok, cache,
                                                        16 + i, mcfg)
                    seq.append(_full(lg))
            runs.append(seq)
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        res["one_moe_prefill_decode_bitwise"] = [same, ""]
    finally:
        dist.destroy_process_group()
    return res


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------

def _checks(rank: int, out_dir: str):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.dist import compressed_dp
    from repro_torch.dist.compressed_dp import (compressed_psum_mean,
                                                init_error_state)
    from repro_torch.dist.pipeline import make_pipeline_fn
    from repro_torch.dist.sharding import moe_apply
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import lm_mesh
    from repro_torch.models import moe as moe_mod
    from repro_torch.runtime.fault_tolerance import ElasticScaler
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist.sharding import distribute
    from functools import partial

    inputs = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    cfg, mcfg = _configs()
    res, arrays = {}, {}
    cell = steps.build_cell("tinyllama-1.1b", "train_4k", batch=BATCH,
                            device="cpu", config=cfg)
    batch = _batch(inputs)

    # the LM's loss and gradients on (1, 4), the backward on a thread
    mesh = lm_mesh((1, 4), device="cpu")
    params = _lm(inputs, cfg)
    params = steps.place(params, cell.param_shardings(mesh, params))
    with cell.context(mesh):
        loss, grads = _grads(cell, params, _place_batch(
            batch, cell.batch_spec_fn(mesh)))
    _record(res, arrays, "1x4", loss, grads, params)

    # one train step (clip + adafactor) on (2, 2), its loss and gradients
    # (the tree the step clips), then the snapshot
    mesh = lm_mesh((2, 2), device="cpu")
    res[f"decode_split_rank{rank}"] = _decode_check(inputs, cfg, mesh)
    params = _lm(inputs, cfg)
    params = steps.place(params, cell.param_shardings(mesh, params))
    opt = cell.init_opt(params)
    seen, clip = [], steps.clip_by_global_norm

    def clip_seen(tree, max_norm):
        seen.append(tree)
        return clip(tree, max_norm)

    steps.clip_by_global_norm = clip_seen
    try:
        with cell.context(mesh):
            params, opt, m = cell.step(params, opt, 0, _place_batch(
                batch, cell.batch_spec_fn(mesh)))
    finally:
        steps.clip_by_global_norm = clip
    _record(res, arrays, "2x2", m["loss"], seen[0], params)
    arrays["step-loss"] = arrays["loss-2x2"]
    for k, v in _flatten(_np(params.tree()), "step").items():
        arrays[k] = v

    # ElasticScaler: save on the 4-rank mesh, restore onto ranks 0 and 1
    ck_dir = os.path.join(out_dir, "ckpt")
    mgr = CheckpointManager(ck_dir)
    saved = {"params": params.tree(), "opt": opt}
    mgr.save(1, saved, wait=True)
    dist.barrier()
    want = _np(saved)
    target = {"params": _lm(inputs, cfg).tree(),
              "opt": cell.init_opt(_lm(inputs, cfg))}

    def shardings(m, tree):
        from repro_torch.dist.rules import param_sharding
        return param_sharding(tree, m, "lm")

    tree, small, step = ElasticScaler(mgr).rescale(target, shardings,
                                                   world=[0, 1])
    if tree is not None:
        got = _np(tree)
        flat_w, flat_g = _flatten(want, "t"), _flatten(got, "t")
        bad = [k for k in flat_w if not np.array_equal(flat_w[k],
                                                       flat_g[k])]
        split = any(p.is_shard() for p in
                    tree["params"]["embed"].placements)
        res[f"elastic_rank{rank}"] = [
            not bad and step == 1 and tuple(small.shape) == (1, 2) and split,
            f"differ {bad[:3]}, step {step}, mesh {tuple(small.shape)}"]

    # the MoE layer under the plan on (2, 2)
    mesh = lm_mesh((2, 2), device="cpu")
    with steps.build_cell("phi3.5-moe-42b-a6.6b", "train_4k", smoke=True,
                          device="cpu").context(mesh):
        mp_ = {k: torch.from_numpy(v) for k, v in
               unflatten(inputs, "moe").items()}
        rep = steps.NamedSharding(mesh, ())
        mp_ = {k: distribute(v, mesh, rep.placements)
               for k, v in mp_.items()}
        x = distribute(torch.from_numpy(inputs["moe_x"]), mesh,
                       rep.placements)
        # the sharded layer's routing and kept rows, as it decides them
        routed, kept_rows = [], moe_mod.kept_rows

        def recorded(idx, c):
            routed.append((idx, kept_rows(idx, c)))
            return routed[-1][1]

        moe_mod.kept_rows = recorded
        try:
            y, aux = moe_apply(partial(moe_mod.moe_ffn, cfg=mcfg), mp_, x)
        finally:
            moe_mod.kept_rows = kept_rows
    arrays["moe-idx"], arrays["moe-kept"] = (t.numpy() for t in routed[0])
    arrays["moe-y"] = _full(y).numpy()
    for k, v in aux.items():
        arrays[f"moe-aux-{k}"] = _full(v).numpy()

    # the pipeline and the compressed mean on the 2-rank pod groups
    pods = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "x"))
    stage = pods.get_local_rank(0)
    fn = make_pipeline_fn(pods, lambda w, x: torch.tanh(x @ w), N_STAGES,
                          N_MICRO, axis="pod")
    ys = fn(torch.from_numpy(inputs["pipe_ws"][stage:stage + 1]),
            torch.from_numpy(inputs["pipe_xs"]))
    arrays[f"pipe-ys-{rank}"] = ys.numpy()
    g = torch.from_numpy(inputs["cdp_g"][stage])
    err = init_error_state({"g": g})
    mean, new_err = compressed_psum_mean({"g": g}, err, pods.get_group(0),
                                         2)
    arrays[f"cdp-mean-{rank}"] = mean["g"].numpy()
    arrays[f"cdp-err-{rank}"] = new_err["g"].numpy()
    arrays[f"cdp-q-{rank}"] = compressed_dp._compress_leaf(
        g, err["g"], pods.get_group(0))[0].numpy()
    res[f"refusals_rank{rank}"] = _refusals(mesh)
    return res, arrays


def _decode_check(inputs, cfg, mesh):
    """A prefill of 16 tokens and two decode steps on (2, 2), the cache
    laid out as the decode cell lays it out (its 20 positions split over
    ``model``: the rank holding a position writes it, the softmax combines
    the two halves), against the unsharded port within 1e-5."""
    from repro_torch.dist.sharding import constrain
    from repro_torch.launch import steps
    from repro_torch.models import transformer

    cell = steps.build_cell("tinyllama-1.1b", "decode_32k", batch=BATCH,
                            device="cpu", config=cfg)
    toks = torch.from_numpy(inputs["tokens"][:, :16])
    runs = []
    for sharded in (False, True):
        params, t = _lm(inputs, cfg), toks
        specs = cell.batch_spec_fn(mesh)
        if sharded:
            params = steps.place(params, cell.param_shardings(mesh, params))
            t = steps.place({"t": toks}, {"t": specs["token"]})["t"]
        with (cell.context(mesh) if sharded else contextlib.nullcontext()), \
                torch.no_grad():
            logits, cache = transformer.prefill(params, t, cfg, 20)
            if sharded:
                cache = {k: constrain(v, mesh, specs["cache"][k].spec)
                         for k, v in cache.items()}
            seq = [_full(logits)]
            for i in range(2):
                nxt = torch.from_numpy(inputs["tokens"][:, 16 + i:17 + i])
                if sharded:
                    nxt = steps.place({"t": nxt}, {"t": specs["token"]})["t"]
                logits, cache = transformer.decode_step(params, nxt, cache,
                                                        16 + i, cfg)
                seq.append(_full(logits))
        runs.append(seq)
    err = max(float(((a - b).abs() / (1 + b.abs())).max())
              for a, b in zip(runs[1], runs[0]))
    split = any(p.is_shard() and p.dim == 3 for p in cache["k"].placements)
    return [err <= 1e-5 and split, f"max err {err}, positions split {split}"]


def _record(res, arrays, tag, loss, grads, params):
    arrays[f"loss-{tag}"] = _full(loss).numpy()
    for k, v in _flatten(_np(grads), f"grad-{tag}").items():
        arrays[k] = v
    emb = params.tree()["embed"]
    res[f"embed_sharded-{tag}"] = [
        any(p.is_shard() for p in emb.placements), str(emb.placements)]


def _refusals(mesh):
    """No fallback on the sharded path: a DTensor at the K4 wrapper, a
    layout for a plain tensor and an attention layout the per-rank kernel
    cannot run (the sequence split) each raise."""
    from repro_torch.dist.rules import placements
    from repro_torch.dist.sharding import constrain, distribute
    from repro_torch.kernels.flash_attention import kernel, ops

    heads = distribute(torch.zeros(2, 4, 8, 64), mesh,
                       placements(("data", "model", None, None), mesh))
    seq = distribute(torch.zeros(2, 4, 8, 64), mesh,
                     placements(("data", None, "model", None), mesh))
    cases = [("k4_dtensor", lambda: kernel.flash_attention(heads, heads,
                                                          heads), TypeError),
             ("plain_layout", lambda: constrain(torch.zeros(4), mesh,
                                                ("data",)), TypeError),
             ("seq_split", lambda: ops.attention(seq, seq, seq), ValueError)]
    missed = []
    for name, fn, exc in cases:
        try:
            fn()
            missed.append(name)
        except exc:
            pass
    return [not missed, f"did not raise: {missed}"]


def _rank(rank: int, world: int, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'store')}",
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        try:
            res, arrays = _checks(rank, out_dir)
        except Exception:
            res, arrays = {"ranks": [False, traceback.format_exc()]}, {}
        got = [None] * world
        dist.all_gather_object(got, (res, arrays))
        if rank == 0:
            res, arrays = {}, {}
            for r, a in got:
                res.update(r)
                arrays.update(a)
            np.savez(os.path.join(out_dir, "out.npz"), **arrays)
            with open(os.path.join(out_dir, "results.json"), "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    out = sys.argv[1]
    # the ranks start while this process runs the world of one
    ranks = mp.spawn(_rank, args=(4, out), nprocs=4, join=False)
    torch.set_num_threads(1)
    inputs = dict(np.load(os.path.join(out, "inputs.npz")))
    try:
        one = world_of_one(inputs)
    except Exception:
        one = {"world_of_one": [False, traceback.format_exc()]}
    with open(os.path.join(out, "one.json"), "w") as f:
        json.dump(one, f)
    while not ranks.join():
        pass
