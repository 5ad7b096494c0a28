"""Cells: (architecture x input shape) -> step fn + input specs
(the port of ``repro/launch/steps.py`` for the LM family).

The train step is the reference's ``_make_train_step``: the gradient of
the loss (over ``n_micro`` contiguous micro-batches of ``B / n_micro``
rows, accumulated in float32 when ``n_micro <= 2`` and in bfloat16
otherwise), clipped to a global norm of 1.0, one optimizer update, then
``p + u`` in place.  The optimizer sees the reference's leaves: the
model's parameters are its tree, each layer leaf one ``[L, ...]`` tensor
(``Transformer.tree``).  Profiler ranges:
``repro_torch.train.{forward,backward,optimizer}`` (the optimizer's
includes the clip and ``p + u``).

The reference's shardings (``batch_spec_fn``, ``context``) belong to the
sharded runtime, and its GNN and recsys cells to their models (ROADMAP
queue 1 item 12): ``build_cell`` raises ``NotImplementedError`` for them
(through ``registry.get_module``).  Its ``REPRO_ACCUM_DTYPE`` experiment
switch is not ported, and its ``REPRO_KV_QUANT`` switch of the decode
cell is ``dataclasses.replace(cfg, kv_quant=True)`` on a config the
caller builds.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.profiler import record_function

from ..configs import registry
from ..configs.shapes import LMShape
from ..models import transformer
from ..optim import adafactor, clip_by_global_norm, tree_map

__all__ = ["Cell", "Spec", "build_cell", "pad_to"]

# grad-accumulation factors for the train_4k cells (memory plan)
_LM_MICROBATCHES = {
    "command-r-plus-104b": 8,
    "grok-1-314b": 4,
    "phi3.5-moe-42b-a6.6b": 4,
    "qwen2-7b": 2,
    "tinyllama-1.1b": 1,
}


def pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


class Spec(NamedTuple):
    """An input's shape and dtype (``jax.ShapeDtypeStruct``'s role)."""
    shape: tuple
    dtype: torch.dtype


class Cell(NamedTuple):
    arch_id: str
    shape_name: str
    family: str           # lm
    mode: str             # train | prefill | decode
    config: Any
    init_params: Callable             # (seed) -> params on the cell's device
    init_opt: Callable | None         # (params) -> opt_state
    step: Callable                    # see mode-specific signatures
    input_specs: Callable             # () -> dict of Spec


def _make_train_step(loss_fn, optimizer, n_micro: int = 1):
    """Train step with optional gradient-accumulation microbatching (one
    optimizer update).  ``step(params, opt_state, step_no, batch) ->
    (params, opt_state, {"loss", "grad_norm"})``; ``params`` (a
    ``Transformer``) is updated in place and returned."""
    acc_dtype = torch.float32 if n_micro <= 2 else torch.bfloat16

    def grads_of(params, tree, batch):
        with record_function("repro_torch.train.forward"):
            loss = loss_fn(params, batch)
        with record_function("repro_torch.train.backward"):
            leaves = []
            tree_map(leaves.append, tree)
            grads = iter(torch.autograd.grad(loss, leaves))
        return loss, tree_map(lambda _: next(grads), tree)

    def step(params, opt_state, step_no, batch):
        tree = params.requires_grad_(True).tree()
        if n_micro == 1:
            loss, grads = grads_of(params, tree, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % n_micro:
                raise ValueError(f"batch {b} does not split into {n_micro} "
                                 f"micro-batches")
            m = b // n_micro
            acc, losses = None, []
            for i in range(n_micro):
                mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                loss_i, g = grads_of(params, tree, mb)
                acc = (tree_map(lambda x: x.to(acc_dtype), g) if acc is None
                       else tree_map(lambda a, x: a + x.to(acc_dtype), acc,
                                     g))
                losses.append(loss_i.detach())
            grads = tree_map(lambda a: a / n_micro, acc)
            loss = torch.stack(losses).mean()
        with record_function("repro_torch.train.optimizer"), \
                torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, 1.0)
            updates, opt_state = optimizer.update(grads, opt_state, tree,
                                                  step_no)
            tree_map(lambda p, u: p.add_(u), tree, updates)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}
    return step


def _lm_cell(arch_id, mod, shape: LMShape, smoke: bool, batch: int | None,
             device) -> Cell:
    cfg = mod.smoke_config() if smoke else mod.make_config()
    b, s = (2, 64) if smoke else (shape.global_batch, shape.seq_len)
    b = batch or b

    def init(seed: int = 0):
        return transformer.init_params(cfg, seed=seed, device=device)

    if shape.mode == "train":
        optimizer = adafactor(lr=1e-3)

        def loss(params, batch):
            return transformer.loss_fn(params, batch["tokens"],
                                       batch["labels"], cfg)

        n_micro = 1 if smoke else _LM_MICROBATCHES.get(arch_id, 1)
        step = _make_train_step(loss, optimizer, n_micro=n_micro)

        def specs():
            return {"tokens": Spec((b, s), torch.int32),
                    "labels": Spec((b, s), torch.int32)}

        def init_opt(params):
            return optimizer.init(params.tree())

        return Cell(arch_id, shape.name, "lm", "train", cfg, init, init_opt,
                    step, specs)

    if shape.mode == "prefill":
        def step(params, batch):
            return transformer.prefill(params, batch["tokens"], cfg,
                                       max_len=s)

        def specs():
            return {"tokens": Spec((b, s), torch.int32)}

        return Cell(arch_id, shape.name, "lm", "prefill", cfg, init, None,
                    step, specs)

    # decode: one new token against a seq_len KV cache
    def step(params, batch):
        return transformer.decode_step(params, batch["token"], batch["cache"],
                                       batch["cache_len"], cfg)

    def specs():
        cache = transformer.init_cache(cfg, b, s, device="meta")
        return {"token": Spec((b, 1), torch.int32),
                "cache": {k: Spec(tuple(v.shape), v.dtype)
                          for k, v in cache.items()},
                "cache_len": Spec((), torch.int32)}

    return Cell(arch_id, shape.name, "lm", "decode", cfg, init, None, step,
                specs)


def build_cell(arch_id: str, shape_name: str, smoke: bool = False,
               batch: int | None = None, device="cuda") -> Cell:
    """The ``(arch_id, shape_name)`` cell on ``device`` (the GPU unless the
    caller asks for the CPU); ``batch`` cuts the shape's global batch."""
    mod = registry.get_module(arch_id)
    shape = registry.shapes_for(arch_id)[shape_name]
    return _lm_cell(arch_id, mod, shape, smoke, batch, device)
