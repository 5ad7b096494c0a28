"""Six train steps of tinyllama-1.1b at its published widths (d_model
2048, 32 q / 4 KV heads of 64, d_ff 5632, vocab 32000), cut to 2 layers,
through the port's ``_make_train_step`` and the reference's (jitted), on
the same weights and the same ``TokenPipeline`` batches (1 x 256 tokens):
the recipe of the training cell (adafactor 1e-3, clip 1.0, n_micro 1,
remat on), with its float32 or bfloat16 parameters and ``p + u``.

Tolerances: float32, each step's loss within 1e-4 and grad norm within
1e-4 of the reference's (measured: 2e-6 and 2e-6 relative).  bfloat16,
within 0.1 and 5 % (measured: 0.027 and 1.5 %): the two packages sum the
bf16 products in other orders, and the recipe amplifies a difference,
since without warmup the loss of the reference itself rises from step 0
and its grad norm reaches ~400 at step 4 on these batches.  ``pytest -s``
prints both trajectories.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tinyllama_1_1b as jtiny
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro.optim import adafactor as jadafactor
from repro_torch.configs import registry
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import steps
from repro_torch.models import transformer as tf
from repro_torch.optim import adafactor
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

TOL = {"float32": (1e-4, 1e-4), "bfloat16": (0.1, 5e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_six_steps_at_tinyllama_width_track_reference(dtype):
    layers, steps_n = 2, 6
    jcfg = dataclasses.replace(
        jtiny.make_config(dtype=getattr(jnp, dtype)), n_layers=layers)
    cfg = dataclasses.replace(registry.get_module(
        "tinyllama-1.1b").make_config(dtype=getattr(torch, dtype)),
        n_layers=layers)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tf.params_from_numpy(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), jp), cfg, device="cpu")
    jopt, opt = jadafactor(lr=1e-3), adafactor(lr=1e-3)
    jstep = jax.jit(jsteps._make_train_step(
        lambda p, b: jtf.loss_fn(p, b["tokens"], b["labels"], jcfg), jopt))
    step = steps._make_train_step(
        lambda p, b: tf.loss_fn(p, b["tokens"], b["labels"], cfg), opt)
    js, ts = jopt.init(jp), opt.init(tp.tree())
    got, want = [], []
    for i, b in zip(range(steps_n), TokenPipeline(1, 256, cfg.vocab,
                                                  seed=0)):
        jp, js, jm = jstep(jp, js, jnp.asarray(i),
                           {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = step(tp, ts, i, {k: torch.from_numpy(v)
                                       for k, v in b.items()})
        want.append((float(jm["loss"]), float(jm["grad_norm"])))
        got.append((float(tm["loss"]), float(tm["grad_norm"])))
    print(f"\n{dtype} (loss, grad norm) reference {want}\nport {got}")
    loss_tol, norm_rtol = TOL[dtype]
    for i, ((gl, gn), (wl, wn)) in enumerate(zip(got, want)):
        assert np.isfinite(gl) and abs(gl - wl) <= loss_tol, (i, gl, wl)
        assert abs(gn - wn) <= norm_rtol * wn, (i, gn, wn)
