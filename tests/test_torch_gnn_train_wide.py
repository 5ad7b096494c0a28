"""Three train steps of mace and equiformer-v2 at their published widths on
the molecule cell (128 graphs of 30 atoms and 64 edges, 4,096 / 8,192
padded; ``launch.train.gnn_batch``'s seeded batch), through the port's
cell step and the reference's (jitted), on the same weights: mace at its
full config (2 layers, d 128, l_max 2), equiformer-v2 cut to 2 blocks (d
128, l_max 6, m_max 2, 8 heads).  The recipe of the cell: adamw 1e-3,
weight decay 1e-5, clip 1.0, float32.

Tolerance: each step's loss and grad norm within 1e-5 relative of the
reference's (measured: 9.5e-7 and 1.1e-6).  The recipe itself is not
stable on one fixed batch: the reference's own loss rises after the first
update (mace 19.6 -> 2,665, grad norm 712 -> 20,278; equiformer-v2 14.3 ->
1,106), and the port follows it.  ``pytest -s`` prints both trajectories.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as jsteps
from repro.models.gnn.common import GraphBatch as JBatch
from repro.optim import adamw as jadamw
from repro_torch.launch import steps, train
from repro_torch.optim import adamw
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

RTOL, STEPS = 1e-5, 3


@pytest.mark.parametrize("arch,layers", [("mace", None),
                                         ("equiformer-v2", 2)])
def test_three_steps_at_full_width_track_reference(arch, layers):
    jcell = jsteps.build_cell(arch, "molecule")
    cell = steps.build_cell(arch, "molecule", device="cpu")
    jcfg, cfg = jcell.config, cell.config
    if layers:
        jcfg = dataclasses.replace(jcfg, n_layers=layers)
        cfg = dataclasses.replace(cfg, n_layers=layers)
    jmod, tmod = jsteps._GNN_MODELS[arch], steps._GNN_MODELS[arch]
    jopt = jadamw(lr=1e-3, weight_decay=1e-5)
    opt = adamw(lr=1e-3, weight_decay=1e-5)
    jstep = jax.jit(jsteps._make_train_step(
        lambda p, b: jmod.loss_fn(p, b, jcfg), jopt))
    step = steps._make_train_step(lambda p, b: tmod.loss_fn(p, b, cfg), opt)
    jp = jmod.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tmod.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                                device="cpu")
    host = train.gnn_batch(cell, seed=0)
    jb = JBatch(n_nodes=host.n_nodes, n_graphs=host.n_graphs,
                **{k: jnp.asarray(v) for k, v in host.fields().items()})
    tb = host.map(torch.from_numpy)
    js, ts = jopt.init(jp), opt.init(tp.tree())
    got, want = [], []
    for i in range(STEPS):
        jp, js, jm = jstep(jp, js, jnp.asarray(i), jb)
        tp, ts, tm = step(tp, ts, i, tb)
        want.append((float(jm["loss"]), float(jm["grad_norm"])))
        got.append((float(tm["loss"]), float(tm["grad_norm"])))
    print(f"\n{arch} (loss, grad norm) reference {want}\nport {got}")
    for i, ((gl, gn), (wl, wn)) in enumerate(zip(got, want)):
        assert np.isfinite(gl) and abs(gl - wl) <= RTOL * abs(wl), (i, gl, wl)
        assert abs(gn - wn) <= RTOL * wn, (i, gn, wn)
