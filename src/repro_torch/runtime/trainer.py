"""The production training loop (the port of ``repro/runtime/trainer.py``):
checkpoint/restart, preemption, stragglers.

The loop is deliberately boring — all the machinery lives in the components
it composes (CheckpointManager, PreemptionGuard, StragglerMonitor), so each
is testable in isolation.  It snapshots ``(params, opt_state)`` under the
reference's leaf names (an LM's layers stacked on a leading L axis:
``0/layers/attn/wq``, ``1/layers/attn/wq/vr``), so a directory either
package writes in float32 resumes in the other.  As in the reference, a
resume does not fast-forward ``data_iter``: the resumed steps read the
iterator from where the caller hands it over.
"""

from __future__ import annotations

import json
import time

from ..checkpoint.manager import CheckpointManager
from .fault_tolerance import PreemptionGuard, StragglerMonitor

__all__ = ["train_loop"]


def train_loop(
    step_fn,                 # (params, opt_state, step_no, batch) -> ...
    params,
    opt_state,
    data_iter,
    n_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 100,
    log_path: str | None = None,
    guard: PreemptionGuard | None = None,
    resume: bool = True,
    on_metrics=None,
):
    """Run (or resume) training; returns (params, opt_state, last_step).

    A snapshot is saved every ``ckpt_every`` steps and after the last;
    ``ckpt_every=0`` saves none (but on preemption).  A step's seconds end
    when its loss has reached the host, which waits for the whole step
    (the device runs it in issue order)."""
    ckpt = CheckpointManager(ckpt_dir)
    own_guard = guard is None
    guard = guard or PreemptionGuard()
    guard.install()
    straggler = StragglerMonitor()

    start = 0
    if resume and ckpt.latest_step() is not None:
        (params, opt_state), start = ckpt.restore((params, opt_state))
        start += 1

    logf = open(log_path, "a") if log_path else None
    step = start - 1
    try:
        for step in range(start, n_steps):
            batch = next(data_iter)
            t0 = time.time()
            params, opt_state, metrics = step_fn(params, opt_state, step,
                                                 batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            straggler.record(step, dt)
            if on_metrics is not None:
                on_metrics(step, metrics, dt)
            if logf:
                logf.write(json.dumps({
                    "step": step,
                    "loss": loss,
                    "grad_norm": float(metrics.get("grad_norm", 0.0)),
                    "seconds": dt,
                }) + "\n")
                logf.flush()
            if ckpt_every and ((step + 1) % ckpt_every == 0
                               or step == n_steps - 1):
                ckpt.save(step, (params, opt_state))
            if guard.should_stop:
                ckpt.save(step, (params, opt_state), wait=True)
                break
        ckpt.wait()
    finally:
        if logf:
            logf.close()
        if own_guard:
            guard.uninstall()
    return params, opt_state, step
