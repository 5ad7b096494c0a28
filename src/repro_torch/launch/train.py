"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

The port of ``repro/launch/train.py``: a cell (config x shape), the data
pipeline and the fault-tolerant trainer wired together.  ``--smoke
--device cpu`` runs the smoke config on the CPU; on one H100 the full
config of tinyllama-1.1b trains with the global batch cut to fit:

    python -m repro_torch.launch.train --arch tinyllama-1.1b --batch 8

The LM family reads the ``TokenPipeline`` synthetic stream (no corpus is
in the repository) through a ``Prefetcher``, and each batch moves to the
device on the caller thread.  GNN and recsys training are ROADMAP queue 1
item 12 (``registry.get_module`` raises ``NotImplementedError``).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from ..configs import registry
from ..data.pipeline import Prefetcher, TokenPipeline
from ..runtime.trainer import train_loop
from .steps import build_cell


def data_for(cell):
    """The cell's batch stream on the host (numpy)."""
    if cell.family != "lm":
        raise NotImplementedError(
            f"{cell.family} training data is ROADMAP queue 1 item 12")
    b, s = cell.input_specs()["tokens"].shape
    return TokenPipeline(b, s, cell.config.vocab)


def on_device(batches, device):
    """Each host batch as tensors on ``device``."""
    for batch in batches:
        yield {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None,
                    help="a training shape (default: the arch's first)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--batch", type=int, default=None,
                    help="cut the shape's global batch (train_4k: 256)")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log", default=None)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    shapes = registry.shapes_for(args.arch)
    shape = args.shape or next(s for s in shapes
                               if shapes[s].mode == "train")
    cell = build_cell(args.arch, shape, smoke=args.smoke, batch=args.batch,
                      device=args.device)
    if cell.mode != "train":
        raise SystemExit(f"shape {shape} is not a training shape")

    params = cell.init_params(0)
    opt_state = cell.init_opt(params)
    data = on_device(Prefetcher(data_for(cell)), args.device)

    def on_metrics(step, metrics, dt):
        print(f"step {step}: loss={float(metrics['loss']):.4f} "
              f"gnorm={float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms",
              flush=True)

    return train_loop(
        cell.step, params, opt_state, data, args.steps,
        ckpt_dir=os.path.join(args.ckpt_dir, args.arch),
        ckpt_every=args.ckpt_every, log_path=args.log,
        on_metrics=on_metrics,
    )


if __name__ == "__main__":
    main()
