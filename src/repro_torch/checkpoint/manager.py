"""Asynchronous snapshots of flat dicts of tensors and arrays (the port of
``repro.checkpoint.manager``, with the same on-disk layout).

* **Layout**: step ``n`` lives in ``step_<n>/``: one ``.npy`` a leaf, named
  by its path with ``/`` turned into ``__``, and a ``manifest.json`` with the
  step, each leaf's file, shape, dtype and blake2b-16 digest.  Writes go to
  ``.tmp_step_<n>/`` and are published by an atomic rename, so a death
  mid-save never damages the latest snapshot.
* **Async**: the device-to-host copy (``.detach().cpu().numpy()``) runs on
  the caller thread; the file writes on a background thread.  A writer
  failure is raised on the caller thread at the next ``wait()``/``save()``.
* **Fallback restore**: with ``step=None`` a damaged latest snapshot
  (unparsable manifest, missing leaf file, digest mismatch) is skipped and
  the previous retained one is tried, newest first; an explicit ``step=``
  never falls back, and when no retained step loads the last error
  propagates.
* **Retention**: the last ``keep`` snapshots stay, older ones are pruned.

A leaf whose dtype numpy lacks (bfloat16, the float8 types) is refused by
name.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import warnings

import numpy as np
import torch

from ..core import chaos

__all__ = ["CheckpointManager"]


def _to_host(name: str, leaf) -> np.ndarray:
    """A host copy of one leaf that later in-place writes cannot reach."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
    t = leaf.detach()
    t = t.clone() if t.device.type == "cpu" else t.cpu()
    try:
        return t.numpy()
    except TypeError as e:
        raise TypeError(f"snapshot leaf {name!r}: numpy has no {t.dtype} "
                        f"({e})") from None


def _digest(arr: np.ndarray) -> str:
    return hashlib.blake2b(arr.tobytes(), digest_size=16).hexdigest()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: threading.Thread | None = None
        self._write_error: BaseException | None = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: dict, wait: bool = False):
        """Snapshot the flat dict ``tree`` (leaf path -> tensor or array)
        at ``step``; returns once the host copies are taken (the files are
        written in the background)."""
        self.wait()
        host = {name: _to_host(name, leaf) for name, leaf in tree.items()}

        def _write():
            try:
                tmp = os.path.join(self.directory, f".tmp_step_{step}")
                final = os.path.join(self.directory, f"step_{step}")
                os.makedirs(tmp, exist_ok=True)
                manifest = {"step": step, "leaves": {}}
                for name, arr in host.items():
                    fname = name.replace("/", "__") + ".npy"
                    np.save(os.path.join(tmp, fname), arr)
                    chaos.point("checkpoint.leaf-written")
                    manifest["leaves"][name] = {
                        "file": fname,
                        "shape": list(arr.shape),
                        "dtype": str(arr.dtype),
                        "digest": _digest(arr),
                    }
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                chaos.point("checkpoint.pre-rename")
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._prune()
            except BaseException as e:   # surfaced on the caller thread
                self._write_error = e

        self._pending = threading.Thread(target=_write, daemon=True)
        self._pending.start()
        if wait:
            self.wait()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            raise err

    def _prune(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                if os.path.exists(
                    os.path.join(self.directory, name, "manifest.json")
                ):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- loading -------------------------------------------------------

    def _load_step(self, step: int, verify: bool) -> dict[str, np.ndarray]:
        """Read + digest-check every leaf of one step; raises on any damage
        (unparsable manifest, missing file, digest mismatch)."""
        d = os.path.join(self.directory, f"step_{step}")
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise IOError(f"checkpoint step {step}: bad manifest ({e})")
        arrays: dict[str, np.ndarray] = {}
        for name, meta in manifest["leaves"].items():
            try:
                arr = np.load(os.path.join(d, meta["file"]))
            except (OSError, ValueError) as e:
                raise IOError(
                    f"checkpoint step {step}: leaf {name} unreadable ({e})")
            if verify and _digest(arr) != meta["digest"]:
                raise IOError(
                    f"checkpoint step {step}: leaf {name} is corrupt")
            arrays[name] = arr
        return arrays

    def _load_with_fallback(self, step: int | None, verify: bool):
        """-> (arrays, step). step=None walks retained steps newest-first."""
        if step is not None:
            return self._load_step(step, verify), step
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        last_err: Exception | None = None
        for s in reversed(steps):
            try:
                return self._load_step(s, verify), s
            except (IOError, KeyError) as e:
                warnings.warn(
                    f"checkpoint step {s} is damaged ({e}); falling back "
                    f"to the previous retained step")
                last_err = e if isinstance(e, Exception) else IOError(str(e))
        raise last_err

    def restore_flat(self, step: int | None = None, verify: bool = True):
        """Load a snapshot as a flat {path: np.ndarray} dict.  Returns
        ``(arrays, step)``; ``step=None`` falls back past damaged steps,
        newest first."""
        self.wait()
        return self._load_with_fallback(step, verify)

    def restore(self, step: int | None = None, device="cuda",
                verify: bool = True):
        """Load a snapshot as a flat {path: tensor} dict on ``device`` (the
        GPU unless the caller asks for the CPU).  Returns ``(tensors,
        step)``, with :meth:`restore_flat`'s fallback."""
        arrays, step = self.restore_flat(step, verify)
        return {name: torch.from_numpy(arr).to(device)
                for name, arr in arrays.items()}, step
