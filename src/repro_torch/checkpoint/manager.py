"""Asynchronous snapshots of trees of tensors and arrays (the port of
``repro.checkpoint.manager``, with the same on-disk layout).

* **Trees**: nested dicts, tuples and lists of tensors or arrays, flattened
  under the reference's leaf names (``_path_str``: keys and indices joined
  by ``/``, dict keys sorted as JAX flattens), so a flat dict keeps its
  names.  A ``torch.nn.Module`` is a node whose children are its
  parameters and submodules by attribute name, an ``nn.ModuleList`` a
  list (the LM's ``Transformer`` and a GNN's ``Params`` flatten as the
  reference's params trees), restored in place.  A
  ``train_loop`` directory either package writes in float32 resumes in the
  other.
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

* **Sharded trees**: a DTensor leaf is saved as its global tensor
  (``full_tensor``, a collective: every rank of its mesh calls ``save``),
  and only global rank 0 writes a tree that holds one;
  ``restore(..., shardings=)`` places each leaf on a new mesh
  (``dist.sharding.distribute``), the elastic rescale's path.

bfloat16 leaves are written as the reference writes them, byte for byte:
the raw 2-byte bits in a ``.npy`` whose header names ``<V2`` (numpy reads
it back as ``|V2``), manifest dtype ``"bfloat16"``, the digest of those
bytes; they load back as ``torch.bfloat16``.  A leaf of another
dtype numpy lacks (the float8 types) is refused by name.
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
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..core import chaos
from ..dist.sharding import distribute

__all__ = ["CheckpointManager", "flatten"]

_BF16_BITS = np.dtype("V2")      # how numpy stores a bfloat16 leaf


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _items(node):
    """The children of a tree node as (key, child), or None for a leaf."""
    if isinstance(node, torch.nn.ModuleList):     # a list, in its order
        return list(enumerate(node))
    if isinstance(node, torch.nn.Module):
        node = {**dict(node.named_parameters(recurse=False)),
                **dict(node.named_children())}
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return list(enumerate(node))
    return None


def flatten(tree, prefix: tuple = ()) -> dict:
    """{leaf name: leaf} of a tree, in the reference's flatten order."""
    items = _items(tree)
    if items is None:
        return {_path_str(prefix): tree}
    out = {}
    for key, child in items:
        out.update(flatten(child, prefix + (key,)))
    return out


def _to_host(name: str, leaf) -> tuple[np.ndarray, str]:
    """(a host copy of one leaf that later in-place writes cannot reach,
    the manifest's dtype name)."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.array(leaf)
        return arr, str(arr.dtype)
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        arr = t.view(torch.int16).cpu().numpy().copy().view(_BF16_BITS)
        return arr, "bfloat16"
    t = t.clone() if t.device.type == "cpu" else t.cpu()
    try:
        arr = t.numpy()
    except TypeError as e:
        raise TypeError(f"snapshot leaf {name!r}: numpy has no {t.dtype} "
                        f"({e})") from None
    return arr, str(arr.dtype)


def _save_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    """``np.save``, except that a bfloat16 leaf's header names ``<V2``, as
    numpy writes the reference's (ml_dtypes') bfloat16: the same bytes."""
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    header = np.lib.format.header_data_from_array_1_0(arr)
    header["descr"] = "<V2"
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        f.write(np.ascontiguousarray(arr).tobytes())


def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    if arr.dtype == _BF16_BITS:
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


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
    def save(self, step: int, tree, wait: bool = False):
        """Snapshot ``tree`` (see :func:`flatten`) at ``step``; returns
        once the host copies are taken (the files are written in the
        background)."""
        self.wait()
        leaves = flatten(tree)
        host = {name: _to_host(name, leaf) for name, leaf in leaves.items()}
        if dist.is_initialized() and dist.get_rank() != 0 and any(
                isinstance(leaf, DTensor) for leaf in leaves.values()):
            return          # rank 0 writes the gathered tree

        def _write():
            try:
                tmp = os.path.join(self.directory, f".tmp_step_{step}")
                final = os.path.join(self.directory, f"step_{step}")
                os.makedirs(tmp, exist_ok=True)
                manifest = {"step": step, "leaves": {}}
                for name, (arr, dtype) in host.items():
                    fname = name.replace("/", "__") + ".npy"
                    _save_leaf(os.path.join(tmp, fname), arr, dtype)
                    chaos.point("checkpoint.leaf-written")
                    manifest["leaves"][name] = {
                        "file": fname,
                        "shape": list(arr.shape),
                        "dtype": dtype,
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
            if (arr.dtype == _BF16_BITS) != (meta["dtype"] == "bfloat16"):
                raise IOError(f"checkpoint step {step}: leaf {name} holds "
                              f"{arr.dtype} for {meta['dtype']}")
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
        """Load a snapshot as a flat {path: np.ndarray} dict (a bfloat16
        leaf as its ``|V2`` bits).  Returns ``(arrays, step)``;
        ``step=None`` falls back past damaged steps, newest first."""
        self.wait()
        return self._load_with_fallback(step, verify)

    def restore(self, target=None, step: int | None = None, device="cuda",
                verify: bool = True, shardings=None):
        """Load a snapshot, with :meth:`restore_flat`'s fallback.  Returns
        ``(tree, step)``.

        Without ``target``: a flat {path: tensor} dict on ``device`` (the
        GPU unless the caller asks for the CPU).  With ``target``, as the
        reference's ``restore(target_tree)``: its structure, each leaf read
        by its name onto the device of the target's leaf (a tensor; an
        array stays on the host); a module is loaded in place and
        returned.  A missing name raises ``KeyError``,
        another shape ``ValueError``.

        ``shardings``: a tree matching ``target``'s leaves of
        ``dist.rules.NamedSharding`` (the new mesh's layout) for a tree of
        tensors: each leaf is read onto the mesh's device type and each
        rank of the mesh keeps its block (``dist.sharding.distribute``)."""
        arrays, step = self.restore_flat(step, verify)
        if target is None:
            return {name: _to_tensor(arr, device)
                    for name, arr in arrays.items()}, step
        if shardings is not None:
            return _place(target, shardings, arrays, ()), step
        return _fill(target, arrays, ()), step


def _place(node, shardings, arrays: dict, prefix: tuple):
    """``node``'s structure with each leaf read from ``arrays`` by name
    and distributed by the matching sharding of ``shardings``."""
    if isinstance(node, torch.nn.Module):
        raise TypeError("restore(..., shardings=) fills a tree of tensors "
                        "(a module's tree()), not a module")
    items = _items(node)
    if items is None:
        name = _path_str(prefix)
        arr = arrays[name]
        if tuple(arr.shape) != tuple(node.shape):
            raise ValueError(f"checkpoint leaf {name}: shape "
                             f"{tuple(arr.shape)} for {tuple(node.shape)}")
        sh = shardings
        return distribute(_to_tensor(arr, sh.mesh.device_type), sh.mesh,
                          sh.placements)
    if isinstance(node, dict):
        return {k: _place(c, shardings[k], arrays, prefix + (k,))
                for k, c in items}
    return type(node)(_place(c, shardings[k], arrays, prefix + (k,))
                      for k, c in items)


def _fill(node, arrays: dict, prefix: tuple):
    """``node``'s structure with each leaf read from ``arrays`` by name."""
    items = _items(node)
    if isinstance(node, torch.nn.Module):
        with torch.no_grad():
            for key, child in items:
                got = _fill(child, arrays, prefix + (key,))
                if isinstance(child, torch.Tensor):
                    child.copy_(got)
        return node
    if items is None:
        name = _path_str(prefix)
        arr = arrays[name]
        if tuple(arr.shape) != tuple(node.shape):
            raise ValueError(f"checkpoint leaf {name}: shape "
                             f"{tuple(arr.shape)} for {tuple(node.shape)}")
        if isinstance(node, torch.Tensor):
            return _to_tensor(arr, node.device)
        return arr
    filled = [(k, _fill(c, arrays, prefix + (k,))) for k, c in items]
    if isinstance(node, dict):
        return dict(filled)
    return type(node)(c for _, c in filled)
