"""Build helper for the port's hand-written CUDA kernels.

Each kernel library is one ``.cu`` source (it may include ``.cuh``
headers beside it) with plain C entry points,
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library and
loaded with :mod:`ctypes` — no PyTorch headers, so a build takes seconds.
Libraries are built at first use, all at once (one ``nvcc`` process per
source, started together), into ``build/repro_torch/`` at the repository
root, named by a hash of the sources and flags so an edited source
rebuilds and an unchanged one is reused.  A :class:`Library` may add
``nvcc`` flags and generated headers (the edge_relax kernels' generic
instance of one program: ``-DREPRO_GENERIC`` and the header emitgen.py
wrote under ``build/repro_torch/gen/``); both go into the hash.
Importing this module runs nothing; building without ``nvcc`` raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "Library", "build", "nvcc_path",
           "build_logs", "library_paths", "bind", "stream", "raise_on"]

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# <repo>/build/repro_torch (this file is <repo>/src/repro_torch/kernels/)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

_LOADED: dict[str, ctypes.CDLL] = {}


class Library(NamedTuple):
    """One shared library: its ``.cu`` sources, extra ``nvcc`` flags, and
    the generated headers those flags include (hashed by content)."""

    sources: tuple
    flags: tuple = ()
    headers: tuple = ()


def _lib(spec) -> Library:
    return spec if isinstance(spec, Library) else Library(tuple(spec))


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``CUDA_HOME`` (or
    the toolkit's default prefix)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of repro_torch are compiled at "
        "first use and need the CUDA toolkit (set CUDA_HOME)")


def _target(name: str, spec) -> Path:  # analysis: allow(host-loop): hashes a library's sources, at its first launch
    lib = _lib(spec)
    h = hashlib.sha256()
    for flag in (*NVCC_FLAGS, *lib.flags):
        h.update(flag.encode())
    # the sources, every header beside them (quoted includes) and the
    # generated headers
    headers = sorted({hdr for src in lib.sources
                      for hdr in Path(src).parent.glob("*.cuh")})
    for src in [*lib.sources, *headers, *lib.headers]:
        h.update(Path(src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(libs: dict) -> dict:  # analysis: allow(host-loop): builds libraries once per process, at the first launch
    """Build and load every library in ``libs`` (name -> list of ``.cu``
    sources, or a :class:`Library`) that is not loaded yet; returns name
    -> ``ctypes.CDLL``.

    Missing libraries compile in parallel; a failed compile raises with
    the compiler's output.  ``ptxas -v`` resource lines are kept beside
    each library as ``<lib>.log`` (see :func:`build_logs`).
    """
    pending = {}
    for name, spec in libs.items():
        if name in _LOADED:
            continue
        lib = _lib(spec)
        so = _target(name, lib)
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, *lib.flags, "-o", str(tmp),
                   *map(str, lib.sources)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            pending[name] = (proc, tmp, so)
        else:
            pending[name] = (None, None, so)
    errors = []
    for name, (proc, tmp, so) in pending.items():
        if proc is None:
            continue
        out, _ = proc.communicate()
        so.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} "
                          f"(exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    for name, (_, _, so) in pending.items():
        _LOADED[name] = ctypes.CDLL(str(so))
    return {name: _LOADED[name] for name in libs}


def build_logs(libs: dict) -> dict:
    """The compiler's ``ptxas -v`` output of each built library in
    ``libs`` ("" where the library was reused from an earlier build)."""
    out = {}
    for name, spec in libs.items():
        log = _target(name, spec).with_suffix(".log")
        out[name] = log.read_text() if log.exists() else ""
    return out


def library_paths(libs: dict) -> dict:
    """The shared library each of ``libs`` (name -> sources) builds to."""
    return {name: _target(name, spec) for name, spec in libs.items()}


def bind(sources: dict, symbols: dict, fns: dict) -> None:  # analysis: allow(host-loop): binds entry points once per process
    """Build (in parallel) every library of ``sources`` (name -> ``.cu``
    list) whose entry points are not bound yet, and bind them into
    ``fns``: ``symbols`` maps a library to ``{C entry point: argtypes}``;
    every entry point returns a ``cudaError_t`` as ``int``."""
    missing = {k: sources[k] for k in sources
               if not set(symbols[k]) <= set(fns)}
    for name, lib in build(missing).items():
        for sym, argtypes in symbols[name].items():
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[sym] = fn


def stream() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream, for a launch."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def raise_on(name: str, err: int) -> None:
    """Raise if a launch returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


class Launches(list):
    """The launches a kernel wrapper records while :func:`recording` is
    on: one ``(shape, arguments)`` a launch, ``arguments`` the first
    launch's ``(args, kwargs)`` when ``keep`` (references, no copy) and
    None otherwise."""

    def __init__(self, keep: bool):
        super().__init__()
        self.keep = keep

    def add(self, shape: tuple, args: tuple, kwargs: dict) -> None:
        self.append((shape, (args, kwargs) if self.keep and not self
                     else None))


@contextlib.contextmanager
def recording(module, keep: bool = True):
    """Record ``module``'s launches (its ``RECORDED``, a :class:`Launches`
    while inside): yields the list."""
    saved, module.RECORDED = module.RECORDED, Launches(keep)
    try:
        yield module.RECORDED
    finally:
        module.RECORDED = saved
