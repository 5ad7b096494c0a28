"""Equivariant building blocks: real spherical harmonics, Wigner rotations,
and Clebsch-Gordan couplings — all derived *numerically* from the harmonics
themselves, so every tensor is convention-consistent by construction (the
port of ``repro/models/gnn/equivariant.py``).

Key pieces:

* :func:`sph_harm` — real spherical harmonics up to l_max (torch,
  recurrence); :func:`sph_harm_np` the same recurrence in float64 numpy.
* :func:`wigner_blocks` — per-edge Wigner-D block matrices for the rotation
  aligning each edge with +z, via the Euler/J-matrix factorization
  ``D(Q) = K · Xz(−θ) · Kᵀ · Xz(−φ)`` where ``K = D(Rx(−π/2))`` is a fixed
  numerical constant per l (the e3nn trick, rederived by least squares).
  The only per-edge dense math is block-diagonal (2l+1)-sized matmuls,
  which is what makes eSCN's O(L³) SO(2) convolution possible.
* :func:`cg_coupling` — real CG intertwiner for (l1 ⊗ l2 → l3), computed by
  projecting onto the rotation-fixed subspace of D3ᵀ·(D1 ⊗ D2) averaged over
  random rotations (unique up to scale; learnable path weights absorb it).
* Radial bases: Bessel + polynomial cutoff (MACE/NequIP standard).

The constants (``wigner_K``, ``_xz_masks``, ``cg_coupling``) are the
reference's float64 numpy computations, operation for operation, from the
same seeds: the same bits on one machine.  They reach the models as
float32 tensors, cast where the reference casts them.
"""

from __future__ import annotations

import functools
import math
from types import SimpleNamespace

import numpy as np
import torch

__all__ = [
    "n_sph", "sph_harm", "sph_harm_np", "wigner_K", "wigner_blocks",
    "rotate_irreps", "cg_coupling", "bessel_basis", "poly_cutoff",
    "irrep_slices",
]


def n_sph(l_max: int) -> int:
    return (l_max + 1) ** 2


def irrep_slices(l_max: int):
    return [slice(l * l, (l + 1) * (l + 1)) for l in range(l_max + 1)]


# ---------------------------------------------------------------------------
# Real spherical harmonics (orthonormal), index layout m = -l..l at l^2+l+m
# ---------------------------------------------------------------------------

# the array operations _sph_impl needs, for numpy and for torch
_NP = SimpleNamespace(sqrt=np.sqrt, maximum=np.maximum,
                      ones_like=np.ones_like, zeros_like=np.zeros_like,
                      stack=lambda xs, axis: np.stack(xs, axis=axis))
_TORCH = SimpleNamespace(sqrt=torch.sqrt,
                         maximum=lambda x, c: torch.clamp(x, min=c),
                         ones_like=torch.ones_like,
                         zeros_like=torch.zeros_like,
                         stack=lambda xs, axis: torch.stack(xs, dim=axis))


def _sph_impl(l_max: int, xyz, xp):
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r = xp.sqrt(xp.maximum(x * x + y * y + z * z, 1e-20))
    x, y, z = x / r, y / r, z / r
    rxy = xp.sqrt(xp.maximum(x * x + y * y, 1e-20))
    # cos(m phi), sin(m phi) by recurrence (phase from x, y)
    cphi = x / xp.maximum(rxy, 1e-20)
    sphi = y / xp.maximum(rxy, 1e-20)
    cos_m = [xp.ones_like(x), cphi]
    sin_m = [xp.zeros_like(x), sphi]
    for m in range(2, l_max + 1):
        c_prev, s_prev = cos_m[-1], sin_m[-1]
        cos_m.append(cphi * c_prev - sphi * s_prev)
        sin_m.append(sphi * c_prev + cphi * s_prev)
    # associated Legendre P_l^m(z) with sin^m factor folded in via rxy^m
    P = {}
    P[(0, 0)] = xp.ones_like(z)
    for m in range(1, l_max + 1):
        P[(m, m)] = -(2 * m - 1) * rxy * P[(m - 1, m - 1)]
    for m in range(0, l_max):
        P[(m + 1, m)] = (2 * m + 1) * z * P[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = ((2 * l - 1) * z * P[(l - 1, m)]
                         - (l + m - 1) * P[(l - 2, m)]) / (l - m)
    out = []
    for l in range(l_max + 1):
        row = [None] * (2 * l + 1)
        for m in range(0, l + 1):
            nrm = math.sqrt(
                (2 * l + 1) / (4 * math.pi)
                * math.factorial(l - m) / math.factorial(l + m)
            )
            if m == 0:
                row[l] = nrm * P[(l, 0)]
            else:
                row[l + m] = math.sqrt(2.0) * nrm * P[(l, m)] * cos_m[m]
                row[l - m] = math.sqrt(2.0) * nrm * P[(l, m)] * sin_m[m]
        out.extend(row)
    return xp.stack(out, axis=-1)


def sph_harm(l_max: int, xyz: torch.Tensor) -> torch.Tensor:
    """Real SH of unit(ized) vectors. xyz [..., 3] -> [..., (l_max+1)^2]."""
    return _sph_impl(l_max, xyz, _TORCH)


def sph_harm_np(l_max: int, xyz: np.ndarray) -> np.ndarray:
    return _sph_impl(l_max, np.asarray(xyz, np.float64), _NP)


# ---------------------------------------------------------------------------
# Wigner-D machinery (numerical, convention-free)
# ---------------------------------------------------------------------------

def _rot_x(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _d_of_rotation_np(l: int, R: np.ndarray) -> np.ndarray:
    """D_l(R) with Y(Rv) = D Y(v), by least squares over sampled vectors."""
    rng = np.random.default_rng(12345 + l)
    v = rng.normal(size=(8 * (2 * l + 1), 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    Y = sph_harm_np(l, v)[:, l * l:(l + 1) * (l + 1)].T       # [2l+1, n]
    YR = sph_harm_np(l, v @ R.T)[:, l * l:(l + 1) * (l + 1)].T
    D, *_ = np.linalg.lstsq(Y.T, YR.T, rcond=None)
    return D.T                                                 # [2l+1, 2l+1]


@functools.lru_cache(maxsize=64)
def wigner_K(l: int) -> np.ndarray:
    """K_l = D_l(Rx(-pi/2)); D(Ry(b)) = K Xz(b) K^T."""
    return _d_of_rotation_np(l, _rot_x(-math.pi / 2))


@functools.lru_cache(maxsize=64)
def _xz_masks(l: int):
    """Constant masks s.t. Xz(g) = I0 + sum_m cos(mg) Cm + sin(mg) Sm."""
    n = 2 * l + 1
    I0 = np.zeros((n, n))
    I0[l, l] = 1.0
    Cs, Ss = [], []
    for m in range(1, l + 1):
        C = np.zeros((n, n))
        S = np.zeros((n, n))
        C[l + m, l + m] = 1.0
        C[l - m, l - m] = 1.0
        S[l + m, l - m] = -1.0
        S[l - m, l + m] = 1.0
        Cs.append(C)
        Ss.append(S)
    if not Cs:
        return I0, np.zeros((0, n, n)), np.zeros((0, n, n))
    return I0, np.stack(Cs), np.stack(Ss)


def _xz(l: int, gamma: torch.Tensor) -> torch.Tensor:
    """D_l(Rz(gamma)) for batched angles gamma [...]: [..., 2l+1, 2l+1]."""
    I0, Cm, Sm = constant("xz", (l,), torch.float32, gamma.device)
    ms = torch.arange(1, l + 1, dtype=torch.float32, device=gamma.device)
    cos = torch.cos(gamma[..., None] * ms)      # [..., l]
    sin = torch.sin(gamma[..., None] * ms)
    out = I0
    out = out + torch.einsum("...m,mij->...ij", cos, Cm)
    out = out + torch.einsum("...m,mij->...ij", sin, Sm)
    return out


def wigner_blocks(l_max: int, directions: torch.Tensor):
    """Per-edge D_l(Q) with Q·dir = +z, for l = 0..l_max.

    directions [E, 3] (need not be normalized).
    Returns list of [E, 2l+1, 2l+1] tensors (float32).
    """
    d = directions / torch.clamp(
        torch.linalg.norm(directions, dim=-1, keepdim=True), min=1e-12)
    theta = torch.arccos(torch.clamp(d[..., 2], -1.0, 1.0))
    phi = torch.arctan2(d[..., 1], d[..., 0])
    blocks = []
    for l in range(l_max + 1):
        if l == 0:
            blocks.append(torch.ones(d.shape[:-1] + (1, 1),
                                     dtype=torch.float32, device=d.device))
            continue
        K = constant("K", (l,), torch.float32, d.device)
        Dy = K @ _xz(l, -theta) @ K.T          # [E, n, n]
        blocks.append(torch.einsum("...ij,...jk->...ik", Dy, _xz(l, -phi)))
    return blocks


def rotate_irreps(feats: torch.Tensor, blocks, l_max: int,
                  inverse: bool = False) -> torch.Tensor:
    """feats [E, (L+1)^2, C]; apply block-diag D (or D^T), in the common
    dtype of D and feats (float32 for bfloat16 features, as in JAX)."""
    outs = []
    eq = "...ji,...jc->...ic" if inverse else "...ij,...jc->...ic"
    for l, sl in enumerate(irrep_slices(l_max)):
        D = blocks[l]
        dt = torch.promote_types(D.dtype, feats.dtype)
        outs.append(torch.einsum(eq, D.to(dt), feats[..., sl, :].to(dt)))
    return torch.cat(outs, dim=-2)


# ---------------------------------------------------------------------------
# Real Clebsch-Gordan couplings by invariant-subspace projection
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def cg_coupling(l1: int, l2: int, l3: int) -> np.ndarray | None:
    """Real coupling C [2l3+1, 2l1+1, 2l2+1] with
    D3(R) C = C (D1(R) ⊗ D2(R)) for all R; None if not triangle-valid."""
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return None
    n1, n2, n3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    dim = n3 * n1 * n2
    rng = np.random.default_rng(999 + 17 * l1 + 31 * l2 + 53 * l3)
    # Invariant-tensor condition for orthogonal reps: for all R,
    #   sum_ijk D3[ai] D1[bj] D2[ck] C[ijk] = C[abc].
    # Stack (M(R_k) - I) and take the (1-dim) null space.
    rows = []
    for _ in range(8):
        A = rng.normal(size=(3, 3))
        Q, _ = np.linalg.qr(A)
        if np.linalg.det(Q) < 0:
            Q[:, 0] *= -1
        D1 = _d_of_rotation_np(l1, Q)
        D2 = _d_of_rotation_np(l2, Q)
        D3 = _d_of_rotation_np(l3, Q)
        M = np.einsum("ai,bj,ck->abcijk", D3, D1, D2).reshape(dim, dim)
        rows.append(M - np.eye(dim))
    A = np.vstack(rows)
    _, s, vt = np.linalg.svd(A, full_matrices=False)
    if s[-1] > 1e-6:
        return None
    c = vt[-1].reshape(n3, n1, n2)
    return c / np.linalg.norm(c)


_CONSTANTS = {"K": wigner_K, "xz": _xz_masks, "cg": cg_coupling}


@functools.lru_cache(maxsize=512)
def constant(kind: str, key: tuple, dtype: torch.dtype, device):
    """A float64 constant of this module (``"K"``: ``wigner_K(*key)``,
    ``"xz"``: the three ``_xz_masks(*key)``, ``"cg"``: ``cg_coupling(*key)``)
    as ``dtype`` tensors on ``device``, copied there once."""
    val = _CONSTANTS[kind](*key)
    if isinstance(val, tuple):
        return tuple(torch.from_numpy(v).to(device=device, dtype=dtype)
                     for v in val)
    return torch.from_numpy(val).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Radial bases
# ---------------------------------------------------------------------------

def bessel_basis(r: torch.Tensor, n_rbf: int, r_cut: float) -> torch.Tensor:
    """e_n(r) = sqrt(2/c) sin(n pi r / c) / r   (DimeNet/MACE standard)."""
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    rs = torch.clamp(r[..., None], min=1e-9)
    return math.sqrt(2.0 / r_cut) * torch.sin(n * math.pi * rs / r_cut) / rs


def poly_cutoff(r: torch.Tensor, r_cut: float, p: int = 6) -> torch.Tensor:
    """Smooth polynomial cutoff (NequIP)."""
    x = torch.clamp(r / r_cut, 0.0, 1.0)
    return (
        1.0
        - (p + 1) * (p + 2) / 2 * x ** p
        + p * (p + 2) * x ** (p + 1)
        - p * (p + 1) / 2 * x ** (p + 2)
    )
