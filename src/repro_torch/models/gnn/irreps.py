"""Minimal SO(3)-irrep algebra for the equivariant GNNs (NequIP / MACE),
the counterpart of the JAX package's ``repro.models.gnn.irreps``.

The three primitives the tensor-product regime needs:

* hardcoded real spherical harmonics up to l_max = 3,
* numerically derived Wigner D matrices (solve Y(R r) = D Y(r) on
  generic points), and
* Clebsch-Gordan intertwiners computed as the null space of the
  equivariance constraint (D1 (x) D2) C = C D3 over random rotations.

The null-space construction is self-consistent with the SH convention
by definition and captures odd couplings like 1 (x) 1 -> 1 (the cross
product).  The tables are float64 numpy, built once and cached; this
module holds its own copy of the JAX package's numpy construction (the
port imports nothing of that package), with the same seeds, so the
tables are the same numbers.  ``sph_harm`` and ``bessel_basis`` are the
torch forms the models call (on DTensor edges too: their constants are
made replicated on the edges' mesh).
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from repro_torch.models.sharding import replicate_like


def sph_harm_np(l: int, v: np.ndarray) -> np.ndarray:
    """Real spherical harmonics of unit vectors ``v [..., 3]`` ->
    ``[..., 2l+1]``, m ordered -l..l, e3nn-style component scaling."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    if l == 0:
        return np.ones(v.shape[:-1] + (1,))
    if l == 1:
        return np.sqrt(3.0) * np.stack([y, z, x], axis=-1)
    if l == 2:
        return np.stack(
            [
                np.sqrt(15.0) * x * y,
                np.sqrt(15.0) * y * z,
                np.sqrt(5.0) / 2.0 * (3 * z**2 - 1),
                np.sqrt(15.0) * x * z,
                np.sqrt(15.0) / 2.0 * (x**2 - y**2),
            ],
            axis=-1,
        )
    if l == 3:
        return np.stack(
            [
                np.sqrt(35.0 / 8.0) * y * (3 * x**2 - y**2),
                np.sqrt(105.0) * x * y * z,
                np.sqrt(21.0 / 8.0) * y * (5 * z**2 - 1),
                np.sqrt(7.0) / 2.0 * z * (5 * z**2 - 3),
                np.sqrt(21.0 / 8.0) * x * (5 * z**2 - 1),
                np.sqrt(105.0) / 2.0 * z * (x**2 - y**2),
                np.sqrt(35.0 / 8.0) * x * (x**2 - 3 * y**2),
            ],
            axis=-1,
        )
    raise NotImplementedError(f"l={l}")


def _random_rotation(rng: np.random.Generator) -> np.ndarray:
    """Haar-ish random rotation via QR of a Gaussian matrix."""
    m = rng.standard_normal((3, 3))
    q, r = np.linalg.qr(m)
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def wigner_d_np(l: int, rot: np.ndarray) -> np.ndarray:
    """Real Wigner D for our SH convention: the (2l+1)x(2l+1) matrix with
    Y_l(R r) = D_l(R) Y_l(r), solved on generic sample points."""
    if l == 0:
        return np.ones((1, 1))
    rng = np.random.default_rng(12345 + l)
    n = 4 * (2 * l + 1)
    pts = rng.standard_normal((n, 3))
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    a = sph_harm_np(l, pts)                 # [n, 2l+1]
    b = sph_harm_np(l, pts @ rot.T)          # [n, 2l+1]
    # solve D a^T = b^T in least squares: D = (a \ b)^T
    d, *_ = np.linalg.lstsq(a, b, rcond=None)
    return d.T


@lru_cache(maxsize=None)
def real_cg(l1: int, l2: int, l3: int) -> np.ndarray | None:
    """Clebsch-Gordan intertwiner C with (D1 (x) D2) vec(C) = vec(C D3)
    for all rotations, i.e. equivariant bilinear map V_l1 x V_l2 -> V_l3.
    Returns ``[2l1+1, 2l2+1, 2l3+1]`` normalized to unit Frobenius norm,
    or None when the coupling is forbidden."""
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return None
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    rng = np.random.default_rng(777)
    rows = []
    for _ in range(6):
        rot = _random_rotation(rng)
        w1 = wigner_d_np(l1, rot)
        w2 = wigner_d_np(l2, rot)
        w3 = wigner_d_np(l3, rot)
        # constraint (for out[k] = sum_ij C[i,j,k] a_i b_j with a -> D1 a):
        #   sum_ij D1[i,i'] D2[j,j'] C[i,j,k] = sum_k' D3[k,k'] C[i',j',k']
        # flat over rows (i',j',k):
        #   (D1^T (x) D2^T (x) I - I (x) I (x) D3) vec(C) = 0
        m = np.kron(np.kron(w1.T, w2.T), np.eye(d3)) - np.kron(
            np.kron(np.eye(d1), np.eye(d2)), w3
        )
        rows.append(m)
    m = np.concatenate(rows, axis=0)
    _, s, vt = np.linalg.svd(m)
    null = vt[s < 1e-8 * s[0]] if len(s) else vt[-1:]
    if null.shape[0] == 0:
        # numerical fallback: smallest singular vector if it's tiny
        if s[-1] < 1e-6:
            null = vt[-1:]
        else:
            return None
    c = null[0].reshape(d1, d2, d3)
    c = c / np.linalg.norm(c)
    # canonical sign: first nonzero entry positive
    flat = c.reshape(-1)
    nz = flat[np.abs(flat) > 1e-9]
    if len(nz) and nz[0] < 0:
        c = -c
    return c


def allowed_paths(l_max: int) -> list[tuple[int, int, int]]:
    """All (l1, l2, l3) couplings with every l <= l_max."""
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(l_max + 1):
                if abs(l1 - l2) <= l3 <= l1 + l2:
                    if real_cg(l1, l2, l3) is not None:
                        out.append((l1, l2, l3))
    return out


def sph_harm(l: int, v: torch.Tensor) -> torch.Tensor:
    """Torch form of :func:`sph_harm_np` (differentiable).  The components
    stack on a non-negative dim: given ``-1``, torch 2.11's DTensor stack
    labelled a result cut over its rows ``Shard(1)`` (four ``gloo``
    ranks)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    last = x.dim()
    if l == 0:
        return torch.ones_like(v[..., :1])
    if l == 1:
        return math.sqrt(3.0) * torch.stack([y, z, x], dim=last)
    if l == 2:
        return torch.stack(
            [
                math.sqrt(15.0) * x * y,
                math.sqrt(15.0) * y * z,
                math.sqrt(5.0) / 2.0 * (3 * z**2 - 1),
                math.sqrt(15.0) * x * z,
                math.sqrt(15.0) / 2.0 * (x**2 - y**2),
            ],
            dim=last,
        )
    if l == 3:
        return torch.stack(
            [
                math.sqrt(35.0 / 8.0) * y * (3 * x**2 - y**2),
                math.sqrt(105.0) * x * y * z,
                math.sqrt(21.0 / 8.0) * y * (5 * z**2 - 1),
                math.sqrt(7.0) / 2.0 * z * (5 * z**2 - 3),
                math.sqrt(21.0 / 8.0) * x * (5 * z**2 - 1),
                math.sqrt(105.0) / 2.0 * z * (x**2 - y**2),
                math.sqrt(35.0 / 8.0) * x * (x**2 - 3 * y**2),
            ],
            dim=last,
        )
    raise NotImplementedError(f"l={l}")


def bessel_basis(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """NequIP's Bessel radial basis with a smooth polynomial cutoff
    envelope (p = 6, from DimeNet).  r: [...]; returns [..., n_rbf]."""
    r = r.clamp(min=1e-6)
    n = replicate_like(torch.arange(1, n_rbf + 1, dtype=torch.float32,
                                    device=r.device), r)
    basis = math.sqrt(2.0 / cutoff) * torch.sin(
        n * math.pi * r[..., None] / cutoff) / r[..., None]
    x = (r / cutoff).clamp(0.0, 1.0)
    p = 6.0
    env = (
        1.0
        - (p + 1.0) * (p + 2.0) / 2.0 * x**p
        + p * (p + 2.0) * x ** (p + 1.0)
        - p * (p + 1.0) / 2.0 * x ** (p + 2.0)
    )
    return basis * env[..., None]
