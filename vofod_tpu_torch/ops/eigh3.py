"""Closed-form symmetric 3x3 eigendecomposition (batched, branch-free).

PyTorch counterpart of vofod_tpu/ops/eigh3.py, kept as the closed form
(Smith's trigonometric eigenvalues, eigenvectors from cross products of
(A - λI) rows): ``torch.linalg.eigh`` would pick other eigenvectors for the
degenerate 3-7-voxel clusters, whose OBB centres are then ambiguous
(DESIGN.md §9).  The determinant is JAX's explicit 3x3 formula, term for
term, and no step here synchronises with the host.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def _det3(a: Tensor) -> Tensor:
    """jax.numpy.linalg.det's 3x3 closed form, same term order."""
    return (
        a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2]
        + a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0]
        + a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1]
        - a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0]
        - a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1]
        - a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2]
    )


def cross(a: Tensor, b: Tensor) -> Tensor:
    """jnp.cross over the last axis, same component formulas."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def eigh3(A: Tensor) -> tuple[Tensor, Tensor]:
    """Eigen-decomposition of symmetric [..., 3, 3] matrices.

    Returns (evals [..., 3] ascending, evecs [..., 3, 3] with COLUMNS as the
    corresponding unit eigenvectors)."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    A = (A + A.transpose(-1, -2)) * 0.5
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2])[..., None, None] / 3.0
    B = A - q * eye
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    detB = _det3(B)
    r = detB / (2.0 * p**3 + 1e-30)
    r = torch.clamp(r, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    q0 = q[..., 0, 0]
    e1 = q0 + 2.0 * p * torch.cos(phi)  # largest
    e3 = q0 + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    e2 = 3.0 * q0 - e1 - e3
    evals = torch.stack([e3, e2, e1], dim=-1)  # ascending

    scale = torch.clamp(torch.abs(evals[..., 2]), min=1e-20)

    def eigvec(lam):
        M = A - lam[..., None, None] * eye
        r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
        c01, c02, c12 = cross(r0, r1), cross(r0, r2), cross(r1, r2)
        n01 = torch.sum(c01 * c01, dim=-1)
        n02 = torch.sum(c02 * c02, dim=-1)
        n12 = torch.sum(c12 * c12, dim=-1)
        best = torch.argmax(torch.stack([n01, n02, n12], dim=-1), dim=-1)
        cand = torch.stack([c01, c02, c12], dim=-2)  # [..., 3, 3]
        v = torch.gather(cand, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
        n2 = torch.sum(v * v, dim=-1, keepdim=True)
        ok = n2[..., 0] > (1e-12 * scale * scale) ** 2
        v = v / torch.sqrt(torch.clamp(n2, min=1e-30))
        return v, ok

    ex = torch.zeros_like(evals)
    ex[..., 0] = 1.0
    v3, ok3 = eigvec(evals[..., 0])
    v3 = torch.where(ok3[..., None], v3, ex)  # degenerate: any axis works
    v1, _ = eigvec(evals[..., 2])
    v1 = v1 - torch.sum(v1 * v3, dim=-1, keepdim=True) * v3
    n1 = torch.sum(v1 * v1, dim=-1, keepdim=True)
    u = eye[torch.argmin(torch.abs(v3), dim=-1)]
    u = u - torch.sum(u * v3, dim=-1, keepdim=True) * v3
    u = u / torch.sqrt(torch.clamp(torch.sum(u * u, dim=-1, keepdim=True), min=1e-30))
    v1 = torch.where(n1 > 1e-24, v1 / torch.sqrt(torch.clamp(n1, min=1e-30)), u)
    v2 = cross(v3, v1)
    evecs = torch.stack([v3, v2, v1], dim=-1)  # columns ascending
    return evals, evecs
