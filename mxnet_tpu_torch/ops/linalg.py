"""Linear-algebra operators (counterpart of ``mxnet_tpu/ops/linalg.py``;
reference src/operator/tensor/la_op.cc) over ``torch.linalg``, on the last
two axes, batched over the leading ones.

The factorizations return the JAX op's layouts: ``gelqf`` (L, Q) with Q's
rows orthonormal, ``syevd`` (U, λ) with U's rows the eigenvectors.  On the
CPU both packages call LAPACK; a GPU solver may choose another sign for a
row of Q or U (and the matching column of L), which the factorization
itself does not fix.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = []


def _t(x, do):
    return x.transpose(-1, -2) if do else x


@register("_linalg_gemm", alias=("linalg_gemm",))
def linalg_gemm(A, B, C, *, transpose_a=False, transpose_b=False, alpha=1.0, beta=1.0,
                axis=-2):
    """``alpha·op(A)·op(B) + beta·C`` (reference la_op.cc:36), the row axis
    ``axis``."""
    if axis != -2:
        A, B, C = (x.movedim(axis, -2) for x in (A, B, C))
    out = alpha * torch.matmul(_t(A, transpose_a), _t(B, transpose_b)) + beta * C
    return out.movedim(-2, axis) if axis != -2 else out


@register("_linalg_gemm2", alias=("linalg_gemm2",))
def linalg_gemm2(A, B, *, transpose_a=False, transpose_b=False, alpha=1.0, axis=-2):
    """``alpha·op(A)·op(B)`` (reference la_op.cc:109)."""
    if axis != -2:
        A, B = A.movedim(axis, -2), B.movedim(axis, -2)
    out = alpha * torch.matmul(_t(A, transpose_a), _t(B, transpose_b))
    return out.movedim(-2, axis) if axis != -2 else out


@register("_linalg_potrf", alias=("linalg_potrf",))
def linalg_potrf(A):
    """The lower Cholesky factor (reference la_op.cc:176)."""
    return torch.linalg.cholesky(A)


@register("_linalg_potri", alias=("linalg_potri",))
def linalg_potri(A):
    """``(A·Aᵀ)⁻¹`` from the lower Cholesky factor ``A`` (reference
    la_op.cc:225): ``A⁻ᵀ·A⁻¹``, A⁻¹ by a triangular solve."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(A.shape)
    inv_a = torch.linalg.solve_triangular(A, eye, upper=False)
    return torch.matmul(inv_a.transpose(-1, -2), inv_a)


@register("_linalg_trmm", alias=("linalg_trmm",))
def linalg_trmm(A, B, *, transpose=False, rightside=False, alpha=1.0, lower=True):
    """``alpha·op(A)·B`` (``B·op(A)`` with ``rightside``), A triangular
    (reference la_op.cc:280)."""
    tri = _t(torch.tril(A) if lower else torch.triu(A), transpose)
    return alpha * (torch.matmul(B, tri) if rightside else torch.matmul(tri, B))


@register("_linalg_trsm", alias=("linalg_trsm",))
def linalg_trsm(A, B, *, transpose=False, rightside=False, alpha=1.0, lower=True):
    """X of ``op(A)·X = alpha·B`` (``X·op(A) = alpha·B`` with
    ``rightside``), A triangular (reference la_op.cc:343)."""
    tri = torch.tril(A) if lower else torch.triu(A)
    upper = not lower
    if transpose:
        tri, upper = tri.transpose(-1, -2), lower
    return torch.linalg.solve_triangular(tri, alpha * B, upper=upper, left=not rightside)


@register("_linalg_sumlogdiag", alias=("linalg_sumlogdiag",))
def linalg_sumlogdiag(A):
    """Σ log of the diagonal (reference la_op.cc:406)."""
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(dim=-1)


@register("_linalg_syrk", alias=("linalg_syrk",))
def linalg_syrk(A, *, transpose=False, alpha=1.0):
    """``alpha·A·Aᵀ`` (``alpha·Aᵀ·A`` with ``transpose``; reference
    la_op.cc:449)."""
    At = A.transpose(-1, -2)
    return alpha * (torch.matmul(At, A) if transpose else torch.matmul(A, At))


@register("_linalg_gelqf", alias=("linalg_gelqf",))
def linalg_gelqf(A):
    """LQ factorization ``A = L·Q``, Q's rows orthonormal (reference
    la_op.cc:506), by the QR of Aᵀ -> (L, Q)."""
    q, r = torch.linalg.qr(A.transpose(-1, -2), mode="reduced")
    return r.transpose(-1, -2), q.transpose(-1, -2)


@register("_linalg_syevd", alias=("linalg_syevd",))
def linalg_syevd(A):
    """Symmetric eigendecomposition ``A = Uᵀ·diag(λ)·U`` (reference
    la_op.cc:577) -> (U, λ), U's rows the eigenvectors, λ ascending."""
    w, v = torch.linalg.eigh(A)
    return v.transpose(-1, -2), w
