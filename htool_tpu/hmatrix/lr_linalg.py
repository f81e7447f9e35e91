"""Mixed-operand products between dense matrices, low-rank pairs and
H-matrices.

Batched counterpart of the reference's mixed linalg headers
(``hmatrix/linalg/add_matrix_hmatrix_product.hpp``,
``add_lrmat_hmatrix_product.hpp``, ``add_hmatrix_lrmat_product.hpp``,
``add_lrmat_hmatrix.hpp`` and the LR algebra in ``hmatrix/lrmat/linalg/*``:
``add_lrmat_lrmat.hpp:14-108``, ``add_lrmat_lrmat_product.hpp``,
``add_lrmat_matrix_product.hpp``, ``add_matrix_lrmat_product.hpp``,
``add_lrmat_vector_product.hpp``, ``scale``).

Design: a low-rank operand is a plain ``LowRank(U, V)`` pair of jnp arrays
(the single-block analog of the stacked ``LowRankBucket``).  Every product
reduces to einsums on the factors — the device sees only dense matmuls — and
H-matrix operands re-use the batched bucket products in ``linalg.py`` (a
left operand is handled through the transpose products, never by
materializing the H-matrix).  Truncated LR+LR addition concatenates the
factors and calls the batched QR+SVD recompression with batch size 1.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .compressors import batched_recompress, svd_truncation_rank
from .hmatrix import HMatrix
from .linalg import matmat

__all__ = [
    "LowRank",
    "lrmat_from_dense",
    "lrmat_vector_product",
    "lrmat_matrix_product",
    "matrix_lrmat_product",
    "lrmat_lrmat_product",
    "add_lrmat_lrmat",
    "matrix_hmatrix_product",
    "hmatrix_lrmat_product",
    "lrmat_hmatrix_product",
    "scale_lrmat",
]


class LowRank(NamedTuple):
    """A single low-rank block ``U @ V`` (``hmatrix/lrmat/lrmat.hpp:15-128``).

    U: [m, r], V: [r, n].
    """

    U: jnp.ndarray
    V: jnp.ndarray

    @property
    def shape(self):
        return (self.U.shape[0], self.V.shape[1])

    @property
    def rank(self):
        return self.U.shape[1]

    def to_dense(self):
        return self.U @ self.V

    def conj_transpose(self, op: str = "T"):
        """op(U·V) as a LowRank: 'T' -> (Vᵀ, Uᵀ), 'C' -> (Vᴴ, Uᴴ)."""
        if op == "T":
            return LowRank(self.V.T, self.U.T)
        if op == "C":
            return LowRank(jnp.conj(self.V.T), jnp.conj(self.U.T))
        raise ValueError(op)


def _op(A, op: str):
    if op == "N":
        return A
    if op == "T":
        return A.T
    if op == "C":
        return jnp.conj(A.T)
    raise ValueError(op)


def lrmat_from_dense(A, epsilon: float) -> LowRank:
    """Truncated-SVD factorization of a dense block at the reference's
    trailing-energy rank rule (``SVD_truncation.hpp:14-55``)."""
    A = jnp.asarray(A)
    Uf, s, Vh = jnp.linalg.svd(A, full_matrices=False)
    k = int(svd_truncation_rank(s[None, :], epsilon)[0])
    k = max(k, 1)
    return LowRank(Uf[:, :k] * s[:k][None, :].astype(A.dtype), Vh[:k])


def lrmat_vector_product(lr: LowRank, x, op: str = "N"):
    """op(U·V) @ x (``add_lrmat_vector_product.hpp:28``)."""
    if op == "N":
        return lr.U @ (lr.V @ x)
    if op == "T":
        return lr.V.T @ (lr.U.T @ x)
    if op == "C":
        return jnp.conj(lr.V.T) @ (jnp.conj(lr.U.T) @ x)
    raise ValueError(op)


def lrmat_matrix_product(lr: LowRank, B, op: str = "N", opb: str = "N") -> LowRank:
    """op(lr) · opb(B) -> LowRank (``add_lrmat_matrix_product.hpp:111``)."""
    a = lr if op == "N" else lr.conj_transpose(op)
    return LowRank(a.U, a.V @ _op(jnp.asarray(B), opb))


def matrix_lrmat_product(A, lr: LowRank, opa: str = "N", op: str = "N") -> LowRank:
    """opa(A) · op(lr) -> LowRank (``add_matrix_lrmat_product.hpp:115``)."""
    b = lr if op == "N" else lr.conj_transpose(op)
    return LowRank(_op(jnp.asarray(A), opa) @ b.U, b.V)


def lrmat_lrmat_product(a: LowRank, b: LowRank, opa: str = "N", opb: str = "N") -> LowRank:
    """opa(a) · opb(b) -> LowRank of rank min(ra, rb)
    (``add_lrmat_lrmat_product.hpp:103``): the inner factor ``Va·Ub`` is
    absorbed into the side with larger rank."""
    a = a if opa == "N" else a.conj_transpose(opa)
    b = b if opb == "N" else b.conj_transpose(opb)
    mid = a.V @ b.U  # [ra, rb]
    if a.rank <= b.rank:
        return LowRank(a.U, mid @ b.V)
    return LowRank(a.U @ mid, b.V)


def add_lrmat_lrmat(a: LowRank, b: LowRank, epsilon: float) -> LowRank:
    """Truncated LR+LR addition (``add_lrmat_lrmat.hpp:14-108``): concatenate
    factors, QR+SVD recompress at epsilon (``SVD_recompression.hpp:18-181``)."""
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    U = jnp.concatenate([a.U, b.U], axis=1)
    V = jnp.concatenate([a.V, b.V], axis=0)
    r = U.shape[1]
    U2, V2, new_rank = batched_recompress(
        U[None], V[None], jnp.array([r], jnp.int32), epsilon
    )
    k = max(int(new_rank[0]), 1)
    return LowRank(U2[0, :, :k], V2[0, :k, :])


def matrix_hmatrix_product(X, h: HMatrix, op: str = "N", oph: str = "N"):
    """op(X) · oph(H) dense result (``add_matrix_hmatrix_product.hpp``):
    computed through the H-matrix transpose products, ``(X·H) = (Hᵀ·Xᵀ)ᵀ``,
    so the H operand is never materialized."""
    Xo = _op(jnp.asarray(X), op)
    # Xo @ oph(H) = ( oph(H)^T @ Xo^T )^T ; map oph -> the h-product mode
    # op2 with op2(H) = oph(H)^T: N->T, T->N, C->conj = conj(T of conj)
    if oph == "N":
        return matmat(h, Xo.T, op="T").T
    if oph == "T":
        return matmat(h, Xo.T, op="N").T
    if oph == "C":  # oph(H)^T = conj(H)
        return jnp.conj(matmat(h, jnp.conj(Xo.T), op="N")).T
    raise ValueError(oph)


def hmatrix_lrmat_product(h: HMatrix, lr: LowRank, oph: str = "N") -> LowRank:
    """oph(H) · lr -> LowRank (``add_hmatrix_lrmat_product.hpp``): only the
    thin U factor flows through the H product."""
    return LowRank(matmat(h, lr.U, op=oph), lr.V)


def lrmat_hmatrix_product(lr: LowRank, h: HMatrix, oph: str = "N") -> LowRank:
    """lr · oph(H) -> LowRank (``add_lrmat_hmatrix_product.hpp``)."""
    return LowRank(lr.U, matrix_hmatrix_product(lr.V, h, oph=oph))


def scale_lrmat(alpha, lr: LowRank) -> LowRank:
    """alpha · lr (``lrmat/linalg/scale.hpp``)."""
    return LowRank(alpha * lr.U, lr.V)
