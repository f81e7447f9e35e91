"""Flat bucketed H-matrix container (device-resident, pytree).

Flat replacement for the reference's pointer block tree
(``hmatrix/hmatrix.hpp:28-245``): all leaves live in a handful of stacked
3-D arrays ("buckets") grouped by padded block shape — dense buckets
``[nb, bm, bn]`` and low-rank buckets ``U [nb, bm, r] / V [nb, r, bn]``
(the ``LowRankMatrix`` equivalent, ``hmatrix/lrmat/lrmat.hpp:15-128``) —
plus int32 offset tables into the cluster numbering.  Padded rows/cols/ranks
are exact zeros, so products need no masks at runtime.

The container is a registered pytree: jitted linalg takes it as a plain
argument; re-assembly with identical structure hits the compile cache.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["DenseBucket", "LowRankBucket", "HMatrix"]


@dataclass
class DenseBucket:
    """Stacked same-shape dense leaves."""

    data: Any  # [nb, bm, bn] device
    t_off: Any  # [nb] int32, cluster numbering
    s_off: Any  # [nb] int32
    # host-side true sizes (padding bookkeeping / info only)
    t_sizes: np.ndarray = None
    s_sizes: np.ndarray = None
    mirror: bool = False  # symmetric mirrored contribution in products

    @property
    def n_blocks(self) -> int:
        return int(self.data.shape[0])

    @property
    def block_shape(self) -> tuple[int, int]:
        return (int(self.data.shape[1]), int(self.data.shape[2]))


@dataclass
class LowRankBucket:
    """Stacked same-shape low-rank leaves (U·V factorization)."""

    U: Any  # [nb, bm, r]
    V: Any  # [nb, r, bn]
    t_off: Any  # [nb] int32
    s_off: Any  # [nb] int32
    t_sizes: np.ndarray = None
    s_sizes: np.ndarray = None
    ranks: np.ndarray = None  # true ranks per block (host)
    mirror: bool = False

    @property
    def n_blocks(self) -> int:
        return int(self.U.shape[0])

    @property
    def block_shape(self) -> tuple[int, int]:
        return (int(self.U.shape[1]), int(self.V.shape[2]))

    @property
    def rank_padded(self) -> int:
        return int(self.U.shape[2])


def _flatten_dense(b: DenseBucket):
    # host-side size arrays ride along as leaves (unused inside jitted code)
    return (b.data, b.t_off, b.s_off, b.t_sizes, b.s_sizes), (b.mirror,)


def _unflatten_dense(aux, leaves):
    data, t_off, s_off, t_sizes, s_sizes = leaves
    (mirror,) = aux
    return DenseBucket(data, t_off, s_off, t_sizes, s_sizes, mirror)


def _flatten_lr(b: LowRankBucket):
    return (b.U, b.V, b.t_off, b.s_off, b.t_sizes, b.s_sizes, b.ranks), (b.mirror,)


def _unflatten_lr(aux, leaves):
    U, V, t_off, s_off, t_sizes, s_sizes, ranks = leaves
    return LowRankBucket(U, V, t_off, s_off, t_sizes, s_sizes, ranks, aux[0])


jax.tree_util.register_pytree_node(DenseBucket, _flatten_dense, _unflatten_dense)
jax.tree_util.register_pytree_node(LowRankBucket, _flatten_lr, _unflatten_lr)


@dataclass
class HMatrix:
    """Flat H-matrix over cluster numbering, with user-numbering wrappers.

    ``shape`` is the (local target span, source span) in cluster numbering;
    ``t_root_off`` is the cluster-numbering offset of the (possibly
    partition-restricted) target root, so a partition-local block-row stores
    rows ``[t_root_off, t_root_off + shape[0])`` of the global operator
    (reference ``reset_root_of_block_tree``, tree_builder.hpp:533-566).
    """

    shape: tuple[int, int]
    dense_buckets: list
    lr_buckets: list
    perm_t: Any  # [M_global] int32, cluster -> user
    perm_s: Any  # [N_global] int32
    symmetry: str = "N"
    UPLO: str = "N"
    t_root_off: int = 0
    s_root_off: int = 0
    info: dict = field(default_factory=dict)

    @property
    def dtype(self):
        for b in self.dense_buckets:
            return b.data.dtype
        for b in self.lr_buckets:
            return b.U.dtype
        return jnp.float32

    @property
    def nbytes(self) -> int:
        """Bytes of the stored (padded) bucket entries, from static shapes."""
        item = jnp.dtype(self.dtype).itemsize
        n = sum(int(np.prod(b.data.shape)) for b in self.dense_buckets)
        n += sum(int(np.prod(b.U.shape)) + int(np.prod(b.V.shape))
                 for b in self.lr_buckets)
        return n * item

    # ------------------------------------------------------------------
    def __matmul__(self, x):
        from .linalg import matvec_user

        return matvec_user(self, x)

    def to_dense(self, user_numbering: bool = True) -> np.ndarray:
        from .linalg import to_dense

        return to_dense(self, user_numbering=user_numbering)

    def get_info(self) -> dict:
        from .info import hmatrix_info

        return hmatrix_info(self)


def _flatten_h(h: HMatrix):
    # t_root_off rides as a LEAF so a per-device (traced) row offset can be
    # used inside shard_map for partition-restricted symmetric storage
    leaves = (h.dense_buckets, h.lr_buckets, h.perm_t, h.perm_s, h.t_root_off)
    aux = (h.shape, h.symmetry, h.UPLO, h.s_root_off)
    return leaves, aux


def _unflatten_h(aux, leaves):
    dense_buckets, lr_buckets, perm_t, perm_s, t_root_off = leaves
    shape, symmetry, UPLO, s_root_off = aux
    return HMatrix(
        shape=shape,
        dense_buckets=dense_buckets,
        lr_buckets=lr_buckets,
        perm_t=perm_t,
        perm_s=perm_s,
        symmetry=symmetry,
        UPLO=UPLO,
        t_root_off=t_root_off,
        s_root_off=s_root_off,
    )


jax.tree_util.register_pytree_node(HMatrix, _flatten_h, _unflatten_h)
