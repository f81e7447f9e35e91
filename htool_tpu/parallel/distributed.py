"""Distributed operator — row-partitioned H-matrix over a device mesh.

Mesh-native replacement for the reference's MPI distributed operator
(``distributed_operator/distributed_operator.hpp:19-61`` and
``distributed_operator/linalg/*``): each mesh device owns the block-row of
the H-matrix for its target-cluster partition (the reference builds rank-
restricted trees with ``target_partition_number=rank``,
``distributed_operator/utility.hpp:37-61``).  Storage is the same flat
bucket layout with a leading device axis, sharded over a 1-D
``jax.sharding.Mesh``; products run under ``shard_map`` with XLA
collectives in place of MPI:

- 'N' g2g: local products then concatenation over the partition axis
  (MPI_Allgatherv -> shard_map output spec / ``all_gather``,
  ``add_distributed_operator_vector_product_global_to_global.hpp:76``)
- 'T'/'C' g2g: local transposed products then ``psum``
  (MPI_Allreduce, same file :78)
- l2l: ``all_gather`` of the local slices first
  (``linalg/utility.hpp:11-28``).

Partition sizes are unequal in general; slices are padded to the max
partition size (Allgatherv -> all_gather by padding, SURVEY.md §5) and
re-compacted with precomputed gather indices.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..clustering.cluster_tree import ClusterTree
from ..generator import Generator
from ..hmatrix.assembly import HMatrixBuilder
from ..hmatrix.hmatrix import DenseBucket, HMatrix, LowRankBucket
from ..hmatrix.linalg import matvec as _local_matvec

__all__ = [
    "DistributedHMatrix",
    "build_distributed_hmatrix",
    "build_distributed_from_local_hmatrices",
    "default_mesh",
]


def default_mesh(n_devices: int | None = None, axis_name: str = "p") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


@dataclass
class DistributedHMatrix:
    """Row-partitioned H-matrix: per-device flat buckets, device axis leading.

    ``buckets``: list of (kind, mirror, arrays...) with every array shaped
    ``[P, nb, ...]``; device p's slice is its local block-row with target
    offsets already localized to its partition.
    """

    shape: tuple[int, int]  # global (M, N), cluster numbering
    n_partitions: int
    dense_buckets: list  # DenseBucket with leading device axis on arrays
    lr_buckets: list  # LowRankBucket with leading device axis
    perm_t: Any  # [M] int32 cluster->user
    perm_s: Any
    part_offsets: np.ndarray  # [P] host
    part_sizes: np.ndarray  # [P] host
    m_loc_max: int = 0
    mesh: Mesh | None = None
    axis_name: str = "p"
    symmetry: str = "N"
    UPLO: str = "N"
    info: dict = field(default_factory=dict)

    # gather map: compact [M] <- padded [P * m_loc_max]
    _compact_idx: Any = None  # [M] int32
    # scatter map: padded [P * m_loc_max] <- compact (with trash slot)
    _pad_idx: Any = None  # [P * m_loc_max] int32 into [M+1]
    # per-device partition row offsets, sharded over the mesh
    _t_root: Any = None  # [P] int32

    @property
    def dtype(self):
        for b in self.dense_buckets:
            return b.data.dtype
        for b in self.lr_buckets:
            return b.U.dtype
        return jnp.float32

    # ------------------------------------------------------------------
    def _local_hmatrix(self, dense_slices, lr_slices, t_root_off) -> HMatrix:
        """Build a plain HMatrix view from per-device bucket slices (used
        inside shard_map).  Bucket offsets are GLOBAL; ``t_root_off`` is the
        device's partition row offset (traced inside shard_map), which
        localizes the 't' side of stored terms and the 's' side of mirror
        terms (see linalg._bucket_terms)."""
        return HMatrix(
            shape=(self.m_loc_max, self.shape[1]),
            dense_buckets=dense_slices,
            lr_buckets=lr_slices,
            perm_t=self.perm_t,
            perm_s=self.perm_s,
            symmetry=self.symmetry,
            UPLO=self.UPLO,
            t_root_off=t_root_off,
        )

    # ------------------------------------------------------------------
    def matvec(self, x, op: str = "N"):
        """Global-to-global product in USER numbering: all ranks hold the
        global vector (``add_distributed_operator_vector_product_global_to_
        global.hpp:96-118``)."""
        x = jnp.asarray(x)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        n_in = self.shape[1] if op == "N" else self.shape[0]
        if x.shape[0] != n_in:
            raise ValueError(
                f"input has {x.shape[0]} rows, operator expects {n_in} (op={op!r})"
            )
        in_perm = self.perm_s if op == "N" else self.perm_t
        out_perm = self.perm_t if op == "N" else self.perm_s
        xc = x[in_perm]
        yc = _dist_matvec_g2g(self, xc, op)
        y = jnp.zeros_like(yc).at[out_perm].set(yc)
        return y[:, 0] if squeeze else y

    def __matmul__(self, x):
        return self.matvec(x)

    def matvec_local(self, x_loc, op: str = "N"):
        """Local-to-local product in CLUSTER numbering: each device holds only
        its padded partition slice (``add_distributed_operator_vector_product_
        local_to_local.hpp:18-124``).

        ``x_loc``: [P*m_loc_max, k] (or [P*m_loc_max]) padded local slices,
        sharded (or shardable) over the partition axis.  Returns the same
        layout.  Requires a square operator with identical target/source
        partitions (the reference's l2l use case).
        """
        if self.shape[0] != self.shape[1]:
            raise ValueError("local-to-local products require a square operator")
        x_loc = jnp.asarray(x_loc)
        squeeze = x_loc.ndim == 1
        if squeeze:
            x_loc = x_loc[:, None]
        if x_loc.shape[0] != self.n_partitions * self.m_loc_max:
            raise ValueError(
                f"x_loc has {x_loc.shape[0]} rows, expected P*m_loc_max = "
                f"{self.n_partitions * self.m_loc_max}"
            )
        y = _dist_matvec_l2l(self, x_loc, op)
        return y[:, 0] if squeeze else y

    # --- layout converters (cluster numbering <-> padded local slices) ---
    def to_local_layout(self, xc):
        """[N, ...] cluster-numbered -> [P*m_loc_max, ...] padded slices."""
        xc = jnp.asarray(xc)
        pad = jnp.zeros((1,) + xc.shape[1:], xc.dtype)
        return jnp.concatenate([xc, pad], axis=0)[self._pad_idx]

    def to_global_layout(self, x_pad):
        """[P*m_loc_max, ...] padded slices -> [N, ...] cluster-numbered."""
        return jnp.asarray(x_pad)[self._compact_idx]

    def to_dense(self, user_numbering: bool = True) -> np.ndarray:
        """Oracle export: sum of per-device local dense blocks placed at
        their global rows."""
        M, N = self.shape
        dtype = np.asarray(jnp.zeros((), self.dtype)).dtype
        A = np.zeros((M, N), dtype)
        Pn = self.n_partitions
        for p in range(Pn):
            dense_slices = [
                DenseBucket(b.data[p], b.t_off[p], b.s_off[p], b.t_sizes[p], b.s_sizes[p], b.mirror)
                for b in self.dense_buckets
            ]
            lr_slices = [
                LowRankBucket(b.U[p], b.V[p], b.t_off[p], b.s_off[p], b.t_sizes[p], b.s_sizes[p], b.ranks[p], b.mirror)
                for b in self.lr_buckets
            ]
            off, sz = int(self.part_offsets[p]), int(self.part_sizes[p])
            h = self._local_hmatrix(dense_slices, lr_slices, off)
            Al = h.to_dense(user_numbering=False)
            A[off : off + sz] += Al[:sz]
        if user_numbering:
            perm_t = np.asarray(self.perm_t)
            perm_s = np.asarray(self.perm_s)
            out = np.zeros_like(A)
            out[np.ix_(perm_t, perm_s)] = A
            return out
        return A


def _flatten_dh(d: DistributedHMatrix):
    leaves = (
        d.dense_buckets,
        d.lr_buckets,
        d.perm_t,
        d.perm_s,
        d._compact_idx,
        d._pad_idx,
        d._t_root,
    )
    aux = (
        d.shape,
        d.n_partitions,
        tuple(d.part_offsets.tolist()),
        tuple(d.part_sizes.tolist()),
        d.m_loc_max,
        d.mesh,
        d.axis_name,
        d.symmetry,
        d.UPLO,
    )
    return leaves, aux


def _unflatten_dh(aux, leaves):
    dense_buckets, lr_buckets, perm_t, perm_s, compact_idx, pad_idx, t_root = leaves
    shape, n_partitions, part_offsets, part_sizes, m_loc_max, mesh, axis_name, symmetry, UPLO = aux
    d = DistributedHMatrix(
        shape=shape,
        n_partitions=n_partitions,
        dense_buckets=dense_buckets,
        lr_buckets=lr_buckets,
        perm_t=perm_t,
        perm_s=perm_s,
        part_offsets=np.array(part_offsets),
        part_sizes=np.array(part_sizes),
        m_loc_max=m_loc_max,
        mesh=mesh,
        axis_name=axis_name,
        symmetry=symmetry,
        UPLO=UPLO,
    )
    d._compact_idx = compact_idx
    d._pad_idx = pad_idx
    d._t_root = t_root
    return d


jax.tree_util.register_pytree_node(DistributedHMatrix, _flatten_dh, _unflatten_dh)


# ----------------------------------------------------------------------
# sharded products
# ----------------------------------------------------------------------


def _dist_matvec_g2g(d: DistributedHMatrix, xc, op: str):
    """Cluster-numbering g2g product under shard_map."""
    mesh, ax = d.mesh, d.axis_name
    k = xc.shape[1]
    dtype = jnp.result_type(d.dtype, xc.dtype)
    xc = xc.astype(dtype)

    dense_bs = d.dense_buckets
    lr_bs = d.lr_buckets

    bucket_specs_dense = [
        DenseBucket(P(ax), P(ax), P(ax), P(ax), P(ax), b.mirror) for b in dense_bs
    ]
    bucket_specs_lr = [
        LowRankBucket(P(ax), P(ax), P(ax), P(ax), P(ax), P(ax), P(ax), b.mirror)
        for b in lr_bs
    ]

    if op == "N":

        def local_fn(dense_sl, lr_sl, x_full, t_root_loc):
            dense_sl = [jax.tree.map(lambda a: a[0], b) for b in dense_sl]
            lr_sl = [jax.tree.map(lambda a: a[0], b) for b in lr_sl]
            h = d._local_hmatrix(dense_sl, lr_sl, t_root_loc[0])
            y = _local_matvec(h, x_full, op="N")  # [m_loc_max, k]
            return y

        y_pad = jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(bucket_specs_dense, bucket_specs_lr, P(), P(ax)),
            out_specs=P(ax),
            check_vma=False,
        )(dense_bs, lr_bs, xc, d._t_root)
        # [P * m_loc_max, k] -> compact [M, k]
        return y_pad[d._compact_idx]

    # 'T' / 'C': local transposed products summed across devices (the
    # MPI_Allreduce path, ...g2g.hpp:78)
    def local_fn_t(dense_sl, lr_sl, x_loc, t_root_loc):
        dense_sl = [jax.tree.map(lambda a: a[0], b) for b in dense_sl]
        lr_sl = [jax.tree.map(lambda a: a[0], b) for b in lr_sl]
        h = d._local_hmatrix(dense_sl, lr_sl, t_root_loc[0])
        y = _local_matvec(h, x_loc, op=op)  # [N_glob, k]
        return jax.lax.psum(y, ax)

    # pad target vector to [P * m_loc_max, k]; spec P(ax) hands each device
    # its own partition slice
    x_pad_all = jnp.concatenate([xc, jnp.zeros((1, k), dtype)], axis=0)[d._pad_idx]

    y = jax.shard_map(
        local_fn_t,
        mesh=mesh,
        in_specs=(bucket_specs_dense, bucket_specs_lr, P(ax), P(ax)),
        out_specs=P(),
        check_vma=False,
    )(dense_bs, lr_bs, x_pad_all, d._t_root)
    return y


def _dist_matvec_l2l(d: DistributedHMatrix, x_loc, op: str):
    """Cluster-numbering l2l product: all_gather the local slices (the
    Allgatherv of ``linalg/utility.hpp:11-28``), local products, and for
    'T'/'C' a psum_scatter back to local slices (the reference's
    MPI_Alltoallv + axpy reduction, ``...local_to_local.hpp:60-87``)."""
    mesh, ax = d.mesh, d.axis_name
    dtype = jnp.result_type(d.dtype, x_loc.dtype)
    x_loc = x_loc.astype(dtype)

    dense_bs = d.dense_buckets
    lr_bs = d.lr_buckets
    bucket_specs_dense = [
        DenseBucket(P(ax), P(ax), P(ax), P(ax), P(ax), b.mirror) for b in dense_bs
    ]
    bucket_specs_lr = [
        LowRankBucket(P(ax), P(ax), P(ax), P(ax), P(ax), P(ax), P(ax), b.mirror)
        for b in lr_bs
    ]
    compact_idx = d._compact_idx
    pad_idx = d._pad_idx
    k = x_loc.shape[1]

    def local_fn(dense_sl, lr_sl, x_slice, t_root_loc):
        dense_sl = [jax.tree.map(lambda a: a[0], b) for b in dense_sl]
        lr_sl = [jax.tree.map(lambda a: a[0], b) for b in lr_sl]
        h = d._local_hmatrix(dense_sl, lr_sl, t_root_loc[0])
        if op == "N":
            # gather the global vector, then local block-row product
            x_all = jax.lax.all_gather(x_slice, ax)  # [P, m_loc_max, k]
            x_all = x_all.reshape(-1, k)
            xc = x_all[compact_idx]  # [N, k]
            return _local_matvec(h, xc, op="N")  # [m_loc_max, k]
        # transpose path: full-length local contribution, reduce-scatter to
        # the owning partitions
        y_glob = _local_matvec(h, x_slice, op=op)  # [N, k]
        y_pad = jnp.concatenate([y_glob, jnp.zeros((1, k), y_glob.dtype)], 0)[pad_idx]
        return jax.lax.psum_scatter(y_pad, ax, scatter_dimension=0, tiled=True)

    return jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(bucket_specs_dense, bucket_specs_lr, P(ax), P(ax)),
        out_specs=P(ax),
        check_vma=False,
    )(dense_bs, lr_bs, x_loc, d._t_root)


# ----------------------------------------------------------------------
# builder
# ----------------------------------------------------------------------


def build_distributed_hmatrix(
    generator: Generator,
    tree: ClusterTree,
    mesh: Mesh | None = None,
    epsilon: float = 1e-6,
    eta: float = 10.0,
    symmetry: str = "N",
    UPLO: str = "N",
    source_tree: ClusterTree | None = None,
    mode: str = "full",
    **kwargs,
) -> DistributedHMatrix:
    """Build the row-partitioned operator: one partition-restricted H-matrix
    per mesh device, stacked into device-axis bucket arrays and placed with
    a NamedSharding over the mesh.

    ``mode="full"``: each device owns its full block-row
    (``DefaultApproximationBuilder``, distributed_operator/utility.hpp:
    37-61).  ``mode="local"``: each device owns only its DIAGONAL partition
    block (``DefaultLocalApproximationBuilder``, utility.hpp:63-88) — the
    block-Jacobi operator approximation.

    With ``symmetry`` in {'S','H'}, each device prunes the upper/lower
    triangle of ITS diagonal partition block only
    (``partition_number_for_symmetry=rank``, tree_builder.hpp:95-111) and
    products add the mirrored contributions locally — the reference's
    distributed symmetric storage.
    """
    if mesh is None:
        mesh = default_mesh()
    Pn = mesh.devices.size
    if tree.n_partitions != Pn:
        raise ValueError(
            f"cluster tree has {tree.n_partitions} partitions but mesh has {Pn} devices"
        )
    if mode not in ("full", "local"):
        raise ValueError(f"unknown mode {mode!r}; use 'full' or 'local'")
    st = source_tree if source_tree is not None else tree

    builder = HMatrixBuilder(
        epsilon=epsilon, eta=eta, symmetry=symmetry, UPLO=UPLO, **kwargs
    )
    locals_: list[HMatrix] = []
    for p in range(Pn):
        builder.partition_number_for_symmetry = p if symmetry != "N" else -1
        locals_.append(
            builder.build(
                generator,
                tree,
                st,
                target_partition=p,
                source_partition=p if mode == "local" else -1,
            )
        )
    return build_distributed_from_local_hmatrices(
        locals_, tree, mesh, source_tree=st, symmetry=symmetry, UPLO=UPLO,
        dtype=generator.dtype,
    )


def build_distributed_from_local_hmatrices(
    locals_: list,
    tree: ClusterTree,
    mesh: Mesh | None = None,
    source_tree: ClusterTree | None = None,
    symmetry: str = "N",
    UPLO: str = "N",
    dtype=None,
) -> DistributedHMatrix:
    """Wire USER-BUILT per-partition local operators into a distributed
    operator — the ``CustomApproximationBuilder`` surface
    (``distributed_operator/utility.hpp:21-35``).

    ``locals_[p]`` must be an :class:`HMatrix` whose target root is
    partition ``p`` of ``tree`` (bucket offsets in GLOBAL cluster
    numbering), e.g. from ``HMatrixBuilder.build(..., target_partition=p)``
    or any custom assembly with the same layout."""
    if mesh is None:
        mesh = default_mesh()
    ax = mesh.axis_names[0]
    Pn = mesh.devices.size
    st = source_tree if source_tree is not None else tree
    if len(locals_) != Pn:
        raise ValueError(f"{len(locals_)} local operators for {Pn} devices")
    if dtype is None:
        dtype = locals_[0].dtype

    part_offsets, part_sizes = tree.partition_offsets_sizes()
    m_loc_max = int(part_sizes.max())
    M, N = tree.n_points, st.n_points

    # ---- unify bucket keys across devices and stack with padding ----
    def bucket_key(b):
        if isinstance(b, DenseBucket):
            return ("dense", b.block_shape, b.mirror)
        return ("lr", b.block_shape, b.rank_padded, b.mirror)

    all_keys = sorted(
        {bucket_key(b) for h in locals_ for b in h.dense_buckets + h.lr_buckets},
        key=repr,
    )

    dense_stacked, lr_stacked = [], []
    for key in all_keys:
        per_dev = []
        for p, h in enumerate(locals_):
            found = [
                b for b in (h.dense_buckets + h.lr_buckets) if bucket_key(b) == key
            ]
            per_dev.append(found[0] if found else None)
        nb_max = max((b.n_blocks if b is not None else 0) for b in per_dev)
        if nb_max == 0:
            continue

        if key[0] == "dense":
            _, (bm, bn), mirror = key

            def pad_dense(b, p):
                if b is None:
                    nb = 0
                    data = jnp.zeros((0, bm, bn), dtype)
                    t_off = jnp.zeros((0,), jnp.int32)
                    s_off = jnp.zeros((0,), jnp.int32)
                    t_sz = np.zeros((0,), np.int64)
                    s_sz = np.zeros((0,), np.int64)
                else:
                    nb = b.n_blocks
                    data, t_off, s_off = b.data, b.t_off, b.s_off
                    t_sz, s_sz = b.t_sizes, b.s_sizes
                padn = nb_max - nb
                data = jnp.concatenate(
                    [data, jnp.zeros((padn, bm, bn), data.dtype if nb else dtype)], axis=0
                )
                # offsets stay GLOBAL; padded blocks point at the partition
                # start (zero data -> zero contribution)
                t_loc = jnp.concatenate(
                    [t_off, jnp.full((padn,), int(part_offsets[p]), jnp.int32)]
                )
                s_off = jnp.concatenate([s_off, jnp.zeros((padn,), jnp.int32)])
                t_sz = np.concatenate([t_sz, np.zeros(padn, np.int64)])
                s_sz = np.concatenate([s_sz, np.zeros(padn, np.int64)])
                return data, t_loc, s_off, t_sz, s_sz

            parts = [pad_dense(b, p) for p, b in enumerate(per_dev)]
            dense_stacked.append(
                DenseBucket(
                    data=jnp.stack([q[0] for q in parts]),
                    t_off=jnp.stack([q[1] for q in parts]),
                    s_off=jnp.stack([q[2] for q in parts]),
                    t_sizes=np.stack([q[3] for q in parts]),
                    s_sizes=np.stack([q[4] for q in parts]),
                    mirror=mirror,
                )
            )
        else:
            _, (bm, bn), rp, mirror = key

            def pad_lr(b, p):
                if b is None:
                    nb = 0
                    U = jnp.zeros((0, bm, rp), dtype)
                    V = jnp.zeros((0, rp, bn), dtype)
                    t_off = jnp.zeros((0,), jnp.int32)
                    s_off = jnp.zeros((0,), jnp.int32)
                    t_sz = np.zeros((0,), np.int64)
                    s_sz = np.zeros((0,), np.int64)
                    rk = np.zeros((0,), np.int64)
                else:
                    nb = b.n_blocks
                    U, V, t_off, s_off = b.U, b.V, b.t_off, b.s_off
                    t_sz, s_sz, rk = b.t_sizes, b.s_sizes, np.asarray(b.ranks, np.int64)
                padn = nb_max - nb
                U = jnp.concatenate([U, jnp.zeros((padn, bm, rp), U.dtype if nb else dtype)])
                V = jnp.concatenate([V, jnp.zeros((padn, rp, bn), V.dtype if nb else dtype)])
                t_loc = jnp.concatenate(
                    [t_off, jnp.full((padn,), int(part_offsets[p]), jnp.int32)]
                )
                s_off = jnp.concatenate([s_off, jnp.zeros((padn,), jnp.int32)])
                t_sz = np.concatenate([t_sz, np.zeros(padn, np.int64)])
                s_sz = np.concatenate([s_sz, np.zeros(padn, np.int64)])
                rk = np.concatenate([rk, np.zeros(padn, np.int64)])
                return U, V, t_loc, s_off, t_sz, s_sz, rk

            parts = [pad_lr(b, p) for p, b in enumerate(per_dev)]
            lr_stacked.append(
                LowRankBucket(
                    U=jnp.stack([q[0] for q in parts]),
                    V=jnp.stack([q[1] for q in parts]),
                    t_off=jnp.stack([q[2] for q in parts]),
                    s_off=jnp.stack([q[3] for q in parts]),
                    t_sizes=np.stack([q[4] for q in parts]),
                    s_sizes=np.stack([q[5] for q in parts]),
                    ranks=np.stack([q[6] for q in parts]),
                    mirror=mirror,
                )
            )

    # ---- compaction index maps ----
    compact = np.zeros(M, np.int64)
    pad_map = np.full(Pn * m_loc_max, M, np.int64)  # M = trash slot (zero)
    for p in range(Pn):
        off, sz = int(part_offsets[p]), int(part_sizes[p])
        compact[off : off + sz] = p * m_loc_max + np.arange(sz)
        pad_map[p * m_loc_max : p * m_loc_max + sz] = off + np.arange(sz)

    d = DistributedHMatrix(
        shape=(M, N),
        n_partitions=Pn,
        dense_buckets=dense_stacked,
        lr_buckets=lr_stacked,
        perm_t=jnp.asarray(tree.permutation, jnp.int32),
        perm_s=jnp.asarray(st.permutation, jnp.int32),
        part_offsets=part_offsets,
        part_sizes=part_sizes,
        m_loc_max=m_loc_max,
        mesh=mesh,
        axis_name=ax,
        symmetry=symmetry,
        UPLO=UPLO,
    )
    d._t_root = jax.device_put(
        jnp.asarray(part_offsets, jnp.int32), NamedSharding(mesh, P(ax))
    )
    d._compact_idx = jnp.asarray(compact, jnp.int32)
    d._pad_idx = jnp.asarray(pad_map, jnp.int32)
    d.info["local_infos"] = [h.info for h in locals_]

    # place bucket arrays on the mesh (device axis sharded)
    def shard(b):
        def put(a):
            if isinstance(a, np.ndarray):
                return a
            spec = P(ax, *([None] * (a.ndim - 1)))
            return jax.device_put(a, NamedSharding(mesh, spec))

        return jax.tree.map(put, b)

    d.dense_buckets = [shard(b) for b in d.dense_buckets]
    d.lr_buckets = [shard(b) for b in d.lr_buckets]
    return d
