"""H-matrix assembly: lower a block-tree plan to the flat bucketed layout.

Batched equivalent of ``HMatrixTreeBuilder::build`` + leaf computation
(``hmatrix/tree_builder/tree_builder.hpp:276-300,568-712``): instead of a
per-leaf loop calling the generator one block at a time, leaves are grouped
into same-padded-shape buckets and each bucket is assembled by ONE device
kernel — a batched generator gather for dense leaves (the analog of the
``VirtualDenseBlocksGenerator`` batch path, tree_builder.hpp:585-600) and the
batched partial ACA of :mod:`.aca` for admissible leaves.  ACA failures
("false positives", tree_builder.hpp:572-577) fall back to dense buckets.
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..clustering.cluster_tree import ClusterTree
from ..generator import Generator, TransposedGenerator
from .aca import batched_partial_aca
from .block_tree import BlockTreePlan, plan_block_tree
from .hmatrix import DenseBucket, HMatrix, LowRankBucket
from ..utils.precision import precise_jit

__all__ = ["HMatrixBuilder", "build_hmatrix", "assemble_from_plan"]


def _pad_dim(s: int, mode: str = "pow2") -> int:
    """Pad a block dimension.

    ``mode='mult8'``: next multiple of 8 (tightest memory).  ``mode='mult32'``:
    next multiple of 32 (storage class coarsening — merges near-equal shapes
    into one bucket so the product launches fewer kernels).  ``mode='pow2'``
    (default): next power of two — a few× more padded FLOPs, but collapses
    the per-level shape zoo into ~log2 distinct buckets, which matters
    because each distinct shape costs a full XLA compile, which can take
    longer than the device work it compiles."""
    if s <= 8:
        return 8
    if mode == "mult8":
        return int(-(-s // 8) * 8)
    if mode == "mult32":
        return max(32, int(-(-s // 32) * 32))
    p = 8
    while p < s:
        p *= 2
    return p


def _pad_rank(r: int) -> int:
    p = 8
    while p < r:
        p *= 2
    return p


@precise_jit
def _assemble_dense_bucket(gen, rows, cols, t_sizes, s_sizes):
    """rows [nb, bm], cols [nb, bn] (user numbering, padded entries clamped).
    Returns data [nb, bm, bn] with padded rows/cols zeroed."""
    data = gen.block(rows, cols)
    bm, bn = rows.shape[1], cols.shape[1]
    row_mask = jnp.arange(bm)[None, :] < t_sizes[:, None]
    col_mask = jnp.arange(bn)[None, :] < s_sizes[:, None]
    return jnp.where(row_mask[:, :, None] & col_mask[:, None, :], data, 0)


def _block_indices(perm: np.ndarray, offs: np.ndarray, sizes: np.ndarray, pad: int):
    """User-numbering gather indices for blocks: [nb, pad]; padded entries are
    clamped to the last valid index (their values are masked to zero)."""
    nb = offs.shape[0]
    ar = np.arange(pad)[None, :]
    rel = np.minimum(ar, sizes[:, None] - 1)
    return perm[offs[:, None] + rel]


_COMPRESSORS = {}


def _get_compressor(name):
    """Resolve a compressor: a registry name, or a user-supplied CALLABLE
    with the ``batched_partial_aca`` signature — the
    ``VirtualLowRankGenerator`` hook (virtual_lrmat_generator.hpp:11-56)::

        compressor(generator, rows, cols, t_sizes, s_sizes, epsilon, rmax,
                   reqrank) -> (U [nb,m,rmax], V [nb,rmax,n], rank [nb],
                                failed [nb])

    ``failed`` marks blocks that must fall back to dense storage."""
    if callable(name):
        return name
    if not _COMPRESSORS:
        from .compressors import batched_full_aca, batched_svd_compress

        _COMPRESSORS.update(
            partial_aca=batched_partial_aca,
            sym_partial_aca=batched_partial_aca,  # orientation handled by caller
            full_aca=batched_full_aca,
            svd=batched_svd_compress,
        )
    try:
        return _COMPRESSORS[name]
    except KeyError:
        raise ValueError(
            f"unknown compressor {name!r}; choose from {sorted(_COMPRESSORS)}"
        ) from None


# ---- memory-bounded escalating compression -------------------------------

_ACA_CHUNK_BUDGET = int(2e9)  # bytes of U/V buffers per compression launch
_ACA_CAPS = (64, 256)  # escalating rank caps before the full advantage bound

# Internal stop-tolerance safety factor for the partial-ACA Frobenius
# ESTIMATOR (partialACA.hpp:78 stops on an estimate of the incremental
# error, not the true residual, so individual blocks can land slightly
# above the requested tolerance).  The user-facing contract is GLOBAL
# rel-Frobenius error < epsilon (the reference's acceptance test,
# test_hmatrix_build.hpp:191); stopping the estimator a factor tighter
# keeps the worst blocks under it at a few-percent rank cost.  Measured
# (n=10k sphere, eps=1e-3, f32): global compression error 2.3e-8 at 0.25 —
# the estimator slack is small for these kernels, 0.5 is a mild guard.
# Exact-residual compressors (full ACA, SVD) are not affected.
_ACA_STOP_FACTOR = 0.5


@partial(jax.jit, static_argnames=("cw",), donate_argnums=(0, 1))
def _place_chunk(U, V, Uc, Vc, dst, src, *, cw):
    """One fused placement kernel per (bucket, cap) pass — replaces ~10
    tiny eager-op compiles (gather/slice/scatter/convert) per chunk, which
    would dominate cold assembly."""
    U = U.at[dst, :, :cw].set(Uc[src, :, :cw].astype(U.dtype))
    V = V.at[dst, :cw, :].set(Vc[src, :cw, :].astype(V.dtype))
    return U, V


@partial(jax.jit, static_argnames=("bm8", "bn8", "rc"))
def _class_slice(U, V, sel, *, bm8, bn8, rc):
    """Fused storage-class restriction (one compile per class)."""
    return U[sel, :bm8, :rc], V[sel, :rc, :bn8]


def _compress_escalating(
    compress, generator, rows, cols, t_szs, s_szs, epsilon, rmax, reqrank
):
    """Run the batched compressor with escalating rank caps and bounded
    buffer memory.

    The advantage bound ``rmax ~ mn/(m+n)`` (partialACA.hpp:84) can be
    hundreds while realized ranks are ~10, and the batched buffers are
    allocated at ``rmax`` — at BASELINE scales that alone exhausts device
    memory.  So:
    compress everything at a small cap first; only blocks that fail escalate
    to the next cap (their ``failed`` flag means "hit the cap without
    meeting the estimator"); the last pass runs at the true ``rmax`` so the
    final failures are genuine dense fallbacks.  Each pass is chunked so
    U/V buffers stay under a fixed byte budget (one compiled shape per
    (bucket, cap): chunks are padded to a common size).

    Returns (U [nb, m, w], V [nb, w, n], rank [nb] np, failed [nb] np) with
    ``w`` the smallest pow2 covering the realized ranks.

    Compile discipline (cold assembly is dominated by the NUMBER of
    distinct compiled shapes, not device time): all index bookkeeping stays in host NumPy, every chunk of a
    (bucket, cap) pass is padded to ONE common pow2 size, and the result
    placement uses fixed-length padded gathers/scatters — so each pass
    compiles exactly one ACA kernel and one placement kernel."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    nb, bm = rows.shape
    bn = cols.shape[1]
    itemsize = jnp.dtype(generator.dtype).itemsize

    if reqrank > 0:
        caps = [rmax]
    else:
        caps = [c for c in _ACA_CAPS if c < rmax] + [rmax]

    rank = np.zeros(nb, np.int64)
    failed = np.ones(nb, bool)
    pending = np.ones(nb, bool)
    results = []  # (scatter idx [csz], gather idx [csz], U chunk, V chunk)

    for cap in caps:
        idx = np.nonzero(pending)[0]
        if idx.size == 0:
            break
        per_block = (bm + bn) * cap * itemsize * 3  # U + V + transients
        chunk = max(1, min(int(_ACA_CHUNK_BUDGET // per_block), idx.size))
        p = 1
        while p * 2 <= chunk:
            p *= 2
        chunk = p
        csz = 1  # ONE padded chunk size for the whole pass
        while csz < min(chunk, idx.size):
            csz *= 2
        for lo in range(0, idx.size, csz):
            sel = idx[lo : lo + csz]
            padn = csz - sel.size
            sel_pad = np.concatenate([sel, np.full(padn, sel[-1], sel.dtype)])
            Uc, Vc, rk, fl = compress(
                generator,
                jnp.asarray(rows[sel_pad], jnp.int32),
                jnp.asarray(cols[sel_pad], jnp.int32),
                jnp.asarray(t_szs[sel_pad], jnp.int32),
                jnp.asarray(s_szs[sel_pad], jnp.int32),
                epsilon,
                cap,
                reqrank,
            )
            rk = np.asarray(rk)[: sel.size]
            fl = np.asarray(fl)[: sel.size]
            ok = ~fl
            rank[sel[ok]] = rk[ok]
            failed[sel[ok]] = False
            pending[sel[ok]] = False
            if ok.any():
                # fixed-length placement: pad gather/scatter indices with a
                # repeat of the last successful block (duplicate scatter
                # targets receive the same value — deterministic)
                src = np.nonzero(ok)[0]
                dst = sel[src]
                padk = csz - src.size
                src = np.concatenate([src, np.full(padk, src[-1], src.dtype)])
                dst = np.concatenate([dst, np.full(padk, dst[-1], dst.dtype)])
                results.append((dst, src, Uc, Vc))

    # assemble final buffers at the tight pow2 width
    w = 8
    top = int(rank.max()) if nb else 0
    while w < min(top, rmax):
        w *= 2
    w = min(w, rmax) if rmax >= 1 else 1
    dtype = generator.dtype
    U = jnp.zeros((nb, bm, w), dtype)
    V = jnp.zeros((nb, w, bn), dtype)
    for dst, src, Uc, Vc in results:
        cw = min(w, Uc.shape[2])
        U, V = _place_chunk(
            U, V, Uc, Vc,
            jnp.asarray(np.asarray(dst, np.int32)),
            jnp.asarray(np.asarray(src, np.int32)),
            cw=cw,
        )
    return U, V, rank, failed


def assemble_from_plan(
    plan: BlockTreePlan,
    generator: Generator,
    max_rank: int | None = None,
    reqrank: int = -1,
    compressor="partial_aca",
    recompress: bool = False,
) -> HMatrix:
    """Assemble the flat H-matrix from a planned block tree.

    ``compressor``: "partial_aca" (default), "sym_partial_aca" (partial ACA
    with the offset-oriented pivot walk of the reference's default
    sympartialACA, ``sympartialACA.hpp:48-63``: blocks with
    ``t_off < s_off`` are compressed on the transposed block so (i,j)/(j,i)
    pairs generate transpose-consistent crosses), "full_aca", "svd"
    (tree_builder.hpp:384-390 picks the strategy; here it is a parameter),
    or any CALLABLE with the ``batched_partial_aca`` signature — the
    user-pluggable ``VirtualLowRankGenerator`` hook (see
    :func:`_get_compressor`).

    ``recompress=True`` applies batched SVD recompression to every
    compressed block right after compression, composing with ANY compressor
    — the ``RecompressedLowRankGenerator`` decorator
    (recompressed_low_rank_generator.hpp:19-25)."""
    tt, st = plan.target_tree, plan.source_tree
    perm_t, perm_s = tt.permutation, st.permutation
    t0 = time.perf_counter()

    dense_buckets: list[DenseBucket] = []
    lr_buckets: list[LowRankBucket] = []
    n_false_positive = 0
    sym_orient = compressor == "sym_partial_aca"

    # ---------------- group leaves by (padded shape, mirror) ----------------
    # dense buckets store at tight mult8 shapes (their gather kernels are
    # cheap to compile); admissible buckets use pow2 COMPUTE shapes so the
    # expensive ACA kernel compiles only ~log2 times, then storage is
    # re-tightened below
    def group(leaves, mode, orient=False):
        groups: dict[tuple[int, int, bool, bool], list] = {}
        for l in leaves:
            swap = bool(orient and l.t_off < l.s_off)
            key = (_pad_dim(l.t_size, mode), _pad_dim(l.s_size, mode), l.mirror, swap)
            groups.setdefault(key, []).append(l)
        return groups

    dense_groups = group(plan.dense, "mult32")
    adm_groups = group(plan.admissible, "pow2", orient=sym_orient)

    # ---------------- admissible leaves: batched ACA ----------------
    t_aca0 = time.perf_counter()
    for (bm, bn, mirror, swap), leaves in sorted(adm_groups.items()):
        t_offs = np.array([l.t_off for l in leaves], dtype=np.int64)
        s_offs = np.array([l.s_off for l in leaves], dtype=np.int64)
        t_szs = np.array([l.t_size for l in leaves], dtype=np.int64)
        s_szs = np.array([l.s_size for l in leaves], dtype=np.int64)

        # host NumPy: chunk slicing in _compress_escalating stays on host
        rows = _block_indices(perm_t, t_offs, t_szs, bm).astype(np.int32)
        cols = _block_indices(perm_s, s_offs, s_szs, bn).astype(np.int32)

        # advantage bound caps the useful rank (partialACA.hpp:84)
        max_useful = int(np.max((t_szs * s_szs) // (t_szs + s_szs))) + 1
        rmax = min(max_useful, min(bm, bn))
        if max_rank is not None:
            rmax = min(rmax, max_rank)
        if reqrank > 0:
            rmax = min(max(rmax, reqrank), min(bm, bn))
        rmax = max(rmax, 1)

        compress = _get_compressor(compressor)
        # estimator-based compressors stop at a tighter internal tolerance
        # so the GLOBAL error honors the user's epsilon (see _ACA_STOP_FACTOR)
        eps_stop = plan.epsilon * (
            _ACA_STOP_FACTOR
            if compressor in ("partial_aca", "sym_partial_aca")
            else 1.0
        )
        if swap:
            # transposed walk (sympartialACA orientation): compress Aᵀ, then
            # A = (U_B V_B)ᵀ = V_Bᵀ · U_Bᵀ
            U_B, V_B, rank, failed = _compress_escalating(
                compress,
                TransposedGenerator(generator),
                cols,
                rows,
                s_szs,
                t_szs,
                eps_stop,
                rmax,
                reqrank,
            )
            U = jnp.swapaxes(V_B, 1, 2)
            V = jnp.swapaxes(U_B, 1, 2)
        else:
            U, V, rank, failed = _compress_escalating(
                compress,
                generator,
                rows,
                cols,
                t_szs,
                s_szs,
                eps_stop,
                rmax,
                reqrank,
            )

        if recompress:
            # assembly-time SVD recompression of every successful block —
            # the RecompressedLowRankGenerator decorator
            # (recompressed_low_rank_generator.hpp:19-25)
            from .compressors import batched_recompress

            U, V, nr = batched_recompress(
                U, V, jnp.asarray(rank, jnp.int32), plan.epsilon
            )
            rank = np.where(failed, 0, np.asarray(nr))

        # --- successful blocks: re-pack into tight storage buckets ---
        # ACA ran at the pow2 compute shape (few compiled kernels); storage
        # slices the factors back to mult8 block/rank classes so products
        # don't pay the pow2 padding (rows/cols beyond the true size are
        # exact zeros, so slicing is lossless)
        ok = np.nonzero(~failed & (rank > 0))[0]
        if ok.size:
            # storage classes use mult32 dims (merging near-equal shapes) and
            # one pow2 rank per class (= pow2 of the class max) so the product
            # path launches as few kernels as possible; rows/cols/rank columns
            # beyond true sizes are exact zeros so the padding is lossless
            sclasses: dict[tuple[int, int], list[int]] = {}
            for i in ok:
                key = (
                    min(bm, _pad_dim(int(t_szs[i]), "mult32")),
                    min(bn, _pad_dim(int(s_szs[i]), "mult32")),
                )
                sclasses.setdefault(key, []).append(int(i))
            for (bm8, bn8), idxs in sorted(sclasses.items()):
                sel = np.array(idxs)
                rc = _pad_rank(int(rank[sel].max()))
                rc_eff = min(rc, rmax)
                Uc, Vc = _class_slice(
                    U, V, jnp.asarray(np.asarray(sel, np.int32)),
                    bm8=bm8, bn8=bn8, rc=rc_eff,
                )
                lr_buckets.append(
                    LowRankBucket(
                        U=Uc,
                        V=Vc,
                        t_off=jnp.asarray(t_offs[sel].astype(np.int32)),
                        s_off=jnp.asarray(s_offs[sel].astype(np.int32)),
                        t_sizes=t_szs[sel],
                        s_sizes=s_szs[sel],
                        ranks=rank[sel],
                        mirror=mirror,
                    )
                )

        # --- failed blocks: dense fallback (false positives) ---
        bad = np.nonzero(failed)[0]
        n_false_positive += int(bad.size)
        for i in bad:
            l = leaves[int(i)]
            key = (
                _pad_dim(l.t_size, "mult32"),
                _pad_dim(l.s_size, "mult32"),
                l.mirror,
                False,
            )
            dense_groups.setdefault(key, []).append(l)

    # ---------------- dense leaves: batched generator gather ----------------
    t_aca = time.perf_counter() - t_aca0
    t_dense0 = time.perf_counter()
    for (bm, bn, mirror, _), leaves in sorted(dense_groups.items()):
        if not leaves:
            continue
        t_offs = np.array([l.t_off for l in leaves], dtype=np.int64)
        s_offs = np.array([l.s_off for l in leaves], dtype=np.int64)
        t_szs = np.array([l.t_size for l in leaves], dtype=np.int64)
        s_szs = np.array([l.s_size for l in leaves], dtype=np.int64)
        rows = jnp.asarray(_block_indices(perm_t, t_offs, t_szs, bm), jnp.int32)
        cols = jnp.asarray(_block_indices(perm_s, s_offs, s_szs, bn), jnp.int32)
        data = _assemble_dense_bucket(
            generator,
            rows,
            cols,
            jnp.asarray(t_szs, jnp.int32),
            jnp.asarray(s_szs, jnp.int32),
        )
        dense_buckets.append(
            DenseBucket(
                data=data,
                t_off=jnp.asarray(t_offs, jnp.int32),
                s_off=jnp.asarray(s_offs, jnp.int32),
                t_sizes=t_szs,
                s_sizes=s_szs,
                mirror=mirror,
            )
        )

    # ---------------- container ----------------
    if plan.target_partition >= 0:
        t_root = int(tt.partition_roots[plan.target_partition])
        t_root_off = int(tt.offsets[t_root])
        m_local = int(tt.sizes[t_root])
    else:
        t_root_off = 0
        m_local = tt.n_points

    h = HMatrix(
        shape=(m_local, st.n_points),
        dense_buckets=dense_buckets,
        lr_buckets=lr_buckets,
        perm_t=jnp.asarray(perm_t, jnp.int32),
        perm_s=jnp.asarray(perm_s, jnp.int32),
        symmetry=plan.symmetry,
        UPLO=plan.UPLO,
        t_root_off=t_root_off,
        s_root_off=0,
        info={},
    )
    h.info.update(
        epsilon=plan.epsilon,
        eta=plan.eta,
        n_false_positive=n_false_positive,
        n_dense_blocks=sum(b.n_blocks for b in dense_buckets),
        n_low_rank_blocks=sum(b.n_blocks for b in lr_buckets),
        assembly_walltime=time.perf_counter() - t0,
        # phase breakdown (the reference's chrono timings plus the split
        # its info map lacks): compression vs dense generator evaluation
        aca_walltime=t_aca,
        dense_blocks_walltime=time.perf_counter() - t_dense0,
    )
    return h


class HMatrixBuilder:
    """Convenience builder mirroring ``HMatrixTreeBuilder``
    (tree_builder.hpp:180-264): parameters epsilon, eta, symmetry/UPLO,
    reqrank, min depths, block-tree consistency."""

    def __init__(
        self,
        epsilon: float = 1e-6,
        eta: float = 10.0,
        symmetry: str = "N",
        UPLO: str = "N",
        reqrank: int = -1,
        min_target_depth: int = 0,
        min_source_depth: int = 0,
        max_rank: int | None = None,
        block_tree_consistency: bool = True,
        compressor="partial_aca",
        recompress: bool = False,
        partition_number_for_symmetry: int = -1,
        admissibility=None,
    ):
        self.compressor = compressor
        self.recompress = recompress
        self.partition_number_for_symmetry = partition_number_for_symmetry
        # pluggable VirtualAdmissibilityCondition hook
        # (virtual_admissibility_condition.hpp:17-24); None = RjasanowSteinbach
        self.admissibility = admissibility
        self.epsilon = epsilon
        self.eta = eta
        self.symmetry = symmetry
        self.UPLO = UPLO
        self.reqrank = reqrank
        self.min_target_depth = min_target_depth
        self.min_source_depth = min_source_depth
        self.max_rank = max_rank
        self.block_tree_consistency = block_tree_consistency

    def build(
        self,
        generator: Generator,
        target_tree: ClusterTree,
        source_tree: ClusterTree | None = None,
        target_partition: int = -1,
        source_partition: int = -1,
    ) -> HMatrix:
        t0 = time.perf_counter()
        plan = plan_block_tree(
            target_tree,
            source_tree,
            epsilon=self.epsilon,
            eta=self.eta,
            symmetry=self.symmetry,
            UPLO=self.UPLO,
            target_partition=target_partition,
            min_target_depth=self.min_target_depth,
            min_source_depth=self.min_source_depth,
            block_tree_consistency=self.block_tree_consistency,
            partition_number_for_symmetry=self.partition_number_for_symmetry,
            source_partition=source_partition,
            admissibility=self.admissibility,
        )
        plan_time = time.perf_counter() - t0
        h = assemble_from_plan(
            plan,
            generator,
            max_rank=self.max_rank,
            reqrank=self.reqrank,
            compressor=self.compressor,
            recompress=self.recompress,
        )
        h.info["block_tree_walltime"] = plan_time
        return h


def build_hmatrix(
    generator: Generator,
    target_tree: ClusterTree,
    source_tree: ClusterTree | None = None,
    epsilon: float = 1e-6,
    eta: float = 10.0,
    symmetry: str = "N",
    UPLO: str = "N",
    **kwargs,
) -> HMatrix:
    """One-shot: plan + assemble (the ``HMatrixBuilder::build`` entry point)."""
    target_partition = kwargs.pop("target_partition", -1)
    return HMatrixBuilder(
        epsilon=epsilon, eta=eta, symmetry=symmetry, UPLO=UPLO, **kwargs
    ).build(generator, target_tree, source_tree, target_partition=target_partition)


def hmatrix_from_dense(
    A,
    tree: ClusterTree,
    target_partition: int = -1,
    source_partition: int = -1,
) -> HMatrix:
    """Wrap a DENSE (sub)matrix as a single-bucket HMatrix — the dense
    local-operator of the distributed layer
    (``implementations/global_to_local_operators/dense_matrix.hpp:9-45``):
    pass the result to :func:`~htool_tpu.parallel.distributed.
    build_distributed_from_local_hmatrices` to wire dense local operators
    into a distributed operator, or use it standalone.

    ``A`` is in CLUSTER numbering and spans the (partition-restricted)
    target/source ranges of ``tree``."""
    A = jnp.asarray(A)
    offs, sizes = tree.partition_offsets_sizes()
    t_off = int(offs[target_partition]) if target_partition >= 0 else 0
    t_size = int(sizes[target_partition]) if target_partition >= 0 else tree.n_points
    s_off = int(offs[source_partition]) if source_partition >= 0 else 0
    s_size = int(sizes[source_partition]) if source_partition >= 0 else tree.n_points
    if A.shape != (t_size, s_size):
        raise ValueError(
            f"dense block has shape {A.shape}, expected ({t_size}, {s_size})"
        )
    bm = max(8, -(-t_size // 8) * 8)
    bn = max(8, -(-s_size // 8) * 8)
    data = jnp.zeros((1, bm, bn), A.dtype).at[0, :t_size, :s_size].set(A)
    bucket = DenseBucket(
        data=data,
        t_off=jnp.asarray([t_off], jnp.int32),
        s_off=jnp.asarray([s_off], jnp.int32),
        t_sizes=np.array([t_size]),
        s_sizes=np.array([s_size]),
    )
    return HMatrix(
        shape=(t_size, tree.n_points),
        dense_buckets=[bucket],
        lr_buckets=[],
        perm_t=jnp.asarray(tree.permutation, jnp.int32),
        perm_s=jnp.asarray(tree.permutation, jnp.int32),
        t_root_off=t_off,
        info=dict(epsilon=0.0, eta=0.0, n_false_positive=0,
                  n_dense_blocks=1, n_low_rank_blocks=0),
    )
