"""Assembled-H-matrix post-processing: recompression and BLR conversion.

Two capabilities of the reference that act on an ALREADY-BUILT H-matrix:

- ``recompress_hmatrix``: apply SVD recompression over all low-rank leaves
  (reference ``hmatrix/utils/recompression.hpp:7-33`` — sequential/OpenMP
  loop over LR leaves; here one batched QR+SVD kernel per bucket).
- ``to_blr``: re-tile the adaptive flat H-matrix onto the uniform BLR grid
  so the factorization / compressed-product engine (``blr_lu``,
  ``blr_cholesky``, ``blr_matmul``) can consume the operator that was
  assembled — the batched counterpart of the reference calling
  ``lu_factorization(hmatrix)`` / ``internal_add_hmatrix_hmatrix_product``
  directly on the built tree (``hmatrix/linalg/factorization.hpp:19-79``,
  ``add_hmatrix_hmatrix_product.hpp:24-312``).  No generator re-evaluation:
  every BLR cell is produced from the stored dense / U·V leaf data
  (low-rank leaves restrict to row/col slices rank-free; sub-cell leaves
  densify their cell).

User-facing factorization wrappers (``lu_factorization``, ``lu_solve``,
``cholesky_factorization``, ``cholesky_solve``, ``hmatrix_hmatrix_product``)
mirror the reference's free-function surface
(``factorization.hpp:82,119,205,245,256,273``).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..clustering.cluster_tree import ClusterTree
from .blr import DENSE, LR, ZERO, BLRMatrix, _grid_cells, blr_cholesky, blr_lu, blr_matmul, blr_solve
from .blr2 import TwoLevelBLR, blr2_cholesky, blr2_lu, blr2_solve
from .compressors import batched_recompress
from .hmatrix import HMatrix, LowRankBucket
__all__ = [
    "recompress_hmatrix",
    "retile_blr",
    "permute_blr",
    "common_grid_blr",
    "to_blr",
    "to_blr2",
    "blr_to_hmatrix",
    "lu_factorization",
    "lu_solve",
    "cholesky_factorization",
    "cholesky_solve",
    "hmatrix_hmatrix_product",
]


# ======================================================================
# recompression over all LR leaves (recompression.hpp:7-33)
# ======================================================================


def recompress_hmatrix(h: HMatrix, epsilon: float) -> HMatrix:
    """SVD-recompress every low-rank leaf of an assembled H-matrix.

    One batched QR+SVD kernel per LR bucket (the reference loops leaves:
    ``hmatrix/utils/recompression.hpp:7-33``).  Rank padding shrinks to the
    power-of-two cover of the new max rank, so subsequent products move
    less data.  Returns a new ``HMatrix``; the input is unchanged.
    """
    new_lr = []
    for b in h.lr_buckets:
        ranks_dev = jnp.asarray(np.asarray(b.ranks), jnp.int32)
        U2, V2, nr = batched_recompress(b.U, b.V, ranks_dev, epsilon)
        nr_host = np.asarray(nr)
        rmax = int(nr_host.max()) if nr_host.size else 0
        pad = 8
        while pad < rmax:
            pad *= 2
        pad = min(pad, int(U2.shape[2]))
        new_lr.append(
            replace(
                b,
                U=U2[:, :, :pad],
                V=V2[:, :pad, :],
                ranks=nr_host,
            )
        )
    return replace(h, lr_buckets=new_lr)


# ======================================================================
# adaptive H  ->  uniform-grid BLR
# ======================================================================


def _cell_span(offs: np.ndarray, ends: np.ndarray, off: int, size: int):
    """Indices of grid cells intersecting [off, off+size)."""
    i0 = int(np.searchsorted(offs, off, side="right")) - 1
    i1 = int(np.searchsorted(offs, off + size - 1, side="right")) - 1
    return i0, i1


def to_blr(
    h: HMatrix,
    tree: ClusterTree,
    block_size: int = 256,
    R_half: Optional[int] = None,
    epsilon: Optional[float] = None,
) -> BLRMatrix:
    """Re-tile an assembled (square, non-partition-restricted) H-matrix onto
    the uniform BLR grid of ``tree`` without re-evaluating the generator.

    Per grid cell: if covered by a single low-rank leaf (or several whose
    ranks fit the LR buffer), restrict the stored U/V factors to the cell's
    row/col slices and recompress; otherwise densify the cell from the
    stored leaf data.  Symmetric/hermitian storage is expanded (mirror
    leaves contribute their transpose/conj-transpose on the upper triangle),
    since factorization needs full storage.

    PARTITION-RESTRICTED input (a device's local block-row,
    ``t_root_off > 0`` or ``m < n``): the square DIAGONAL block of the
    block-row — rows × the same index range of columns — is re-tiled, which
    is exactly what the DDM local solver factorizes (the reference's
    ``block_diagonal_hmatrix``, ``distributed_operator/utility.hpp:37-61``).
    """
    restricted = (
        h.shape[0] != h.shape[1] or h.t_root_off != 0 or h.s_root_off != 0
    )
    if restricted:
        if h.s_root_off != 0 or h.shape[1] != tree.n_points:
            raise ValueError(
                "restricted to_blr expects a block-row (full column range)"
            )
        r0, m = int(h.t_root_off), int(h.shape[0])
        if r0 + m > tree.n_points:
            raise ValueError("block-row exceeds the tree's index range")
    else:
        r0, m = 0, int(h.shape[0])
        if h.shape[0] != tree.n_points:
            raise ValueError(
                "tree does not match the H-matrix: to_blr must be given the "
                "cluster tree the matrix was assembled over "
                f"(h.shape[0]={h.shape[0]}, tree.n_points={tree.n_points})"
            )
    if not np.array_equal(np.asarray(h.perm_t), tree.permutation):
        raise ValueError("tree does not match the H-matrix (permutation)")
    if epsilon is None:
        epsilon = 1e-6

    cells, offs, szs, level = _grid_cells(tree, block_size)
    if restricted:
        keep = (offs >= r0) & (offs + szs <= r0 + m)
        if int(szs[keep].sum()) != m:
            raise ValueError(
                "grid cells do not align with the partition boundary; "
                "use a block_size at or below the partition size"
            )
        cells, offs, szs = cells[keep], offs[keep], szs[keep]
    nL = len(cells)
    ends = offs + szs
    b = max(8, int(-(-int(szs.max()) // 8) * 8))
    dtype = np.dtype(h.dtype)

    herm = h.symmetry == "H"

    # ---- collect contributions per cell pair ------------------------------
    # contrib: (kind, payload); kind 'D' -> dense ndarray slice placed at
    # (r0, c0) local offsets; kind 'LR' -> (Ur, Vc) restricted factors.
    contribs: dict = {}

    def add(ci, cj, item):
        contribs.setdefault((ci, cj), []).append(item)

    def scatter_block(t_off, t_size, s_off, s_size, get_dense, get_lr, is_lr):
        # restricted mode: only the diagonal square [r0, r0+m)^2 is kept —
        # clip the leaf's ranges to it (leaves of a block-row span all
        # columns) and drop what falls outside
        lo, hi = r0, r0 + m
        rt_lo, rt_hi = max(t_off, lo), min(t_off + t_size, hi)
        rs_lo, rs_hi = max(s_off, lo), min(s_off + s_size, hi)
        if rt_lo >= rt_hi or rs_lo >= rs_hi:
            return
        ti0, ti1 = _cell_span(offs, ends, rt_lo, rt_hi - rt_lo)
        tj0, tj1 = _cell_span(offs, ends, rs_lo, rs_hi - rs_lo)
        for ci in range(ti0, ti1 + 1):
            r_lo = max(rt_lo, int(offs[ci]))
            r_hi = min(rt_hi, int(ends[ci]))
            for cj in range(tj0, tj1 + 1):
                c_lo = max(rs_lo, int(offs[cj]))
                c_hi = min(rs_hi, int(ends[cj]))
                # slice within the leaf / placement within the cell
                sl_r = slice(r_lo - t_off, r_hi - t_off)
                sl_c = slice(c_lo - s_off, c_hi - s_off)
                at = (r_lo - int(offs[ci]), c_lo - int(offs[cj]))
                if is_lr:
                    add(ci, cj, ("LR", get_lr(sl_r, sl_c), at))
                else:
                    add(ci, cj, ("D", get_dense(sl_r, sl_c), at))

    for bk in h.dense_buckets:
        data = np.asarray(bk.data)
        t_off = np.asarray(bk.t_off)
        s_off = np.asarray(bk.s_off)
        for q in range(bk.n_blocks):
            ts, ss = int(bk.t_sizes[q]), int(bk.s_sizes[q])
            blk = data[q, :ts, :ss]
            scatter_block(
                int(t_off[q]), ts, int(s_off[q]), ss,
                lambda r, c, blk=blk: blk[r, c], None, False,
            )
            if bk.mirror:
                mb = np.conj(blk.T) if herm else blk.T
                scatter_block(
                    int(s_off[q]), ss, int(t_off[q]), ts,
                    lambda r, c, mb=mb: mb[r, c], None, False,
                )

    for bk in h.lr_buckets:
        U = np.asarray(bk.U)
        V = np.asarray(bk.V)
        t_off = np.asarray(bk.t_off)
        s_off = np.asarray(bk.s_off)
        rks = np.asarray(bk.ranks)
        for q in range(bk.n_blocks):
            ts, ss, r = int(bk.t_sizes[q]), int(bk.s_sizes[q]), int(rks[q])
            Uq = U[q, :ts, :r]
            Vq = V[q, :r, :ss]
            scatter_block(
                int(t_off[q]), ts, int(s_off[q]), ss,
                None, lambda rr, cc, Uq=Uq, Vq=Vq: (Uq[rr], Vq[:, cc]), True,
            )
            if bk.mirror:
                Um = np.conj(Vq.T) if herm else Vq.T
                Vm = np.conj(Uq.T) if herm else Uq.T
                scatter_block(
                    int(s_off[q]), ss, int(t_off[q]), ts,
                    None, lambda rr, cc, Um=Um, Vm=Vm: (Um[rr], Vm[:, cc]), True,
                )

    # restricted block: local cell offsets + the partition's permutation
    # slice, so the result is a self-contained square BLR on [0, m)
    return _assemble_blr_cells(
        contribs, offs - r0, szs, b, R_half, float(epsilon), dtype,
        tree.permutation[r0 : r0 + m],
        dict(level=level, n_cells=nL, from_hmatrix=True, row_offset=r0),
    )


def _assemble_blr_cells(
    contribs, offs, szs, b, R_half, epsilon, dtype, perm, info
) -> BLRMatrix:
    """Assemble a BLRMatrix from per-cell contribution lists.

    ``contribs[(ci, cj)]`` is a list of ``("D", block, (r0, c0))`` dense
    placements and ``("LR", (Ur, Vr), (r0, c0))`` restricted low-rank
    factors; shared by :func:`to_blr` (H-matrix leaves) and
    :func:`retile_blr` (cells of another grid)."""
    nL = offs.shape[0]
    ends = offs + szs

    def lr_total_rank(items):
        return sum(p[0].shape[1] for k, p, _ in items if k == "LR")

    if R_half is None:
        cand = [
            lr_total_rank(items)
            for items in contribs.values()
            if all(k == "LR" for k, _, _ in items)
        ]
        rmax = max(cand, default=16)
        R_half = 8
        while R_half < rmax:
            R_half *= 2
        R_half = max(16, min(R_half, b // 2))
    # same alignment invariant as build_blr: multiple of 8, at most b//2
    R_half = max(8, min(int(R_half), b // 2))
    R_half = int(-(-R_half // 8) * 8)
    R_buf = 2 * R_half

    cls = np.zeros((nL, nL), np.int8)
    dense_slot = np.full((nL, nL), -1, np.int32)
    lr_slot = np.full((nL, nL), -1, np.int32)
    D_list, U_list, V_list, rank_list = [], [], [], []

    for (ci, cj), items in sorted(contribs.items()):
        all_lr = all(k == "LR" for k, _, _ in items)
        if all_lr and lr_total_rank(items) <= R_half:
            Uc = np.zeros((b, R_buf), dtype)
            Vc = np.zeros((R_buf, b), dtype)
            pos = 0
            for _, (Ur, Vr), (r0, c0) in items:
                r = Ur.shape[1]
                Uc[r0 : r0 + Ur.shape[0], pos : pos + r] = Ur
                Vc[pos : pos + r, c0 : c0 + Vr.shape[1]] = Vr
                pos += r
            cls[ci, cj] = LR
            lr_slot[ci, cj] = len(U_list)
            U_list.append(Uc)
            V_list.append(Vc)
            rank_list.append(pos)
        else:
            Dc = np.zeros((b, b), dtype)
            for k, p, (r0, c0) in items:
                if k == "D":
                    blk = p
                else:
                    Ur, Vr = p
                    blk = Ur @ Vr
                Dc[r0 : r0 + blk.shape[0], c0 : c0 + blk.shape[1]] += blk
            if ci == cj and int(szs[ci]) < b:
                idx = np.arange(int(szs[ci]), b)
                Dc[idx, idx] = 1.0  # keep padded diagonal invertible
            cls[ci, cj] = DENSE
            dense_slot[ci, cj] = len(D_list)
            D_list.append(Dc)

    nd, nl = len(D_list), len(U_list)
    D = jnp.asarray(
        np.concatenate([np.stack(D_list) if nd else np.zeros((0, b, b), dtype), np.zeros((1, b, b), dtype)])
    )
    U = jnp.asarray(
        np.concatenate([np.stack(U_list) if nl else np.zeros((0, b, R_buf), dtype), np.zeros((1, b, R_buf), dtype)])
    )
    V = jnp.asarray(
        np.concatenate([np.stack(V_list) if nl else np.zeros((0, R_buf, b), dtype), np.zeros((1, R_buf, b), dtype)])
    )
    ranks = jnp.asarray(np.array(rank_list + [0], np.int32))

    # tighten: one batched recompression over all LR cells
    if nl:
        U2, V2, nr = batched_recompress(U[:-1], V[:-1], ranks[:-1], epsilon)
        U = jnp.concatenate([U2, U[-1:]])
        V = jnp.concatenate([V2, V[-1:]])
        ranks = jnp.concatenate([nr, ranks[-1:]])

    return BLRMatrix(
        n=int(szs.sum()),
        cell_off=offs,
        cell_size=szs,
        b=b,
        cls=cls,
        dense_slot=dense_slot,
        lr_slot=lr_slot,
        D=D,
        U=U,
        V=V,
        ranks=ranks,
        R_half=R_half,
        epsilon=float(epsilon),
        permutation=perm,
        info=info,
    )


def retile_blr(
    X: BLRMatrix,
    cell_off: np.ndarray,
    cell_size: np.ndarray,
    b: Optional[int] = None,
    R_half: Optional[int] = None,
    epsilon: Optional[float] = None,
) -> BLRMatrix:
    """Re-tile a BLR matrix onto a new uniform grid (offsets/sizes tiling
    the same [0, n)) without re-evaluating anything: dense cells are copied
    slice-wise, low-rank cells restrict their U/V factors, and each target
    cell recompresses once.

    This is the mechanism behind mixed-grid compressed products/solves —
    the reference handles inconsistent trees by recursion-time splitting
    (``add_hmatrix_hmatrix_product.hpp:31-74``); on the flat layout the
    equivalent is an explicit re-tile onto a common grid."""
    cell_off = np.asarray(cell_off, np.int64)
    cell_size = np.asarray(cell_size, np.int64)
    if int(cell_size.sum()) != X.n:
        raise ValueError(
            f"target grid covers {int(cell_size.sum())} rows, matrix has {X.n}"
        )
    if b is None:
        b = max(8, int(-(-int(cell_size.max()) // 8) * 8))
    ends = cell_off + cell_size
    dtype = np.dtype(X.dtype)
    contribs: dict = {}

    def add(ci, cj, item):
        contribs.setdefault((ci, cj), []).append(item)

    def scatter(t_off, t_size, s_off, s_size, get_dense, get_lr, is_lr):
        ti0, ti1 = _cell_span(cell_off, ends, t_off, t_size)
        tj0, tj1 = _cell_span(cell_off, ends, s_off, s_size)
        for ci in range(ti0, ti1 + 1):
            r_lo = max(t_off, int(cell_off[ci]))
            r_hi = min(t_off + t_size, int(ends[ci]))
            for cj in range(tj0, tj1 + 1):
                c_lo = max(s_off, int(cell_off[cj]))
                c_hi = min(s_off + s_size, int(ends[cj]))
                sl_r = slice(r_lo - t_off, r_hi - t_off)
                sl_c = slice(c_lo - s_off, c_hi - s_off)
                at = (r_lo - int(cell_off[ci]), c_lo - int(cell_off[cj]))
                if is_lr:
                    add(ci, cj, ("LR", get_lr(sl_r, sl_c), at))
                else:
                    add(ci, cj, ("D", get_dense(sl_r, sl_c), at))

    Dh = np.asarray(X.D)
    Uh = np.asarray(X.U)
    Vh = np.asarray(X.V)
    rk = np.asarray(X.ranks)
    for i in range(X.nL):
        oi, si = int(X.cell_off[i]), int(X.cell_size[i])
        for j in range(X.nL):
            oj, sj = int(X.cell_off[j]), int(X.cell_size[j])
            c = X.cls[i, j]
            if c == ZERO:
                continue
            if c == DENSE:
                blk = Dh[X.dense_slot[i, j], :si, :sj]
                scatter(oi, si, oj, sj,
                        lambda r, cc, blk=blk: blk[r, cc], None, False)
            else:
                s = X.lr_slot[i, j]
                r = int(rk[s])
                Uq, Vq = Uh[s, :si, :r], Vh[s, :r, :sj]
                scatter(oi, si, oj, sj, None,
                        lambda rr, cc, Uq=Uq, Vq=Vq: (Uq[rr], Vq[:, cc]), True)

    eps = X.epsilon if epsilon is None else float(epsilon)
    info = dict(X.info)
    info.update(n_cells=int(cell_off.shape[0]), retiled=True)
    return _assemble_blr_cells(
        contribs, cell_off, cell_size, b, R_half, eps, dtype,
        X.permutation, info,
    )


def permute_blr(
    X: BLRMatrix,
    q: np.ndarray,
    cell_off: np.ndarray,
    cell_size: np.ndarray,
    b: Optional[int] = None,
    epsilon: Optional[float] = None,
    R_half: Optional[int] = None,
    permutation: Optional[np.ndarray] = None,
) -> BLRMatrix:
    """Re-express a BLR matrix under an index permutation onto a new grid:
    ``X'[q[i], q[j]] = X[i, j]``.

    This is the mixed-CLUSTER-TREE mechanism: operands assembled over
    different trees live in different cluster numberings related by a
    permutation; the reference's H×H product splits recursion until the
    trees align (``add_hmatrix_hmatrix_product.hpp:31-74``), and the flat
    equivalent re-tiles one operand into the other tree's numbering.  The
    slab walk evaluates ``b`` permuted rows at a time from the stored
    cells (no generator re-evaluation) and compresses each target cell by
    batched SVD at ``epsilon`` (dense when not advantageous) —
    O(n²/b·compressed) work, O(n·b) transient memory."""
    q = np.asarray(q, np.int64)
    if q.shape[0] != X.n:
        raise ValueError(f"permutation has {q.shape[0]} entries, matrix {X.n}")
    cell_off = np.asarray(cell_off, np.int64)
    cell_size = np.asarray(cell_size, np.int64)
    if int(cell_size.sum()) != X.n:
        raise ValueError(
            f"target grid covers {int(cell_size.sum())} rows, matrix has {X.n}"
        )
    if b is None:
        b = max(8, int(-(-int(cell_size.max()) // 8) * 8))
    qinv = np.argsort(q)
    dtype = np.dtype(X.dtype)
    eps = X.epsilon if epsilon is None else float(epsilon)
    if R_half is None:
        # storage width is 2*R_half per LR cell: b//4 keeps an LR cell at
        # most half the dense cell footprint
        R_half = max(8, int(-(-(b // 4) // 8) * 8))

    Dh = np.asarray(X.D)
    Uh = np.asarray(X.U)
    Vh = np.asarray(X.V)
    rk = np.asarray(X.ranks)
    src_off = np.asarray(X.cell_off, np.int64)
    src_end = src_off + np.asarray(X.cell_size, np.int64)

    def gather_rows(rows):
        """Dense slab X[rows, :] from the stored cells (src numbering)."""
        S = np.zeros((rows.shape[0], X.n), dtype)
        ci = np.searchsorted(src_end, rows, side="right")
        for i in np.unique(ci):
            sel = np.nonzero(ci == i)[0]
            loc = rows[sel] - src_off[i]
            for j in range(X.nL):
                c = X.cls[i, j]
                if c == ZERO:
                    continue
                oj, sj = int(src_off[j]), int(src_end[j] - src_off[j])
                if c == DENSE:
                    S[sel, oj : oj + sj] = Dh[X.dense_slot[i, j]][loc, :sj]
                else:
                    s = X.lr_slot[i, j]
                    r = int(rk[s])
                    S[sel, oj : oj + sj] = Uh[s][loc, :r] @ Vh[s, :r, :sj]
        return S

    nL = cell_off.shape[0]
    contribs: dict = {}
    for I in range(nL):
        oI, sI = int(cell_off[I]), int(cell_size[I])
        S = gather_rows(qinv[oI : oI + sI])[:, qinv]  # target numbering
        # classify this block-row's cells: batched SVD, trailing-energy rank
        blocks = [
            S[:, int(cell_off[J]) : int(cell_off[J] + cell_size[J])]
            for J in range(nL)
        ]
        wid = max(blk.shape[1] for blk in blocks)
        stack = np.zeros((nL, sI, wid), dtype)
        for J, blk in enumerate(blocks):
            stack[J, :, : blk.shape[1]] = blk
        Us, sv, Vts = np.linalg.svd(stack, full_matrices=False)
        tail = np.sqrt(
            np.maximum(np.cumsum(sv[:, ::-1] ** 2, axis=1)[:, ::-1], 0.0)
        )
        total = np.maximum(tail[:, 0], 1e-300)
        for J, blk in enumerate(blocks):
            # smallest rank with trailing energy below eps (SVD_truncation.hpp:14-55)
            keep = np.nonzero(tail[J] <= eps * total[J])[0]
            r = int(keep[0]) if keep.size else sv.shape[1]
            if 0 < r <= R_half and r * (sI + blk.shape[1]) < sI * blk.shape[1]:
                Ur = (Us[J, :, :r] * sv[J, :r][None, :]).astype(dtype)
                Vr = Vts[J, :r, : blk.shape[1]].astype(dtype)
                contribs.setdefault((I, J), []).append(("LR", (Ur, Vr), (0, 0)))
            elif np.any(blk):
                contribs.setdefault((I, J), []).append(("D", blk, (0, 0)))

    info = dict(X.info)
    info.update(n_cells=nL, permuted=True)
    perm = X.permutation if permutation is None else permutation
    return _assemble_blr_cells(
        contribs, cell_off, cell_size, b, R_half, eps, dtype, perm, info
    )


def common_grid_blr(A: BLRMatrix, B: BLRMatrix):
    """Bring two BLR operands onto a common grid (the coarser of the two —
    larger cells keep the re-tile lossless and the cell count low).
    Returns (A', B') sharing cell_off/cell_size/b."""
    if A.n != B.n:
        raise ValueError(f"operand sizes differ: {A.n} vs {B.n}")
    if (
        A.nL == B.nL
        and A.b == B.b
        and np.array_equal(np.asarray(A.cell_off), np.asarray(B.cell_off))
    ):
        return A, B
    # the coarser grid = fewer cells
    ref = A if A.nL <= B.nL else B
    offs = np.asarray(ref.cell_off)
    szs = np.asarray(ref.cell_size)
    Ar = A if ref is A else retile_blr(A, offs, szs, b=ref.b)
    Br = B if ref is B else retile_blr(B, offs, szs, b=ref.b)
    return Ar, Br


# ======================================================================
# adaptive H  ->  two-level (coarse-panel) BLR
# ======================================================================


def to_blr2(
    h: HMatrix,
    tree: ClusterTree,
    coarse_size: int = 4096,
    R: Optional[int] = None,
    epsilon: Optional[float] = None,
    max_group_elems: int = 1 << 26,
) -> TwoLevelBLR:
    """Re-tile an assembled (square, non-restricted) H-matrix onto coarse
    panels for the hierarchical factorization — no generator re-evaluation.

    Each off-diagonal panel pair stacks the restrictions of every leaf it
    intersects into one wide low-rank factor (dense leaves enter exactly at
    rank ``min(m, n)``), then one batched QR+SVD re-truncation per stacked
    width collapses it to the panel rank.  The diagonal panels are densified
    (``diag_mode='dense'`` — the fast factorization mode).  This is the
    conversion feeding ``lu_factorization`` / ``cholesky_factorization``,
    the counterpart of the reference recursing directly over the assembled
    tree (``hmatrix/linalg/factorization.hpp:19-79``)."""
    if h.shape[0] != h.shape[1] or h.t_root_off != 0 or h.s_root_off != 0:
        raise ValueError("to_blr2 needs a square, non-restricted H-matrix")
    if h.shape[0] != tree.n_points or not np.array_equal(
        np.asarray(h.perm_t), tree.permutation
    ):
        raise ValueError("tree does not match the H-matrix")
    if epsilon is None:
        epsilon = 1e-6

    cells, offs, szs, level = _grid_cells(tree, coarse_size)
    nC = len(cells)
    if nC < 2:
        raise ValueError(
            f"coarse_size={coarse_size} yields {nC} panel(s); use to_blr"
        )
    ends = offs + szs
    P = max(8, int(-(-int(szs.max()) // 8) * 8))
    dtype = np.dtype(h.dtype)
    itemsize = dtype.itemsize
    herm = h.symmetry == "H"

    Dd = np.zeros((nC, P, P), dtype)
    contribs: dict = {}

    def add(ci, cj, item):
        contribs.setdefault((ci, cj), []).append(item)

    def scatter_block(t_off, t_size, s_off, s_size, get_dense, get_lr, is_lr):
        ti0 = int(np.searchsorted(offs, t_off, side="right")) - 1
        ti1 = int(np.searchsorted(offs, t_off + t_size - 1, side="right")) - 1
        tj0 = int(np.searchsorted(offs, s_off, side="right")) - 1
        tj1 = int(np.searchsorted(offs, s_off + s_size - 1, side="right")) - 1
        for ci in range(ti0, ti1 + 1):
            r_lo = max(t_off, int(offs[ci]))
            r_hi = min(t_off + t_size, int(ends[ci]))
            for cj in range(tj0, tj1 + 1):
                c_lo = max(s_off, int(offs[cj]))
                c_hi = min(s_off + s_size, int(ends[cj]))
                sl_r = slice(r_lo - t_off, r_hi - t_off)
                sl_c = slice(c_lo - s_off, c_hi - s_off)
                at = (r_lo - int(offs[ci]), c_lo - int(offs[cj]))
                if ci == cj:
                    # diagonal panel: densify in place
                    if is_lr:
                        Ur, Vr = get_lr(sl_r, sl_c)
                        blk = np.asarray(Ur @ Vr)
                    else:
                        blk = get_dense(sl_r, sl_c)
                    Dd[ci, at[0] : at[0] + blk.shape[0], at[1] : at[1] + blk.shape[1]] += blk
                elif is_lr:
                    add(ci, cj, ("LR", get_lr(sl_r, sl_c), at))
                else:
                    add(ci, cj, ("D", get_dense(sl_r, sl_c), at))

    for bk in h.dense_buckets:
        data = np.asarray(bk.data)
        t_off = np.asarray(bk.t_off)
        s_off = np.asarray(bk.s_off)
        for q in range(bk.n_blocks):
            ts, ss = int(bk.t_sizes[q]), int(bk.s_sizes[q])
            blk = data[q, :ts, :ss]
            scatter_block(int(t_off[q]), ts, int(s_off[q]), ss,
                          lambda r, c, blk=blk: blk[r, c], None, False)
            if bk.mirror:
                mb = np.conj(blk.T) if herm else blk.T
                scatter_block(int(s_off[q]), ss, int(t_off[q]), ts,
                              lambda r, c, mb=mb: mb[r, c], None, False)

    for bk in h.lr_buckets:
        U = np.asarray(bk.U)
        V = np.asarray(bk.V)
        t_off = np.asarray(bk.t_off)
        s_off = np.asarray(bk.s_off)
        rks = np.asarray(bk.ranks)
        for q in range(bk.n_blocks):
            ts, ss, r = int(bk.t_sizes[q]), int(bk.s_sizes[q]), int(rks[q])
            Uq, Vq = U[q, :ts, :r], V[q, :r, :ss]
            scatter_block(int(t_off[q]), ts, int(s_off[q]), ss,
                          None, lambda rr, cc, Uq=Uq, Vq=Vq: (Uq[rr], Vq[:, cc]), True)
            if bk.mirror:
                Um = np.conj(Vq.T) if herm else Vq.T
                Vm = np.conj(Uq.T) if herm else Uq.T
                scatter_block(int(s_off[q]), ss, int(t_off[q]), ts,
                              None, lambda rr, cc, Um=Um, Vm=Vm: (Um[rr], Vm[:, cc]), True)

    # identity on diag padding rows (keeps the panel LU well-posed)
    for I in range(nC):
        if int(szs[I]) < P:
            ix = np.arange(int(szs[I]), P)
            Dd[I, ix, ix] = 1.0

    # ---- stack each off-diagonal pair into one wide factor ----------------
    def _pow2(n, lo=8):
        p = lo
        while p < n:
            p *= 2
        return p

    pair_keys = sorted(contribs.keys())
    widths = {}
    for key in pair_keys:
        w = 0
        for k, p, _ in contribs[key]:
            w += p[0].shape[1] if k == "LR" else min(p.shape)
        widths[key] = w

    # group by pow2-padded width; chunk groups to bound device memory
    groups: dict = {}
    for key in pair_keys:
        groups.setdefault(_pow2(max(widths[key], 1)), []).append(key)

    stacked: dict = {}
    for w_pad, keys in groups.items():
        per = max(1, max_group_elems // (P * w_pad))
        for c0 in range(0, len(keys), per):
            sel = keys[c0 : c0 + per]
            Us = np.zeros((len(sel), P, w_pad), dtype)
            Vs = np.zeros((len(sel), w_pad, P), dtype)
            rk = np.zeros((len(sel),), np.int32)
            for t, key in enumerate(sel):
                pos = 0
                for k, p, (r0, c0_) in contribs[key]:
                    if k == "LR":
                        Ur, Vr = p
                        r = Ur.shape[1]
                        Us[t, r0 : r0 + Ur.shape[0], pos : pos + r] = Ur
                        Vs[t, pos : pos + r, c0_ : c0_ + Vr.shape[1]] = Vr
                    else:
                        m, n = p.shape
                        if m <= n:
                            r = m
                            Us[t, r0 : r0 + m, pos : pos + m] = np.eye(m, dtype=dtype)
                            Vs[t, pos : pos + m, c0_ : c0_ + n] = p
                        else:
                            r = n
                            Us[t, r0 : r0 + m, pos : pos + n] = p
                            Vs[t, pos : pos + n, c0_ : c0_ + n] = np.eye(n, dtype=dtype)
                    pos += r
                rk[t] = pos
            U2, V2, nr = batched_recompress(
                jnp.asarray(Us), jnp.asarray(Vs), jnp.asarray(rk), epsilon
            )
            nr = np.asarray(nr)
            U2 = np.asarray(U2)
            V2 = np.asarray(V2)
            for t, key in enumerate(sel):
                stacked[key] = (U2[t], V2[t], int(nr[t]))

    rmax = max((r for _, _, r in stacked.values()), default=8)
    if R is None:
        R = _pow2(max(8, rmax))
    R = int(_pow2(max(8, R)))
    n_capped = sum(1 for _, _, r in stacked.values() if r > R)

    pU = np.zeros((nC, nC, P, R), dtype)
    pV = np.zeros((nC, nC, R, P), dtype)
    pRank = np.zeros((nC, nC), np.int32)
    for (I, J), (Ut, Vt, r) in stacked.items():
        rc = min(r, R)
        w = min(R, Ut.shape[1])
        pU[I, J, :, :w] = Ut[:, :w]
        pV[I, J, :w, :] = Vt[:w, :]
        if rc < R:
            pU[I, J, :, rc:] = 0
            pV[I, J, rc:, :] = 0
        pRank[I, J] = rc

    return TwoLevelBLR(
        n=tree.n_points,
        panel_off=offs,
        panel_size=szs,
        P=P,
        diag_mode="dense",
        pU=jnp.asarray(pU),
        pV=jnp.asarray(pV),
        pRank=jnp.asarray(pRank),
        Dd=jnp.asarray(Dd),
        R=R,
        epsilon=float(epsilon),
        permutation=tree.permutation,
        info=dict(
            n_panels=nC,
            coarse_level=level,
            panel_rank_cap=R,
            n_rank_capped_pairs=n_capped,
            from_hmatrix=True,
        ),
    )


# ======================================================================
# user-facing factorization surface (factorization.hpp:82-290)
# ======================================================================

#: problem size above which ``method='auto'`` picks the hierarchical
#: (two-level) factorization over the flat one-level BLR.
_BLR2_AUTO_THRESHOLD = 8192


def _pick_method(h: HMatrix, method: str) -> str:
    if method == "auto":
        return "blr2" if h.shape[0] > _BLR2_AUTO_THRESHOLD else "blr"
    if method not in ("blr", "blr2"):
        raise ValueError(f"method must be 'auto', 'blr' or 'blr2', got {method!r}")
    return method


def lu_factorization(
    h: HMatrix,
    tree: ClusterTree,
    epsilon: Optional[float] = None,
    block_size: int = 256,
    method: str = "auto",
    coarse_size: int = 4096,
):
    """Compressed LU of an assembled H-matrix
    (reference ``lu_factorization``, ``hmatrix/linalg/factorization.hpp:82``).

    ``method='blr'`` factorizes on the flat one-level grid; ``'blr2'`` on
    coarse panels (hierarchical — the reference's recursive asymptotics);
    ``'auto'`` picks by problem size.  Returns a factorized
    :class:`BLRMatrix` or :class:`TwoLevelBLR`; solve with :func:`lu_solve`."""
    m = _pick_method(h, method)
    if m == "blr2":
        return blr2_lu(to_blr2(h, tree, coarse_size=coarse_size, epsilon=epsilon))
    return blr_lu(to_blr(h, tree, block_size=block_size, epsilon=epsilon), epsilon)


def cholesky_factorization(
    h: HMatrix,
    tree: ClusterTree,
    epsilon: Optional[float] = None,
    block_size: int = 256,
    method: str = "auto",
    coarse_size: int = 4096,
):
    """Compressed Cholesky of an assembled H-matrix
    (reference ``cholesky_factorization``, ``factorization.hpp:205``)."""
    m = _pick_method(h, method)
    if m == "blr2":
        return blr2_cholesky(to_blr2(h, tree, coarse_size=coarse_size, epsilon=epsilon))
    return blr_cholesky(to_blr(h, tree, block_size=block_size, epsilon=epsilon), epsilon)


def lu_solve(F, rhs, user_numbering: bool = True, trans: str = "N"):
    """Solve op(A) x = rhs with a compressed LU (reference ``lu_solve``,
    ``factorization.hpp:256``), trans ∈ {'N','T','C'}.  Accepts a factorized
    :class:`BLRMatrix` or :class:`TwoLevelBLR`."""
    if not (F.factorized and F.kind == "lu"):
        raise ValueError("lu_solve needs an LU-factorized matrix")
    if trans not in ("N", "T", "C"):
        raise ValueError("trans must be 'N', 'T' or 'C'")
    if isinstance(F, TwoLevelBLR):
        return blr2_solve(F, rhs, user_numbering=user_numbering, trans=trans)
    return blr_solve(F, rhs, user_numbering=user_numbering, trans=trans)


def cholesky_solve(F, rhs, user_numbering: bool = True, UPLO: str = "L"):
    """Solve with a compressed Cholesky (reference ``cholesky_solve``,
    ``factorization.hpp:273``).  Storage is canonical lower (A = L·L^H); the
    UPLO argument mirrors the reference surface — for a hermitian matrix the
    'U' factorization solves the same system, so both values are accepted."""
    if not (F.factorized and F.kind == "chol"):
        raise ValueError("cholesky_solve needs a Cholesky-factorized matrix")
    if UPLO not in ("L", "U"):
        raise ValueError("UPLO must be 'L' or 'U'")
    if isinstance(F, TwoLevelBLR):
        return blr2_solve(F, rhs, user_numbering=user_numbering)
    return blr_solve(F, rhs, user_numbering=user_numbering)


def blr_to_hmatrix(B: BLRMatrix, tree: Optional[ClusterTree] = None) -> HMatrix:
    """Re-export a (non-factorized) uniform-grid BLR matrix as a bucketed
    :class:`HMatrix`, closing the product loop: the result of
    :func:`hmatrix_hmatrix_product` (a ``BLRMatrix``) re-enters the
    bucketed matvec and the npz persistence surface — the counterpart of
    the reference writing an H×H product back into an
    ``HMatrix`` (``add_hmatrix_hmatrix_product.hpp:210``).

    One dense bucket (all dense cells) and one low-rank bucket (all LR
    cells); cell padding rows/cols are zeroed (including the invertibility
    identity on padded diagonal rows) to restore the bucket invariant
    "padded entries are exact zeros"."""
    if B.factorized:
        raise ValueError("blr_to_hmatrix expects an unfactorized matrix "
                         "(factors are not an operator)")
    from .hmatrix import DenseBucket
    n, b, nL = B.n, B.b, B.nL
    perm = B.permutation if B.permutation is not None else (
        tree.permutation if tree is not None else np.arange(n)
    )
    perm_dev = jnp.asarray(np.asarray(perm), jnp.int32)
    szs = np.asarray(B.cell_size, np.int64)
    offs = np.asarray(B.cell_off, np.int64)
    ar = np.arange(b)

    dense_buckets, lr_buckets = [], []
    di, dj = np.nonzero(B.cls == DENSE)
    if di.size:
        slots = jnp.asarray(B.dense_slot[di, dj], jnp.int32)
        rmask = jnp.asarray(ar[None, :] < szs[di][:, None])
        cmask = jnp.asarray(ar[None, :] < szs[dj][:, None])
        data = B.D[slots] * (rmask[:, :, None] & cmask[:, None, :]).astype(B.dtype)
        dense_buckets.append(DenseBucket(
            data=data,
            t_off=jnp.asarray(offs[di], jnp.int32),
            s_off=jnp.asarray(offs[dj], jnp.int32),
            t_sizes=szs[di], s_sizes=szs[dj],
        ))
    li, lj = np.nonzero(B.cls == LR)
    if li.size:
        slots = jnp.asarray(B.lr_slot[li, lj], jnp.int32)
        rk = np.asarray(B.ranks)[B.lr_slot[li, lj]]
        rmax = int(rk.max()) if rk.size else 0
        pad = 8
        while pad < rmax:
            pad *= 2
        pad = min(pad, B.R_buf)
        keep = jnp.asarray(np.arange(pad)[None, :] < rk[:, None])
        U = B.U[slots][:, :, :pad] * keep[:, None, :].astype(B.dtype)
        V = B.V[slots][:, :pad, :] * keep[:, :, None].astype(B.dtype)
        lr_buckets.append(LowRankBucket(
            U=U, V=V,
            t_off=jnp.asarray(offs[li], jnp.int32),
            s_off=jnp.asarray(offs[lj], jnp.int32),
            t_sizes=szs[li], s_sizes=szs[lj],
            ranks=rk.astype(np.int64),
        ))
    return HMatrix(
        shape=(n, n),
        dense_buckets=dense_buckets,
        lr_buckets=lr_buckets,
        perm_t=perm_dev,
        perm_s=perm_dev,
        symmetry="N",
        info=dict(B.info, from_blr=True),
    )


def hmatrix_hmatrix_product(
    A: HMatrix,
    B: HMatrix,
    tree: ClusterTree,
    epsilon: Optional[float] = None,
    block_size: int = 256,
    tree_b: Optional[ClusterTree] = None,
) -> BLRMatrix:
    """Compressed product of two assembled H-matrices (reference
    ``internal_add_hmatrix_hmatrix_product`` → HMatrix,
    ``hmatrix/linalg/add_hmatrix_hmatrix_product.hpp:210``).

    ``tree`` is A's cluster tree; pass ``tree_b`` when B was assembled over
    a DIFFERENT tree — B is then re-expressed in A's cluster numbering via
    :func:`permute_blr` before the compressed product (the reference
    handles inconsistent trees by recursion-time splitting,
    ``add_hmatrix_hmatrix_product.hpp:31-74``).  The result lives on A's
    tree/grid in either case."""
    Fa = to_blr(A, tree, block_size=block_size, epsilon=epsilon)
    if tree_b is not None and not np.array_equal(
        np.asarray(tree_b.permutation), np.asarray(tree.permutation)
    ):
        Fb = to_blr(B, tree_b, block_size=block_size, epsilon=epsilon)
        # numbering map: tree_b cluster index -> tree cluster index
        q = np.argsort(np.asarray(tree.permutation))[
            np.asarray(tree_b.permutation)
        ]
        Fb = permute_blr(
            Fb,
            q,
            np.asarray(Fa.cell_off),
            np.asarray(Fa.cell_size),
            b=Fa.b,
            epsilon=epsilon,
            permutation=Fa.permutation,
        )
    else:
        Fb = to_blr(B, tree_b or tree, block_size=block_size, epsilon=epsilon)
    return blr_matmul(Fa, Fb, epsilon)
