"""Two-level (hierarchical) block low-rank factorization — production.

Batched re-design of the reference's recursive H-LU/H-Cholesky
(``hmatrix/linalg/factorization.hpp:19-79`` LU, ``:131-205`` Cholesky,
task-parallel variant ``task_based_factorization.hpp:33-213``).  The
reference recurses over the block tree with per-node dynamic ranks; here
the hierarchy has exactly two levels, each a batched device program:

- **level 1 — coarse panels** (cluster-tree nodes at the ``coarse_size``
  level): every off-diagonal panel pair is stored as ONE low-rank factor
  ``U_IJ [P, R] · V_IJ [R, P]`` under *weak admissibility* (even touching
  neighbors — measured panel ranks on the 100k sphere at ε=1e-4: ~86 for
  nearest neighbors, ~8 far field), assembled by one chunked batched ACA
  over all pairs;
- **level 2 — the diagonal panels**, either stacked dense ``[nC, P, P]``
  (fast mode: one vmapped LAPACK-style LU/Cholesky per step, exact dense
  Schur absorption) or per-panel one-level BLR matrices over the global
  tree's finer level (memory-lean mode for large N, reusing
  :func:`..hmatrix.blr.blr_lu` / ``blr_cholesky``).

The right-looking panel factorization

    for K:  factor diag_K;  V_IK <- V_IK·U_K⁻¹;  U_KJ <- L_K⁻¹·P_Kᵀ·U_KJ;
            A_IJ -= (U_IK V_IK)(U_KJ V_KJ)   (fused low-rank add+truncate)

executes as O(nC) batched device kernels per step: the Schur update over
all trailing pairs is ONE gather + einsum + batched QR/SVD re-truncation
(the truncated LR+LR addition of ``add_lrmat_lrmat.hpp:14-108``), with the
active pair set padded to powers of two so the number of distinct compiled
shapes stays logarithmic.  Rank-capped pairs are counted and the build
auto-escalates the cap (accuracy guard; the reference's H-LU is silently
approximate, factorization.hpp:19-79).

Storage invariant: stored factor columns beyond ``pRank[I, J]`` are zero.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..clustering.cluster_tree import ClusterTree
from ..generator import Generator
from .aca import batched_partial_aca
from .block_tree import rjasanow_steinbach
from .blr import (
    DENSE,
    LR,
    ZERO,
    BLRMatrix,
    _grid_cells,
    blr_cholesky,
    blr_lu,
    blr_matvec,
    blr_solve,
    blr_triangular_solve,
)
from .compressors import batched_recompress
from ..utils.precision import precise_jit

__all__ = [
    "TwoLevelBLR",
    "build_blr2",
    "blr2_lu",
    "blr2_cholesky",
    "blr2_solve",
    "blr2_triangular_solve",
    "blr2_matvec",
    "blr2_backward_error",
]


# ======================================================================
# container
# ======================================================================


@dataclass
class TwoLevelBLR:
    """Coarse-panel two-level compressed matrix (cluster numbering).

    Off-diagonal panels live in ``pU [nC, nC, P, R]`` / ``pV [nC, nC, R, P]``
    with per-pair ranks ``pRank [nC, nC]`` (diagonal slots zero).  The
    diagonal is ``Dd [nC, P, P]`` (``diag_mode='dense'``) or a list of
    per-panel :class:`BLRMatrix` (``diag_mode='blr'``)."""

    n: int
    panel_off: np.ndarray  # [nC]
    panel_size: np.ndarray  # [nC]
    P: int  # padded panel size
    diag_mode: str  # "dense" | "blr"
    pU: Any  # [nC, nC, P, R]
    pV: Any  # [nC, nC, R, P]
    pRank: Any  # [nC, nC] int32 (device)
    Dd: Any = None  # [nC, P, P] dense diagonal panels (dense mode)
    diag: Optional[list] = None  # [nC] BLRMatrix (blr mode)
    perms: Any = None  # [nC, P] int32 row permutations of the diag LU
    R: int = 128  # stored panel rank cap
    epsilon: float = 1e-6
    factorized: bool = False
    kind: str = "lu"  # "lu" | "chol" once factorized
    permutation: np.ndarray = None  # cluster -> user (global tree)
    info: dict = field(default_factory=dict)
    cache: dict = field(default_factory=dict, repr=False)

    @property
    def nC(self) -> int:
        return int(self.panel_off.shape[0])

    @property
    def dtype(self):
        return self.pU.dtype

    def memory_bytes(self) -> int:
        total = self.pU.size * self.pU.dtype.itemsize * 2
        if self.diag_mode == "dense":
            total += self.Dd.size * self.Dd.dtype.itemsize
        else:
            for B in self.diag:
                if isinstance(B, TwoLevelBLR):
                    total += B.memory_bytes()  # nested panel (>= 3 levels)
                else:
                    total += B.D.size * B.D.dtype.itemsize
                    total += B.U.size * B.U.dtype.itemsize * 2
        return int(total)

    def compression_info(self) -> dict:
        rk = np.asarray(self.pRank)
        stored = 0
        nCi = self.nC
        for I in range(nCi):
            for J in range(nCi):
                if I != J:
                    stored += 2 * self.P * int(rk[I, J])
        if self.diag_mode == "dense":
            stored += nCi * self.P * self.P
        else:
            for B in self.diag:
                if isinstance(B, TwoLevelBLR):
                    sub = B.compression_info()
                    stored += int(float(B.n) * B.n / sub["compression_ratio"])
                    continue
                rk = np.asarray(B.ranks)
                stored += int((B.cls == DENSE).sum()) * B.b * B.b
                for i, j in zip(*np.nonzero(B.cls == LR)):
                    stored += 2 * B.b * int(rk[B.lr_slot[i, j]])
        total = float(self.n) * self.n
        return dict(
            n_panels=nCi,
            diag_mode=self.diag_mode,
            rank_max=int(rk.max()) if rk.size else 0,
            compression_ratio=total / stored if stored else float("inf"),
        )

    def to_dense(self, user_numbering: bool = False) -> np.ndarray:
        nCi, P = self.nC, self.P
        pU = np.asarray(self.pU)
        pV = np.asarray(self.pV)
        A = np.zeros((self.n, self.n), pU.dtype)
        for I in range(nCi):
            oI, sI = int(self.panel_off[I]), int(self.panel_size[I])
            if self.diag_mode == "dense":
                A[oI : oI + sI, oI : oI + sI] = np.asarray(self.Dd[I])[:sI, :sI]
            else:
                A[oI : oI + sI, oI : oI + sI] = self.diag[I].to_dense()
            for J in range(nCi):
                if I == J:
                    continue
                oJ, sJ = int(self.panel_off[J]), int(self.panel_size[J])
                blk = pU[I, J] @ pV[I, J]
                A[oI : oI + sI, oJ : oJ + sJ] = blk[:sI, :sJ]
        if user_numbering:
            out = np.zeros_like(A)
            out[np.ix_(self.permutation, self.permutation)] = A
            return out
        return A


# ======================================================================
# assembly
# ======================================================================


def _pow2(n: int, lo: int = 1) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def _panel_gather_idx(perm, offs, szs, sel, P):
    """User-numbering row indices per panel in ``sel``, padded (clamped)."""
    ar = np.arange(P)[None, :]
    rel = np.minimum(ar, szs[sel][:, None] - 1)
    return perm[offs[sel][:, None] + rel]


@partial(precise_jit, static_argnames=("R",))
def _k2_mask_factors(U, V, rank, R):
    keep = jnp.arange(R)[None, :] < rank[:, None]
    return (
        U * keep[:, None, :].astype(U.dtype),
        V * keep[:, :, None].astype(V.dtype),
    )


def _offdiag_aca(generator, perm, offs, szs, pairs, P, epsilon, R, chunk):
    """Chunked batched ACA over panel pairs -> (U [np,P,R] DEVICE, V DEVICE,
    rank host, failed host).

    Chunk size is fixed so the ACA while_loop compiles once per (chunk,P,R)
    shape.  The factor arrays STAY ON DEVICE (accumulated with slice
    writes): fetching them to host would move ~2 GB per build at n=100k;
    only the small rank/failed vectors cross the host boundary."""
    npairs = pairs.shape[0]
    U_out = jnp.zeros((npairs, P, R), generator.dtype)
    V_out = jnp.zeros((npairs, R, P), generator.dtype)
    rank_out = np.zeros((npairs,), np.int32)
    failed_out = np.zeros((npairs,), bool)
    for c0 in range(0, npairs, chunk):
        c1 = min(c0 + chunk, npairs)
        sel = np.arange(c0, c1)
        pad = chunk - sel.size
        isel = np.concatenate([pairs[sel, 0], np.repeat(pairs[sel[:1], 0], pad)])
        jsel = np.concatenate([pairs[sel, 1], np.repeat(pairs[sel[:1], 1], pad)])
        rows = jnp.asarray(_panel_gather_idx(perm, offs, szs, isel, P), jnp.int32)
        cols = jnp.asarray(_panel_gather_idx(perm, offs, szs, jsel, P), jnp.int32)
        U, V, rank, failed = batched_partial_aca(
            generator,
            rows,
            cols,
            jnp.asarray(szs[isel], jnp.int32),
            jnp.asarray(szs[jsel], jnp.int32),
            epsilon,
            R,
        )
        U, V = _k2_mask_factors(U, V, rank, R)
        U_out = U_out.at[c0:c1].set(U[: sel.size])
        V_out = V_out.at[c0:c1].set(V[: sel.size])
        rank_out[sel] = np.asarray(rank)[: sel.size]
        failed_out[sel] = np.asarray(failed)[: sel.size]
    return U_out, V_out, rank_out, failed_out


def _build_diag_dense(generator, perm, offs, szs, nC, P, dtype):
    """Stacked dense diagonal panels with identity on the padding rows."""
    idx = jnp.asarray(_panel_gather_idx(perm, offs, szs, np.arange(nC), P), jnp.int32)
    Dd = generator.block(idx, idx)  # [nC, P, P]
    ar = jnp.arange(P)
    pad_eye = (ar[None, :, None] >= jnp.asarray(szs)[:, None, None]) & (
        ar[None, :, None] == ar[None, None, :]
    )
    valid = (ar[None, :, None] < jnp.asarray(szs)[:, None, None]) & (
        ar[None, None, :] < jnp.asarray(szs)[:, None, None]
    )
    Dd = jnp.where(valid, Dd, 0) + pad_eye.astype(dtype)
    return Dd


def _build_diag_blr(generator, tree, panel_cells, offs, szs, epsilon, eta,
                    block_size, R_half):
    """Per-panel one-level BLR diagonal matrices built from the GLOBAL
    cluster tree's finer level, with all panels' low-rank cells compressed
    in ONE batched ACA call and all dense cells gathered in one kernel."""
    perm = tree.permutation
    nC = len(panel_cells)
    # fine cells per panel (descendants of the panel node)
    fine_cells, f_offs, f_szs, _ = _grid_cells(tree, block_size)
    ends = offs + szs
    owner = np.searchsorted(offs, f_offs, side="right") - 1
    assert (f_offs + f_szs <= ends[owner]).all(), "fine cells must nest in panels"
    b = max(8, int(-(-int(f_szs.max()) // 8) * 8))
    if R_half is None:
        R_half = max(16, min(b // 2, 64))
    R_half = int(-(-R_half // 8) * 8)
    R_buf = 2 * R_half
    dtype = generator.dtype

    # classify cell pairs inside each panel
    panel_fine = [np.nonzero(owner == I)[0] for I in range(nC)]
    lr_list, dn_list = [], []  # (panel, local i, local j, fine ci, fine cj)
    for I in range(nC):
        loc = panel_fine[I]
        for a, ci in enumerate(loc):
            for c, cj in enumerate(loc):
                ti, sj = fine_cells[ci], fine_cells[cj]
                adm = a != c and rjasanow_steinbach(
                    tree.centers[ti], tree.radii[ti],
                    tree.centers[sj], tree.radii[sj], eta,
                )
                (lr_list if adm else dn_list).append((I, a, c, ci, cj))

    ar = np.arange(b)[None, :]

    def fine_gidx(cells_sel):
        rel = np.minimum(ar, f_szs[cells_sel][:, None] - 1)
        return perm[f_offs[cells_sel][:, None] + rel]

    # one batched ACA for ALL panels' LR cells
    lr_arr = np.array(lr_list, np.int64).reshape(-1, 5)
    U_all = V_all = rank_all = failed_all = None
    if lr_arr.shape[0]:
        rows = jnp.asarray(fine_gidx(lr_arr[:, 3]), jnp.int32)
        cols = jnp.asarray(fine_gidx(lr_arr[:, 4]), jnp.int32)
        Ua, Va, rank_all, failed_all = batched_partial_aca(
            generator, rows, cols,
            jnp.asarray(f_szs[lr_arr[:, 3]], jnp.int32),
            jnp.asarray(f_szs[lr_arr[:, 4]], jnp.int32),
            epsilon, R_half,
        )
        rank_all = np.asarray(rank_all)
        failed_all = np.asarray(failed_all)
        U_all, V_all = np.asarray(Ua), np.asarray(Va)
    # failures fall back to dense (false positives, tree_builder.hpp:572-577)
    extra_dn = []
    if lr_arr.shape[0]:
        for t in np.nonzero(failed_all)[0]:
            extra_dn.append(tuple(lr_arr[t]))
    dn_arr = np.array(dn_list + extra_dn, np.int64).reshape(-1, 5)
    D_all = None
    if dn_arr.shape[0]:
        rows = jnp.asarray(fine_gidx(dn_arr[:, 3]), jnp.int32)
        cols = jnp.asarray(fine_gidx(dn_arr[:, 4]), jnp.int32)
        data = generator.block(rows, cols)
        rmask = jnp.asarray(ar < f_szs[dn_arr[:, 3]][:, None])
        cmask = jnp.asarray(ar < f_szs[dn_arr[:, 4]][:, None])
        D_all = np.asarray(jnp.where(rmask[:, :, None] & cmask[:, None, :], data, 0))

    # split into per-panel BLRMatrix containers
    diag = []
    for I in range(nC):
        loc = panel_fine[I]
        nL = loc.size
        cls = np.zeros((nL, nL), np.int8)
        dense_slot = np.full((nL, nL), -1, np.int32)
        lr_slot = np.full((nL, nL), -1, np.int32)
        D_sel, U_sel, V_sel, r_sel = [], [], [], []
        if lr_arr.shape[0]:
            for t in np.nonzero((lr_arr[:, 0] == I) & ~failed_all)[0]:
                _, a, c, _, _ = lr_arr[t]
                cls[a, c] = LR
                lr_slot[a, c] = len(U_sel)
                U_sel.append(U_all[t])
                V_sel.append(V_all[t])
                r_sel.append(rank_all[t])
        if dn_arr.shape[0]:
            for t in np.nonzero(dn_arr[:, 0] == I)[0]:
                _, a, c, ci, cj = dn_arr[t]
                cls[a, c] = DENSE
                dense_slot[a, c] = len(D_sel)
                blk = D_all[t].copy()
                if a == c and int(f_szs[ci]) < b:
                    ix = np.arange(int(f_szs[ci]), b)
                    blk[ix, ix] = 1.0
                D_sel.append(blk)
        nd, nl = len(D_sel), len(U_sel)
        D = jnp.asarray(
            np.concatenate(
                [np.stack(D_sel) if nd else np.zeros((0, b, b), D_all.dtype if D_all is not None else dtype),
                 np.zeros((1, b, b), D_all.dtype if D_all is not None else dtype)]
            )
        )
        if nl:
            U = np.zeros((nl + 1, b, R_buf), U_all.dtype)
            V = np.zeros((nl + 1, R_buf, b), U_all.dtype)
            U[:nl, :, :R_half] = np.stack(U_sel)
            V[:nl, :R_half, :] = np.stack(V_sel)
            U, V = jnp.asarray(U), jnp.asarray(V)
            ranks = jnp.asarray(np.array(r_sel + [0], np.int32))
        else:
            U = jnp.zeros((1, b, R_buf), dtype)
            V = jnp.zeros((1, R_buf, b), dtype)
            ranks = jnp.zeros((1,), jnp.int32)
        diag.append(
            BLRMatrix(
                n=int(szs[I]),
                cell_off=f_offs[loc] - offs[I],
                cell_size=f_szs[loc],
                b=b,
                cls=cls,
                dense_slot=dense_slot,
                lr_slot=lr_slot,
                D=D,
                U=U,
                V=V,
                ranks=ranks,
                R_half=R_half,
                epsilon=epsilon,
                permutation=None,
                info=dict(n_cells=nL),
            )
        )
    return diag


def build_blr2(
    generator: Generator,
    tree: ClusterTree,
    epsilon: float = 1e-6,
    coarse_size: Optional[int] = None,
    R: Optional[int] = None,
    diag_mode: str = "auto",
    block_size: int = 512,
    eta: float = 10.0,
    R_half: Optional[int] = None,
    dense_diag_budget: int = 2 << 30,
    chunk: int = 256,
    auto_escalate: int = 1,
    mid_size: Optional[int] = None,
    mid_R: Optional[int] = None,
) -> TwoLevelBLR:
    """Assemble the two-level matrix: every off-diagonal panel pair as one
    low-rank factor (weak admissibility, chunked batched ACA), diagonal
    panels dense-stacked, flat-BLR, or NESTED TwoLevelBLR
    (``diag_mode="nested"`` — >= 3 factorization levels, the reference's
    full-depth recursion asymptotics, factorization.hpp:19-79; panel
    sub-grid at ``mid_size``, default P/8 clamped to >= 512).

    ``R`` is the stored panel rank cap; pairs whose ε-rank exceeds it are
    re-compressed after a global cap escalation (``auto_escalate`` rounds),
    mirroring :func:`..hmatrix.blr.blr_lu`'s accuracy guard.

    ``coarse_size=None`` scales the panel size with the problem
    (pow2(n/16) clamped to [4096, 16384]): panel-pair memory grows as
    nC²·P·R = (n/P)²·P·R, so larger problems need LARGER panels to fit
    HBM, and interface panel ranks grow only mildly with P."""
    if coarse_size is None:
        coarse_size = min(16384, max(4096, _pow2(tree.n_points // 16)))
    cells, offs, szs, level = _grid_cells(tree, coarse_size)
    nC = len(cells)
    if nC < 2:
        raise ValueError(
            f"coarse_size={coarse_size} yields {nC} panel(s); need >= 2 "
            "(use plain build_blr / dense factorization instead)"
        )
    perm = tree.permutation
    P = max(8, int(-(-int(szs.max()) // 8) * 8))
    dtype = generator.dtype
    itemsize = np.asarray(jnp.zeros((), dtype)).dtype.itemsize
    if R is None:
        R = min(128, P // 2)
    R = int(_pow2(max(8, R), 8))
    if diag_mode == "auto":
        diag_mode = "dense" if nC * P * P * itemsize <= dense_diag_budget else "nested"
    if diag_mode not in ("dense", "blr", "nested"):
        raise ValueError(f"unknown diag_mode {diag_mode!r}")
    t0 = time.perf_counter()

    pairs = np.array(
        [(I, J) for I in range(nC) for J in range(nC) if I != J], np.int64
    )
    chunk = int(min(chunk, _pow2(pairs.shape[0])))
    t_aca0 = time.perf_counter()
    Up, Vp, rank, failed = _offdiag_aca(
        generator, perm, offs, szs, pairs, P, epsilon, R, chunk
    )
    n_failed = int(failed.sum())
    npairs_all = pairs.shape[0]
    while n_failed and auto_escalate > 0:
        # global cap escalation: widen buffers, re-run ACA on failed pairs
        auto_escalate -= 1
        R2 = 2 * R
        Up = jnp.pad(Up, ((0, 0), (0, 0), (0, R2 - R)))
        Vp = jnp.pad(Vp, ((0, 0), (0, R2 - R), (0, 0)))
        R = R2
        fsel = np.nonzero(failed)[0]
        fchunk = int(min(chunk, _pow2(fsel.size)))
        Uf, Vf, rf, ff = _offdiag_aca(
            generator, perm, offs, szs, pairs[fsel], P, epsilon, R, fchunk
        )
        # gather+where merge (scatter-free)
        merge = np.full(npairs_all, fsel.size, np.int64)
        merge[fsel] = np.arange(fsel.size)
        gi = jnp.asarray(merge, jnp.int32)
        mask = jnp.asarray(failed)[:, None, None]
        Uf_ext = jnp.concatenate([Uf, jnp.zeros((1, P, R), Uf.dtype)])
        Vf_ext = jnp.concatenate([Vf, jnp.zeros((1, R, P), Vf.dtype)])
        Up = jnp.where(mask, Uf_ext[gi], Up)
        Vp = jnp.where(mask, Vf_ext[gi], Vp)
        rank[fsel], failed[fsel] = rf, ff
        n_failed = int(failed.sum())
    if n_failed:
        # last resort — store failed pairs EXACTLY as (block, identity)
        # factors: the panel analog of the reference's ACA-failure ->
        # dense fallback (tree_builder.hpp:572-577).  Needs R >= P.
        if R < P:
            R2 = int(_pow2(P, 8))
            Up = jnp.pad(Up, ((0, 0), (0, 0), (0, R2 - R)))
            Vp = jnp.pad(Vp, ((0, 0), (0, R2 - R), (0, 0)))
            R = R2
        fsel = np.nonzero(failed)[0]
        for t in fsel:
            I, J = int(pairs[t, 0]), int(pairs[t, 1])
            rows = jnp.asarray(_panel_gather_idx(perm, offs, szs, np.array([I]), P), jnp.int32)
            cols = jnp.asarray(_panel_gather_idx(perm, offs, szs, np.array([J]), P), jnp.int32)
            blk = generator.block(rows, cols)[0]
            sI, sJ = int(szs[I]), int(szs[J])
            ar = jnp.arange(P)
            blk = jnp.where((ar[:, None] < sI) & (ar[None, :] < sJ), blk, 0)
            Ut = jnp.zeros((P, R), blk.dtype).at[:, :P].set(blk)[:, :R]
            Vt = jnp.zeros((R, P), blk.dtype).at[:sJ, :sJ].set(
                jnp.eye(sJ, dtype=blk.dtype)
            )
            Up = Up.at[t].set(Ut)
            Vp = Vp.at[t].set(Vt)
            rank[t] = sJ

    # fill the [nC, nC, P, R] pair store by GATHER through a dummy-padded
    # index map, in place of an .at[pi, pj].set scatter of the same data
    idx_map = np.full((nC, nC), pairs.shape[0], np.int64)
    idx_map[pairs[:, 0], pairs[:, 1]] = np.arange(pairs.shape[0])
    gat_all = jnp.asarray(idx_map.reshape(-1), jnp.int32)
    Up_all = jnp.concatenate([Up, jnp.zeros((1, P, R), Up.dtype)])
    Vp_all = jnp.concatenate([Vp, jnp.zeros((1, R, P), Vp.dtype)])
    pU = Up_all[gat_all].reshape(nC, nC, P, R)
    pV = Vp_all[gat_all].reshape(nC, nC, R, P)
    pRank = np.zeros((nC, nC), np.int32)
    pRank[pairs[:, 0], pairs[:, 1]] = rank

    t_aca = time.perf_counter() - t_aca0
    t_diag0 = time.perf_counter()
    nested = False
    if diag_mode == "dense":
        Dd = _build_diag_dense(generator, perm, offs, szs, nC, P, dtype)
        diag = None
    elif diag_mode == "nested":
        Dd = None
        if mid_size is None:
            mid_size = max(512, _pow2(P // 8))
        diag = _build_diag_nested(
            generator, tree, offs, szs, epsilon, mid_size, R2=mid_R,
            chunk=chunk,
        )
        # the factorization treats nested panels through the same per-panel
        # machinery as flat-BLR panels (polymorphic dispatch)
        diag_mode = "blr"
        nested = True
    else:
        Dd = None
        diag = _build_diag_blr(
            generator, tree, cells, offs, szs, epsilon, eta, block_size, R_half
        )

    return TwoLevelBLR(
        n=tree.n_points,
        panel_off=offs,
        panel_size=szs,
        P=P,
        diag_mode=diag_mode,
        pU=jnp.asarray(pU),
        pV=jnp.asarray(pV),
        pRank=jnp.asarray(pRank),
        Dd=Dd,
        diag=diag,
        R=R,
        epsilon=float(epsilon),
        permutation=perm,
        info=dict(
            n_panels=nC,
            coarse_level=level,
            panel_rank_cap=R,
            n_aca_failed=n_failed,
            nested_diag=nested,
            n_levels=3 if nested else 2,
            offdiag_aca_walltime=t_aca,
            diag_build_walltime=time.perf_counter() - t_diag0,
            build_walltime=time.perf_counter() - t0,
        ),
    )


# ======================================================================
# factorization kernels (shapes: active pair sets padded to powers of two)
# ======================================================================


@partial(precise_jit, donate_argnums=(0,))
def _k2_lu_diag(Dd, k):
    """LU of diagonal panel k; returns (Dd with LU stored, row perm [P])."""
    lu, _, p = jax.lax.linalg.lu(Dd[k])
    return Dd.at[k].set(lu), p


@partial(precise_jit, donate_argnums=(0,))
def _k2_chol_diag(Dd, k):
    L = jnp.linalg.cholesky(Dd[k])
    return Dd.at[k].set(L)


@partial(precise_jit, donate_argnums=(0,))
def _k2_col_panel(pV, Dd, k, idxI):
    """V_IK <- V_IK · U_K^{-1} for the stacked active rows I (LU path)."""
    Uk = Dd[k]
    Vik = pV[idxI, k]  # [c, R, P]
    Xt = jax.vmap(
        lambda v: jax.scipy.linalg.solve_triangular(Uk, v.T, trans=1, lower=False)
    )(Vik)
    return pV.at[idxI, k].set(jnp.swapaxes(Xt, 1, 2))


@partial(precise_jit, donate_argnums=(0,))
def _k2_row_panel(pU, Dd, perm_k, k, idxJ):
    """U_KJ <- L_K^{-1} · P_K^T · U_KJ for the stacked active cols J."""
    Lk = Dd[k]
    Ukj = pU[k, idxJ][:, perm_k, :]  # [c, P, R]
    X = jax.vmap(
        lambda u: jax.scipy.linalg.solve_triangular(
            Lk, u, lower=True, unit_diagonal=True
        )
    )(Ukj)
    return pU.at[k, idxJ].set(X)


@partial(precise_jit, donate_argnums=(0,))
def _k2_col_panel_chol(pV, Dd, k, idxI):
    """V_IK <- V_IK · L_K^{-H} (Cholesky path)."""
    Lk = Dd[k]
    Vik = pV[idxI, k]
    Xh = jax.vmap(
        lambda v: jax.scipy.linalg.solve_triangular(Lk, jnp.conj(v).T, lower=True)
    )(Vik)
    return pV.at[idxI, k].set(jnp.conj(jnp.swapaxes(Xh, 1, 2)))


@partial(precise_jit, static_argnames=("herm",), donate_argnums=(0, 1, 2, 7))
def _k2_schur_offdiag(pU, pV, pRank, k, pi, pj, eps, capped, herm=False):
    """Fused Schur update + re-truncation on active off-diagonal pairs:
    ``A_IJ -= (U_IK V_IK)(U_KJ V_KJ)`` (or ``(U_JK V_JK)^H`` when ``herm``),
    stacked add then batched QR+SVD truncation back to the R cap."""
    R = pU.shape[3]
    Uik = pU[pi, k]  # [c, P, R]
    Vik = pV[pi, k]  # [c, R, P]
    if herm:
        Ukj = jnp.conj(jnp.swapaxes(pV[pj, k], 1, 2))  # [c, P, R]
        Vkj = jnp.conj(jnp.swapaxes(pU[pj, k], 1, 2))  # [c, R, P]
    else:
        Ukj = pU[k, pj]
        Vkj = pV[k, pj]
    mid = jnp.einsum("crp,cps->crs", Vik, Ukj)  # [c, R, R]
    Uc = -jnp.einsum("cpr,crs->cps", Uik, mid)  # [c, P, R]
    Ut = pU[pi, pj]
    Vt = pV[pi, pj]
    Wu = jnp.concatenate([Ut, Uc], axis=2)  # [c, P, 2R]
    Wv = jnp.concatenate([Vt, Vkj], axis=1)  # [c, 2R, P]
    full = jnp.full((Wu.shape[0],), 2 * R, jnp.int32)
    U2, V2, r2 = batched_recompress(Wu, Wv, full, eps)
    hit = r2 > R
    r2c = jnp.minimum(r2, R)
    keep = jnp.arange(R)[None, :] < r2c[:, None]
    U2 = U2[:, :, :R] * keep[:, None, :].astype(U2.dtype)
    V2 = V2[:, :R, :] * keep[:, :, None].astype(V2.dtype)
    pU = pU.at[pi, pj].set(U2)
    pV = pV.at[pi, pj].set(V2)
    pRank = pRank.at[pi, pj].set(r2c)
    capped = capped.at[pi, pj].max(hit.astype(jnp.int32))
    return pU, pV, pRank, capped


@partial(precise_jit, static_argnames=("herm",), donate_argnums=(0,))
def _k2_schur_diag_dense(Dd, pU, pV, k, idxI, valid, herm=False):
    """Dense diagonal absorption: ``D_I -= (U_IK V_IK)(U_KI V_KI)``.

    ``valid`` masks padded entries (the update is an ``add``, so duplicate
    padded indices must contribute zero)."""
    Uik = pU[idxI, k] * valid[:, None, None].astype(pU.dtype)
    Vik = pV[idxI, k]
    if herm:
        Uki = jnp.conj(jnp.swapaxes(pV[idxI, k], 1, 2))
        Vki = jnp.conj(jnp.swapaxes(pU[idxI, k], 1, 2))
    else:
        Uki = pU[k, idxI]
        Vki = pV[k, idxI]
    mid = jnp.einsum("crp,cps->crs", Vik, Uki)
    left = jnp.einsum("cpr,crs->cps", Uik, mid)
    contrib = jnp.einsum("cps,csq->cpq", left, Vki)
    return Dd.at[idxI].add(-contrib)


@partial(precise_jit, static_argnames=("herm",), donate_argnums=(0, 1, 2))
def _k2_pending_append(peU, peV, peRank, k, idxI, pU, pV, eps, herm=False):
    """BLR-diag mode: append the step-k diagonal Schur contribution of the
    active panels to their pending low-rank update, re-truncated."""
    R = pU.shape[3]
    Uik = pU[idxI, k]
    Vik = pV[idxI, k]
    if herm:
        Uki = jnp.conj(jnp.swapaxes(pV[idxI, k], 1, 2))
        Vki = jnp.conj(jnp.swapaxes(pU[idxI, k], 1, 2))
    else:
        Uki = pU[k, idxI]
        Vki = pV[k, idxI]
    mid = jnp.einsum("crp,cps->crs", Vik, Uki)
    Uc = -jnp.einsum("cpr,crs->cps", Uik, mid)
    Wu = jnp.concatenate([peU[idxI], Uc], axis=2)
    Wv = jnp.concatenate([peV[idxI], Vki], axis=1)
    full = jnp.full((Wu.shape[0],), 2 * R, jnp.int32)
    U2, V2, r2 = batched_recompress(Wu, Wv, full, eps)
    r2c = jnp.minimum(r2, R)
    keep = jnp.arange(R)[None, :] < r2c[:, None]
    peU = peU.at[idxI].set(U2[:, :, :R] * keep[:, None, :].astype(U2.dtype))
    peV = peV.at[idxI].set(V2[:, :R, :] * keep[:, :, None].astype(V2.dtype))
    peRank = peRank.at[idxI].set(r2c)
    return peU, peV, peRank


def _pad_idx(a, dummy, lo=1):
    a = np.asarray(a, np.int32)
    p = _pow2(max(a.size, lo))
    out = np.full(p, dummy, np.int32)
    out[: a.size] = a
    return jnp.asarray(out)


def _active_sets(nC, k):
    """Active row/col panels and off-diagonal pair set for step k."""
    act = np.arange(k + 1, nC, dtype=np.int32)
    pi, pj = np.meshgrid(act, act, indexing="ij")
    off = pi != pj
    return act, pi[off], pj[off]


# ======================================================================
# LU / Cholesky drivers
# ======================================================================

# byte budget for one Schur-update launch (Wu/Wv concatenations + the
# batched QR/SVD workspace of the fused re-truncation); pairs are chunked
# to stay under it — see the chunked loop in _factorize
_SCHUR_CHUNK_BUDGET = int(2e9)  # QR workspace runs ~5x beyond the estimate


def _blr_apply_pending(B: BLRMatrix, Uc, Vc, eps):
    """Apply a pending low-rank update U·V to a BLR panel cell-wise (dense
    cells add exactly; LR cells re-truncate) — the level-2 absorption."""
    from .blr import _cells_plan
    from .compressors import svd_truncation_rank

    nL, b, Rh = B.nL, B.b, B.R_half
    pad_idx, mask, _ = _cells_plan(B)
    Ur = jnp.where(mask[:, :, None], Uc[pad_idx], 0)  # [nL, b, R]
    Vcl = jnp.where(mask[:, None, :], Vc[:, pad_idx].transpose(1, 0, 2), 0)

    di, dj = np.nonzero(B.cls == DENSE)
    if di.size:
        slots = jnp.asarray(B.dense_slot[di, dj])
        contrib = jnp.einsum("cbr,crk->cbk", Ur[di], Vcl[dj])
        B.D = B.D.at[slots].add(contrib.astype(B.dtype))
    li, lj = np.nonzero(B.cls == LR)
    if li.size:
        slots = jnp.asarray(B.lr_slot[li, lj])
        Wu = jnp.concatenate([B.U[slots], Ur[li].astype(B.dtype)], axis=2)
        Wv = jnp.concatenate([B.V[slots], Vcl[lj].astype(B.dtype)], axis=1)
        full = jnp.full((Wu.shape[0],), Wu.shape[2], jnp.int32)
        U2, V2, r2 = batched_recompress(Wu, Wv, full, eps)
        w = B.U.shape[2]
        r2c = jnp.minimum(r2, Rh)
        keep = jnp.arange(w)[None, :] < r2c[:, None]
        B.U = B.U.at[slots].set(U2[:, :, :w] * keep[:, None, :].astype(B.dtype))
        B.V = B.V.at[slots].set(V2[:, :w, :] * keep[:, :, None].astype(B.dtype))
        B.ranks = B.ranks.at[slots].set(r2c.astype(jnp.int32))
    B.cache.clear()
    return B


def blr2_triangular_solve(F: TwoLevelBLR, B, which: str = "L",
                          trans: str = "N"):
    """Half-solve with ONE factor of a factorized dense-diag TwoLevelBLR:
    ``op(L̂)·X = B`` or ``op(Û)·X = B`` — the panel-level triangular surface
    (``triangular_hmatrix_matrix_solve.hpp:18`` one level up) that the
    ≥3-level recursion uses for its panel transforms."""
    if not F.factorized:
        raise ValueError("factorize first (blr2_lu / blr2_cholesky)")
    if F.diag_mode != "dense":
        raise NotImplementedError(
            "panel triangular solves need dense-diag factors (innermost level)"
        )
    B = jnp.asarray(B)
    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]
    b = _panels_pack(F, B.astype(F.dtype))
    if F.kind == "chol":
        if which == "L" and trans == "N":
            x = _k2_solve_fwd_chol(F.Dd, F.pU, F.pV, b)
        elif which == "U" and trans == "N":
            x = _k2_solve_bwd_chol(F.Dd, F.pU, F.pV, b)
        elif which == "L" and trans == "C":
            # L^H x = b == the 'U' factor of the hermitian factorization
            x = _k2_solve_bwd_chol(F.Dd, F.pU, F.pV, b)
        else:
            raise NotImplementedError(f"chol half-solve {which}/{trans}")
    else:
        if which == "L" and trans == "N":
            x = _k2_solve_fwd_lu(F.Dd, F.perms, F.pU, F.pV, b)
        elif which == "U" and trans == "N":
            x = _k2_solve_bwd_lu(F.Dd, F.pU, F.pV, b)
        elif which == "U" and trans == "T":
            x = _k2_solve_fwd_lu_trans(F.Dd, F.pU, F.pV, b)
        elif which == "L" and trans == "T":
            x = _k2_solve_bwd_lu_trans(F.Dd, F.perms, F.pU, F.pV, b)
        else:
            raise NotImplementedError(f"lu half-solve {which}/{trans}")
    out = _panels_unpack(F, x)
    return out[:, 0] if squeeze else out


def _blr2_apply_pending(T: TwoLevelBLR, Uc, Vc, eps):
    """Apply a pending low-rank update ``Uc·Vc`` (panel-local) to an
    UNfactorized nested TwoLevelBLR panel: diagonal sub-panels absorb the
    dense restriction exactly; off-diagonal sub-pairs append the restricted
    factors and re-truncate in one batched QR+SVD — the level-3 analog of
    :func:`_blr_apply_pending`."""
    nCs, R = T.nC, T.R
    Ucp = _panels_pack(T, jnp.asarray(Uc).astype(T.dtype))  # [nCs, P2, Rc]
    Vcp = jnp.swapaxes(
        _panels_pack(T, jnp.swapaxes(jnp.asarray(Vc).astype(T.dtype), 0, 1)), 1, 2
    )  # [nCs, Rc, P2]
    T.Dd = T.Dd + jnp.einsum("ipr,irq->ipq", Ucp, Vcp)
    I, J = np.nonzero(~np.eye(nCs, dtype=bool))
    if I.size:
        Wu = jnp.concatenate([T.pU[I, J], Ucp[I]], axis=2)
        Wv = jnp.concatenate([T.pV[I, J], Vcp[J]], axis=1)
        full = jnp.full((I.size,), Wu.shape[2], jnp.int32)
        U2, V2, r2 = batched_recompress(Wu, Wv, full, eps)
        r2c = jnp.minimum(r2, R)
        keep = jnp.arange(R)[None, :] < r2c[:, None]
        T.pU = T.pU.at[I, J].set(U2[:, :, :R] * keep[:, None, :].astype(T.dtype))
        T.pV = T.pV.at[I, J].set(V2[:, :R, :] * keep[:, :, None].astype(T.dtype))
        T.pRank = T.pRank.at[I, J].set(r2c)
    T.cache.clear()
    return T


def _panel_apply_pending(B, Uc, Vc, eps):
    if isinstance(B, TwoLevelBLR):
        return _blr2_apply_pending(B, Uc, Vc, eps)
    return _blr_apply_pending(B, Uc, Vc, eps)


def _panel_factorize(B, eps, herm):
    if isinstance(B, TwoLevelBLR):
        return (
            blr2_cholesky(B, eps, error_estimate=False)
            if herm
            else blr2_lu(B, eps, error_estimate=False)
        )
    return (
        blr_cholesky(B, eps, auto_escalate=0, error_estimate=False)
        if herm
        else blr_lu(B, eps, auto_escalate=0, error_estimate=False)
    )


def _panel_tri_solve(F, slab, which, trans):
    if isinstance(F, TwoLevelBLR):
        return blr2_triangular_solve(F, slab, which=which, trans=trans)
    return blr_triangular_solve(F, slab, which=which, side="L", trans=trans)


def _build_diag_nested(generator, tree, offs, szs, epsilon, mid_size,
                       R2=None, chunk=256):
    """Nested diagonal panels: each top-level panel becomes its OWN
    TwoLevelBLR over the global tree's ``mid_size``-level cells (order-
    preserving, so panel factors act directly on the parent's cluster-
    numbered slabs) — the ≥3-level factorization nesting (the
    reference's full-depth recursion ``factorization.hpp:19-79``).

    All panels' off-diagonal sub-pairs compress in ONE chunked batched ACA
    and all sub-diagonal dense blocks gather in one kernel; ACA failures
    fall back to truncated dense SVD at the R2 cap."""
    perm = tree.permutation
    nC = int(offs.shape[0])
    fine_cells, f_offs, f_szs, _ = _grid_cells(tree, mid_size)
    ends = offs + szs
    owner = np.searchsorted(offs, f_offs, side="right") - 1
    assert (f_offs + f_szs <= ends[owner]).all(), "mid cells must nest in panels"
    P2 = max(8, int(-(-int(f_szs.max()) // 8) * 8))
    if R2 is None:
        # quarter-panel cap: the nested format only pays off when sub-pair
        # factors are well below half-dense; epsilon-ranks beyond the cap
        # fall back to truncated SVD at the cap (counted)
        R2 = max(16, min(128, P2 // 4))
    R2 = int(_pow2(max(8, R2), 8))
    dtype = generator.dtype

    panel_fine = [np.nonzero(owner == I)[0] for I in range(nC)]
    for I in range(nC):
        if len(panel_fine[I]) < 2:
            raise ValueError(
                f"panel {I} has {len(panel_fine[I])} sub-cell(s) at "
                f"mid_size={mid_size}; lower mid_size"
            )

    pair_meta = []  # (panel, a, c)
    pair_cells = []  # (fine ci, fine cj)
    for I in range(nC):
        loc = panel_fine[I]
        for a in range(len(loc)):
            for c in range(len(loc)):
                if a != c:
                    pair_meta.append((I, a, c))
                    pair_cells.append((loc[a], loc[c]))
    pair_cells = np.array(pair_cells, np.int64).reshape(-1, 2)
    chunk = int(min(chunk, _pow2(max(1, pair_cells.shape[0]))))
    Up, Vp, rank, failed = _offdiag_aca(
        generator, perm, f_offs, f_szs, pair_cells, P2, epsilon, R2, chunk
    )
    n_capped = 0
    if failed.any():
        # dense-SVD fallback at the R2 cap for inadmissible sub-pairs
        sel = np.nonzero(failed)[0]
        rows = jnp.asarray(
            _panel_gather_idx(perm, f_offs, f_szs, pair_cells[sel, 0], P2),
            jnp.int32,
        )
        cols = jnp.asarray(
            _panel_gather_idx(perm, f_offs, f_szs, pair_cells[sel, 1], P2),
            jnp.int32,
        )
        blk = generator.block(rows, cols)
        ar = np.arange(P2)[None, :]
        rm = jnp.asarray(ar < f_szs[pair_cells[sel, 0]][:, None])
        cm = jnp.asarray(ar < f_szs[pair_cells[sel, 1]][:, None])
        blk = jnp.where(rm[:, :, None] & cm[:, None, :], blk, 0)
        Uf, s, Vh = jnp.linalg.svd(blk, full_matrices=False)
        from .compressors import svd_truncation_rank

        rk = svd_truncation_rank(s, epsilon)
        n_capped = int(np.asarray(rk > R2).sum())
        rk = jnp.minimum(rk, R2)
        keep = jnp.arange(R2)[None, :] < rk[:, None]
        Usel = (Uf[:, :, :R2] * jnp.where(keep, s[:, :R2], 0)[:, None, :].astype(dtype))
        Usel = Usel * keep[:, None, :].astype(dtype)
        Vsel = Vh[:, :R2, :] * keep[:, :, None].astype(dtype)
        merge = np.full(pair_cells.shape[0], sel.size, np.int64)
        merge[sel] = np.arange(sel.size)
        gi = jnp.asarray(merge, jnp.int32)
        mask = jnp.asarray(failed)[:, None, None]
        Us_ext = jnp.concatenate([Usel, jnp.zeros((1, P2, R2), Usel.dtype)])
        Vs_ext = jnp.concatenate([Vsel, jnp.zeros((1, R2, P2), Vsel.dtype)])
        Up = jnp.where(mask, Us_ext[gi], Up)
        Vp = jnp.where(mask, Vs_ext[gi], Vp)
        rank[sel] = np.asarray(rk)

    # one batched gather for every sub-diagonal dense block
    diag_cells = np.concatenate([panel_fine[I] for I in range(nC)])
    Dd_all = _build_diag_dense(
        generator, perm, f_offs[diag_cells], f_szs[diag_cells],
        diag_cells.shape[0], P2, dtype,
    )

    # panel pair stores by DEVICE gather (factors never visit the host;
    # the dummy last row covers the zero diagonal slots)
    Up_ext = jnp.concatenate([Up, jnp.zeros((1,) + Up.shape[1:], Up.dtype)])
    Vp_ext = jnp.concatenate([Vp, jnp.zeros((1,) + Vp.shape[1:], Vp.dtype)])
    n_pairs = pair_cells.shape[0]

    panels = []
    pos = 0
    pair_meta = np.array(pair_meta, np.int64).reshape(-1, 3)
    for I in range(nC):
        loc = panel_fine[I]
        ns = len(loc)
        idx_map = np.full((ns, ns), n_pairs, np.int64)
        pR = np.zeros((ns, ns), np.int32)
        sel = np.nonzero(pair_meta[:, 0] == I)[0]
        for t in sel:
            _, a, c = pair_meta[t]
            idx_map[a, c] = t
            pR[a, c] = rank[t]
        gat = jnp.asarray(idx_map.reshape(-1), jnp.int32)
        panels.append(
            TwoLevelBLR(
                n=int(szs[I]),
                panel_off=f_offs[loc] - int(offs[I]),
                panel_size=f_szs[loc].copy(),
                P=P2,
                diag_mode="dense",
                pU=Up_ext[gat].reshape(ns, ns, P2, R2),
                pV=Vp_ext[gat].reshape(ns, ns, R2, P2),
                pRank=jnp.asarray(pR),
                Dd=Dd_all[pos : pos + ns],
                R=R2,
                epsilon=float(epsilon),
                permutation=np.arange(int(szs[I])),
                info=dict(nested_panel=True, n_rank_capped_pairs=n_capped),
            )
        )
        pos += ns
    return panels


def _factorize(A: TwoLevelBLR, eps: float, kind: str,
               error_estimate: bool) -> TwoLevelBLR:
    nC, P, R = A.nC, A.P, A.R
    herm = kind == "chol"
    t0 = time.perf_counter()
    # working COPIES: the in-loop kernels donate their panel buffers
    # (without donation every .at[].set launch holds input+output copies of
    # the multi-GB arrays — observed RESOURCE_EXHAUSTED at n=100k), and
    # donation would otherwise invalidate the caller-visible A
    pU = jnp.array(A.pU, copy=True)
    pV = jnp.array(A.pV, copy=True)
    pRank = jnp.array(A.pRank, copy=True)
    capped = jnp.zeros((nC, nC), jnp.int32)
    # per-step truncation error accumulates over the nC elimination steps
    # (measured: backward error ~ nC*eps when truncating at eps), so
    # intermediates truncate at eps/nC to land the FACTORIZATION at ~eps
    eps_int = eps / max(1, nC)
    eps_arr = jnp.asarray(eps_int, np.finfo(np.dtype(A.pU.dtype)).dtype)

    if A.diag_mode == "dense":
        Dd = jnp.array(A.Dd, copy=True)  # diag kernels donate their buffer
        perms = jnp.tile(jnp.arange(P, dtype=jnp.int32)[None], (nC, 1))
        diag = None
        peU = peV = peRank = None
    else:
        Dd = None
        perms = None
        diag = list(A.diag)
        peU = jnp.zeros((nC, P, R), A.dtype)
        peV = jnp.zeros((nC, R, P), A.dtype)
        peRank = jnp.zeros((nC,), jnp.int32)

    for K in range(nC):
        k = jnp.asarray(K, jnp.int32)
        act, pi, pj = _active_sets(nC, K)

        # 1. diagonal factorization
        if A.diag_mode == "dense":
            if herm:
                Dd = _k2_chol_diag(Dd, k)
            else:
                Dd, perm_k = _k2_lu_diag(Dd, k)
                perms = perms.at[K].set(perm_k)
        else:
            if K > 0:
                diag[K] = _panel_apply_pending(
                    diag[K], peU[K], peV[K], eps_int
                )
            diag[K] = _panel_factorize(diag[K], eps_int, herm)

        if act.size == 0:
            break

        # pad the active set with a repeat of the first active index: every
        # write below is a recompute-and-set, so duplicate indices write the
        # same value (the one add-based kernel takes an explicit mask)
        idxI = _pad_idx(act, int(act[0]))

        # 2. panel transforms
        if A.diag_mode == "dense":
            if herm:
                pV = _k2_col_panel_chol(pV, Dd, k, idxI)
            else:
                pV = _k2_col_panel(pV, Dd, k, idxI)
                pU = _k2_row_panel(pU, Dd, perms[K], k, idxI)
        else:
            FK = diag[K]
            nK = int(A.panel_size[K])

            def _solve_pad(slab, which, trans):
                # slab [P, m]: the panel factor only spans the true nK rows
                X = _panel_tri_solve(FK, slab[:nK], which, trans)
                if nK < P:
                    X = jnp.concatenate(
                        [X, jnp.zeros((P - nK, X.shape[1]), X.dtype)]
                    )
                return X

            # stacked slab solves through the panel BLR factors
            Vik = pV[idxI, k]  # [c, R, P]
            c = int(Vik.shape[0])
            if herm:
                # V_IK <- V_IK L_K^{-H}:  X^H = L_K^{-1} V^H
                slab = jnp.conj(Vik).transpose(2, 0, 1).reshape(P, c * R)
                X = _solve_pad(slab, "L", "N")
                Xr = jnp.conj(X.reshape(P, c, R).transpose(1, 2, 0))
                pV = pV.at[idxI, k].set(Xr)
            else:
                slab = Vik.transpose(2, 0, 1).reshape(P, c * R)
                X = _solve_pad(slab, "U", "T")
                pV = pV.at[idxI, k].set(X.reshape(P, c, R).transpose(1, 2, 0))
                Ukj = pU[k, idxI]  # [c, P, R]
                slab = Ukj.transpose(1, 0, 2).reshape(P, c * R)
                Y = _solve_pad(slab, "L", "N")
                pU = pU.at[k, idxI].set(Y.reshape(P, c, R).transpose(1, 0, 2))

        # 3. Schur updates on trailing off-diagonal pairs
        if herm:
            low = pi > pj  # lower triangle only
            pi_h, pj_h = pi[low], pj[low]
        else:
            pi_h, pj_h = pi, pj
        if pi_h.size:
            # recompute-and-set updates: padding with a repeated real pair is
            # idempotent (duplicates write identical values).  The pair set is
            # CHUNKED so the QR workspace of the fused re-truncation stays
            # under a fixed byte budget — at BASELINE scales the full set
            # ((nC-k-1)^2 pairs of [P, 2R] panels) alone exceeds device
            # memory.
            itemsize = jnp.dtype(A.dtype).itemsize
            per_pair = P * 4 * R * itemsize * 6  # Wu+Wv+QR transients
            chunk = max(1, min(_SCHUR_CHUNK_BUDGET // per_pair, pi_h.size))
            chunk = _pow2(chunk)
            for lo in range(0, pi_h.size, chunk):
                pi_c = pi_h[lo : lo + chunk]
                pj_c = pj_h[lo : lo + chunk]
                pi_p = _pad_idx(pi_c, int(pi_c[0]), lo=chunk)
                pj_p = _pad_idx(pj_c, int(pj_c[0]), lo=chunk)
                pU, pV, pRank, capped = _k2_schur_offdiag(
                    pU, pV, pRank, k, pi_p, pj_p, eps_arr, capped, herm=herm
                )

        # 4. Schur updates on trailing diagonal panels
        valid = jnp.arange(idxI.shape[0]) < act.size
        if A.diag_mode == "dense":
            Dd = _k2_schur_diag_dense(Dd, pU, pV, k, idxI, valid, herm=herm)
        else:
            peU, peV, peRank = _k2_pending_append(
                peU, peV, peRank, k, idxI, pU, pV, eps_arr, herm=herm
            )

    out = replace(
        A,
        pU=pU,
        pV=pV,
        pRank=pRank,
        Dd=Dd,
        diag=diag,
        perms=perms,
        epsilon=eps,
        factorized=True,
        kind=kind,
        info=dict(A.info),
        cache={},
    )
    out.info[f"{kind}_walltime"] = time.perf_counter() - t0
    out.info["n_rank_capped_pairs"] = int(np.asarray(capped).sum())
    if error_estimate:
        out.info["backward_error_est"] = blr2_backward_error(A, out, n_probe=2)
    return out


def blr2_lu(A: TwoLevelBLR, epsilon: Optional[float] = None,
            error_estimate: bool = True) -> TwoLevelBLR:
    """Right-looking two-level panel LU — the reference's recursive H-LU one
    level up (``factorization.hpp:19-79``): factor the diagonal panel,
    transform the row/column panel factors through its triangular solves,
    and apply batched truncated low-rank Schur updates to the trailing
    panels."""
    if A.factorized:
        raise ValueError("already factorized")
    return _factorize(A, A.epsilon if epsilon is None else epsilon, "lu",
                      error_estimate)


def blr2_cholesky(A: TwoLevelBLR, epsilon: Optional[float] = None,
                  error_estimate: bool = True) -> TwoLevelBLR:
    """Two-level panel Cholesky A = L·L^H (``factorization.hpp:131-205``):
    reads the lower panel triangle of a symmetric/hermitian positive-definite
    matrix; trailing Schur updates use the hermitian form -L_IK·L_JK^H."""
    if A.factorized:
        raise ValueError("already factorized")
    return _factorize(A, A.epsilon if epsilon is None else epsilon, "chol",
                      error_estimate)


# ======================================================================
# solve
# ======================================================================


@precise_jit
def _k2_solve_fwd_lu(Dd, perms, pU, pV, b):
    """Forward panel sweep y_K = L_K^{-1} P_K^T (b_K - Σ_{J<K} L_KJ y_J),
    one lax.scan over panels (dense-diag LU)."""
    nC, P, _ = Dd.shape

    def body(y, K):
        contrib = jnp.einsum(
            "jpr,jrq,jqk->pk",
            pU[K] * (jnp.arange(nC) < K)[:, None, None].astype(pU.dtype),
            pV[K],
            y,
        )
        r = (y[K] - contrib)[perms[K]]
        xK = jax.scipy.linalg.solve_triangular(
            Dd[K], r, lower=True, unit_diagonal=True
        )
        return y.at[K].set(xK), None

    y, _ = jax.lax.scan(body, b, jnp.arange(nC))
    return y


@precise_jit
def _k2_solve_bwd_lu(Dd, pU, pV, y):
    """Backward sweep x_K = U_K^{-1} (y_K - Σ_{J>K} U_KJ x_J)."""
    nC = Dd.shape[0]

    def body(x, K):
        contrib = jnp.einsum(
            "jpr,jrq,jqk->pk",
            pU[K] * (jnp.arange(nC) > K)[:, None, None].astype(pU.dtype),
            pV[K],
            x,
        )
        r = x[K] - contrib
        xK = jax.scipy.linalg.solve_triangular(Dd[K], r, lower=False)
        return x.at[K].set(xK), None

    x, _ = jax.lax.scan(body, y, jnp.arange(nC - 1, -1, -1))
    return x


@precise_jit
def _k2_solve_fwd_lu_trans(Dd, pU, pV, b):
    """Forward sweep of Aᵀ x = b: Ûᵀ y = b (lower triangular).

    Ûᵀ block (K, J<K) = (U_JK·V_JK)ᵀ — the stored strict-upper pairs read
    by COLUMN K; the diagonal is U_Kᵀ (factorization.hpp:256-272 trans
    surface)."""
    nC = Dd.shape[0]

    def body(y, K):
        mask = (jnp.arange(nC) < K)[:, None, None].astype(pU.dtype)
        # (U_JK V_JK)ᵀ y_J = V_JKᵀ (U_JKᵀ y_J), batched over J
        t = jnp.einsum("jpr,jpk->jrk", pU[:, K] * mask, y)
        contrib = jnp.einsum("jrp,jrk->pk", pV[:, K], t)
        yK = jax.scipy.linalg.solve_triangular(
            Dd[K], y[K] - contrib, lower=False, trans="T"
        )
        return y.at[K].set(yK), None

    y, _ = jax.lax.scan(body, b, jnp.arange(nC))
    return y


@precise_jit
def _k2_solve_bwd_lu_trans(Dd, perms, pU, pV, y):
    """Backward sweep of Aᵀ x = b: L̂ᵀ x = y (unit upper triangular).

    L̂ᵀ block (K, J>K) = (U_JK·V_JK)ᵀ (stored strict-lower pairs by column
    K); the diagonal is (P_Kᵀ L_K)ᵀ = L_Kᵀ P_K, so w = L_K^{-ᵀ} r and
    x_K = P_Kᵀ w = w[argsort(perm_K)]."""
    nC = Dd.shape[0]
    inv = jnp.argsort(perms, axis=1)

    def body(x, K):
        mask = (jnp.arange(nC) > K)[:, None, None].astype(pU.dtype)
        t = jnp.einsum("jpr,jpk->jrk", pU[:, K] * mask, x)
        contrib = jnp.einsum("jrp,jrk->pk", pV[:, K], t)
        w = jax.scipy.linalg.solve_triangular(
            Dd[K], x[K] - contrib, lower=True, trans="T", unit_diagonal=True
        )
        return x.at[K].set(w[inv[K]]), None

    x, _ = jax.lax.scan(body, y, jnp.arange(nC - 1, -1, -1))
    return x


@precise_jit
def _k2_solve_fwd_chol(Dd, pU, pV, b):
    nC = Dd.shape[0]

    def body(y, K):
        contrib = jnp.einsum(
            "jpr,jrq,jqk->pk",
            pU[K] * (jnp.arange(nC) < K)[:, None, None].astype(pU.dtype),
            pV[K],
            y,
        )
        xK = jax.scipy.linalg.solve_triangular(Dd[K], y[K] - contrib, lower=True)
        return y.at[K].set(xK), None

    y, _ = jax.lax.scan(body, b, jnp.arange(nC))
    return y


@precise_jit
def _k2_solve_bwd_chol(Dd, pU, pV, y):
    """x_K = L_K^{-H} (y_K - Σ_{J>K} L_JK^H x_J)."""
    nC = Dd.shape[0]

    def body(x, K):
        # L_JK^H x_J = V_JK^H (U_JK^H x_J) from the stored lower pairs (J, K)
        mask = (jnp.arange(nC) > K)[:, None, None].astype(pU.dtype)
        UH = jnp.conj(jnp.swapaxes(pV[:, K], 1, 2))  # [j, P, R] = V^H
        VH = jnp.conj(jnp.swapaxes(pU[:, K], 1, 2))  # [j, R, P] = U^H
        contrib = jnp.einsum("jpr,jrq,jqk->pk", UH * mask, VH, x)
        xK = jax.scipy.linalg.solve_triangular(
            jnp.conj(Dd[K]).T, x[K] - contrib, lower=False
        )
        return x.at[K].set(xK), None

    x, _ = jax.lax.scan(body, y, jnp.arange(nC - 1, -1, -1))
    return x


def _panels_pack(F: TwoLevelBLR, x):
    """[n, k] -> [nC, P, k] padded panel layout."""
    plan = F.cache.get("_panels")
    if plan is None:
        ar = np.arange(F.P)[None, :]
        pad_idx = np.minimum(F.panel_off[:, None] + ar, F.n - 1)
        mask = ar < F.panel_size[:, None]
        keep = np.concatenate(
            [I * F.P + np.arange(int(sz)) for I, sz in enumerate(F.panel_size)]
        )
        plan = (
            jnp.asarray(pad_idx, jnp.int32),
            jnp.asarray(mask),
            jnp.asarray(keep, jnp.int32),
        )
        F.cache["_panels"] = plan
    pad_idx, mask, _ = plan
    return jnp.where(mask[:, :, None], x[pad_idx], 0)

def _panels_unpack(F: TwoLevelBLR, yc):
    _, _, keep = F.cache["_panels"]
    return yc.reshape(F.nC * F.P, yc.shape[-1])[keep]


def blr2_solve(F: TwoLevelBLR, rhs, user_numbering: bool = False,
               trans: str = "N"):
    """Solve A x = rhs with a factorized two-level matrix (the lu_solve /
    cholesky_solve surface, ``factorization.hpp:119-128,245-273``)."""
    if not F.factorized:
        raise ValueError("call blr2_lu / blr2_cholesky first")
    if trans not in ("N", "T", "C"):
        raise ValueError("trans must be 'N', 'T' or 'C'")
    rhs = jnp.asarray(rhs)
    if trans != "N":
        # reductions (factorization.hpp:256-272 trans surface):
        # chol:  A = L̂·L̂ᴴ hermitian  =>  Aᴴ = A ('C'≡'N'); Aᵀ = conj(A), so
        #        x = conj(A⁻¹ conj(b))
        # lu 'C': Aᴴ x = b  <=>  Aᵀ conj(x) = conj(b)
        if F.kind == "chol":
            if trans == "C":
                return blr2_solve(F, rhs, user_numbering, "N")
            return jnp.conj(
                blr2_solve(F, jnp.conj(rhs), user_numbering, "N")
            )
        if trans == "C":
            return jnp.conj(blr2_solve(F, jnp.conj(rhs), user_numbering, "T"))
    squeeze = rhs.ndim == 1
    if squeeze:
        rhs = rhs[:, None]
    if user_numbering:
        rhs = rhs[jnp.asarray(F.permutation)]
    b = _panels_pack(F, rhs.astype(F.dtype))

    if F.diag_mode == "dense":
        if F.kind == "chol":
            y = _k2_solve_fwd_chol(F.Dd, F.pU, F.pV, b)
            x = _k2_solve_bwd_chol(F.Dd, F.pU, F.pV, y)
        elif trans == "T":
            y = _k2_solve_fwd_lu_trans(F.Dd, F.pU, F.pV, b)
            x = _k2_solve_bwd_lu_trans(F.Dd, F.perms, F.pU, F.pV, y)
        else:
            y = _k2_solve_fwd_lu(F.Dd, F.perms, F.pU, F.pV, b)
            x = _k2_solve_bwd_lu(F.Dd, F.pU, F.pV, y)
    else:
        nC, P = F.nC, F.P
        pU, pV = F.pU, F.pV

        def _diag_solve(K, r, which, tr="N"):
            sz = int(F.panel_size[K])
            xK = _panel_tri_solve(F.diag[K], r[:sz], which, tr)
            if sz < P:
                xK = jnp.concatenate([xK, jnp.zeros((P - sz, xK.shape[1]), xK.dtype)])
            return xK

        def col_contrib(K, v, cmp):
            # Σ_J (U_JK·V_JK)ᵀ v_J over the stored COLUMN K (trans sweeps)
            mask = (cmp(jnp.arange(nC), K))[:, None, None].astype(pU.dtype)
            t = jnp.einsum("jpr,jpk->jrk", pU[:, K] * mask, v)
            return jnp.einsum("jrp,jrk->pk", pV[:, K], t)

        if trans == "T" and F.kind == "lu":
            # Aᵀ = Ûᵀ·L̂ᵀ: forward through Ûᵀ (lower), backward through L̂ᵀ
            y = b
            for K in range(nC):
                contrib = col_contrib(K, y, jnp.less)
                y = y.at[K].set(
                    _diag_solve(K, y[K] - contrib, "U", "T").astype(y.dtype)
                )
            x = y
            for K in range(nC - 1, -1, -1):
                contrib = col_contrib(K, x, jnp.greater)
                x = x.at[K].set(
                    _diag_solve(K, x[K] - contrib, "L", "T").astype(x.dtype)
                )
        else:
            y = b
            # forward: L̂ y = b; panel row K reads pairs (K, J<K) — for
            # Cholesky the lower pairs hold L directly
            for K in range(nC):
                mask = (jnp.arange(nC) < K)[:, None, None].astype(pU.dtype)
                contrib = jnp.einsum("jpr,jrq,jqk->pk", pU[K] * mask, pV[K], y)
                y = y.at[K].set(_diag_solve(K, y[K] - contrib, "L").astype(y.dtype))
            x = y
            # backward: Û x = y; for Cholesky Û = L^H, row K reads (J>K, K)^H
            for K in range(nC - 1, -1, -1):
                if F.kind == "chol":
                    maskJ = (jnp.arange(nC) > K)[:, None, None]
                    UH = jnp.conj(jnp.swapaxes(pV[:, K], 1, 2))  # [j, P, R]
                    VH = jnp.conj(jnp.swapaxes(pU[:, K], 1, 2))  # [j, R, P]
                    contrib = jnp.einsum(
                        "jpr,jrq,jqk->pk", UH * maskJ.astype(UH.dtype), VH, x
                    )
                else:
                    mask = (jnp.arange(nC) > K)[:, None, None].astype(pU.dtype)
                    contrib = jnp.einsum("jpr,jrq,jqk->pk", pU[K] * mask, pV[K], x)
                x = x.at[K].set(_diag_solve(K, x[K] - contrib, "U").astype(x.dtype))

    out = _panels_unpack(F, x)
    if user_numbering:
        out = jnp.zeros_like(out).at[jnp.asarray(F.permutation)].set(out)
    return out[:, 0] if squeeze else out


# ======================================================================
# products / diagnostics
# ======================================================================


@precise_jit
def _k2_matvec(pU, pV, xc):
    """Off-diagonal panel product: y_I += Σ_J U_IJ (V_IJ x_J)."""
    t = jnp.einsum("ijrq,jqk->ijrk", pV, xc)
    return jnp.einsum("ijpr,ijrk->ipk", pU, t)


def blr2_matvec(A: TwoLevelBLR, x):
    """y = A x in cluster numbering (one batched kernel for the panels,
    one for the diagonal)."""
    x = jnp.asarray(x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    xc = _panels_pack(A, x.astype(A.dtype))
    yc = _k2_matvec(A.pU, A.pV, xc)
    if A.diag_mode == "dense":
        yc = yc + jnp.einsum("ipq,iqk->ipk", A.Dd, xc)
    else:
        for I in range(A.nC):
            sz = int(A.panel_size[I])
            if isinstance(A.diag[I], TwoLevelBLR):
                yI = blr2_matvec(A.diag[I], xc[I, :sz])
            else:
                yI = blr_matvec(A.diag[I], xc[I, :sz])
            yc = yc.at[I, :sz].add(yI.astype(yc.dtype))
    out = _panels_unpack(A, yc)
    return out[:, 0] if squeeze else out


def _factor_apply(F: TwoLevelBLR, z):
    """(L̂·Û) z for the backward-error probe (dense-diag LU mode only; other
    modes use the solve-based probe in :func:`blr2_backward_error`)."""
    z = jnp.asarray(z)
    squeeze = z.ndim == 1
    if squeeze:
        z = z[:, None]
    zc = _panels_pack(F, z.astype(F.dtype))
    nC = F.nC
    ar = jnp.arange(nC)

    # w = Û z: strict-upper panels + upper-triangular diag
    maskU = (ar[:, None] < ar[None, :]).astype(F.dtype)
    t = jnp.einsum("ijrq,jqk->ijrk", F.pV, zc)
    w = jnp.einsum("ijpr,ij,ijrk->ipk", F.pU, maskU, t)
    w = w + jnp.einsum("ipq,iqk->ipk", jnp.triu(F.Dd), zc)
    # y = L̂ w: strict-lower panels + P_K^T L_K w
    maskL = (ar[:, None] > ar[None, :]).astype(F.dtype)
    t = jnp.einsum("ijrq,jqk->ijrk", F.pV, w)
    y = jnp.einsum("ijpr,ij,ijrk->ipk", F.pU, maskL, t)
    Lw = jnp.einsum(
        "ipq,iqk->ipk",
        jnp.tril(F.Dd, -1) + jnp.eye(F.P, dtype=F.dtype)[None],
        w,
    )
    # solve gathers r[perm] (= P r); the forward operator applies P^T
    inv = jnp.argsort(F.perms, axis=1)
    Lw = jnp.take_along_axis(Lw, inv[:, :, None], axis=1)
    y = y + Lw
    out = _panels_unpack(F, y)
    return out[:, 0] if squeeze else out


def blr2_backward_error(A: TwoLevelBLR, F: TwoLevelBLR, n_probe: int = 4,
                        seed: int = 0):
    """Stochastic backward error ‖(A − L·U)Z‖_F / ‖A·Z‖_F."""
    rng = np.random.default_rng(seed)
    z = jnp.asarray(rng.standard_normal((A.n, n_probe)))
    if jnp.issubdtype(A.dtype, jnp.complexfloating):
        # complex probes: independent Gaussian real and imaginary parts
        rt = np.finfo(np.dtype(A.dtype)).dtype  # matching real dtype
        z = jax.lax.complex(
            z.astype(rt), jnp.asarray(rng.standard_normal((A.n, n_probe)), rt)
        )
    az = blr2_matvec(A, z)
    if F.diag_mode == "dense" and F.kind == "lu":
        fz = _factor_apply(F, z)
    else:
        # generic probe: solve then re-apply A — measures ‖A x − z‖/‖z‖
        x = blr2_solve(F, z)
        rz = blr2_matvec(A, x) - z.astype(az.dtype)
        den = jnp.linalg.norm(z)
        return float(jnp.linalg.norm(rz) / jnp.where(den == 0, 1.0, den))
    num = jnp.linalg.norm(az - fz)
    den = jnp.linalg.norm(az)
    return float(num / jnp.where(den == 0, 1.0, den))
