"""Block low-rank (BLR) arithmetic: compressed LU factorization, triangular
solves, and compressed×compressed products on a uniform cluster-tree level.

Batched re-design of the reference's recursive H-arithmetic
(``hmatrix/linalg/factorization.hpp:19-205`` H-LU/H-Cholesky,
``triangular_hmatrix_hmatrix_solve.hpp:19-198``,
``add_hmatrix_hmatrix_product.hpp:24-312`` H×H): the pointer-tree recursion
with per-node dynamic ranks is hostile to XLA, so the factorization runs on
the **uniform grid of cluster nodes at one tree level** (the BLR format of
Amestoy et al., used by MUMPS): every block is a b×b cell, classified
dense / low-rank / zero by the same Rjasanow–Steinbach admissibility, and
the right-looking block LU

    for k:  LU(A_kk);  L_ik = A_ik A_kk⁻¹;  A_ij -= L_ik A_kj

executes as batched device kernels over all cells of a class at once.  The
fill-in pattern and class upgrades are data-independent, so a host-side
symbolic pass precomputes the whole schedule (the analog of the reference's
L0/task-dependency planning, ``task_dependencies.hpp``), and the device
only ever sees static shapes: dense cells ``[nd, b, b]``, low-rank cells
``U [nl, b, 2R] / V [nl, 2R, b]`` with on-device ranks, truncated back to
rank ≤ R by batched QR+SVD recompression after every step (the LR+LR
truncated addition of ``add_lrmat_lrmat.hpp:14-108``).

Storage invariant: stored LR ranks ≤ R_half; one Schur contribution per
step has rank ≤ R_half; buffers are 2·R_half wide, so appends never
overflow before the end-of-step recompression.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..clustering.cluster_tree import ClusterTree
from ..generator import Generator
from .aca import batched_partial_aca
from .block_tree import plan_block_tree
from .compressors import batched_recompress
from ..utils.precision import precise_jit
__all__ = [
    "BLRMatrix",
    "build_blr",
    "blr_lu",
    "blr_cholesky",
    "blr_solve",
    "blr_matvec",
    "blr_matmul",
    "blr_triangular_solve",
    "blr_backward_error",
    "widen_blr",
    "blr_transpose",
    "blr_triangular_solve_matrix",
]

ZERO, DENSE, LR = 0, 1, 2


# ======================================================================
# container
# ======================================================================


@dataclass
class BLRMatrix:
    """Uniform-grid block low-rank matrix (cluster numbering)."""

    n: int  # true matrix size
    cell_off: np.ndarray  # [nL]
    cell_size: np.ndarray  # [nL]
    b: int  # padded cell size
    cls: np.ndarray  # [nL, nL] int8
    dense_slot: np.ndarray  # [nL, nL] int32, -1 if none (last slot = dummy)
    lr_slot: np.ndarray  # [nL, nL] int32
    D: Any  # [nd+1, b, b] (slot nd = scratch dummy)
    U: Any  # [nl+1, b, Rbuf]
    V: Any  # [nl+1, Rbuf, b]
    ranks: Any  # [nl+1] int32 device
    piv: Any = None  # [nL, b] int32 diag pivots (after factorization)
    R_half: int = 16
    epsilon: float = 1e-6
    factorized: bool = False
    kind: str = "lu"  # factorization kind once factorized: "lu" | "chol"
    permutation: np.ndarray = None  # cluster -> user
    info: dict = field(default_factory=dict)
    cache: dict = field(default_factory=dict, repr=False)  # host plan caches

    @property
    def nL(self) -> int:
        return int(self.cell_off.shape[0])

    @property
    def dtype(self):
        return self.D.dtype

    @property
    def R_buf(self) -> int:
        return int(self.U.shape[2])

    # ------------------------------------------------------------------
    def to_dense(self, user_numbering: bool = False) -> np.ndarray:
        nL, b = self.nL, self.b
        D = np.asarray(self.D)
        U = np.asarray(self.U)
        V = np.asarray(self.V)
        rk = np.asarray(self.ranks)
        A = np.zeros((nL * b, nL * b), D.dtype)
        for i in range(nL):
            for j in range(nL):
                c = self.cls[i, j]
                if c == ZERO:
                    continue
                if c == DENSE:
                    blk = D[self.dense_slot[i, j]]
                else:
                    s = self.lr_slot[i, j]
                    r = int(rk[s])
                    blk = U[s][:, :r] @ V[s][:r, :]
                A[i * b : (i + 1) * b, j * b : (j + 1) * b] = blk
        # compact padded rows/cols
        keep = np.concatenate(
            [i * b + np.arange(sz) for i, sz in enumerate(self.cell_size)]
        )
        A = A[np.ix_(keep, keep)]
        if user_numbering:
            out = np.zeros_like(A)
            out[np.ix_(self.permutation, self.permutation)] = A
            return out
        return A

    def compression_info(self) -> dict:
        rk = np.asarray(self.ranks)
        nd = int((self.cls == DENSE).sum())
        nl = int((self.cls == LR).sum())
        stored = nd * self.b * self.b
        for i, j in zip(*np.nonzero(self.cls == LR)):
            stored += 2 * self.b * int(rk[self.lr_slot[i, j]])
        total = float(self.n) * self.n
        return dict(
            n_dense_cells=nd,
            n_lr_cells=nl,
            n_zero_cells=int((self.cls == ZERO).sum()),
            compression_ratio=total / stored if stored else float("inf"),
            rank_max=int(rk[:-1].max()) if rk.size > 1 else 0,
        )


# ======================================================================
# assembly
# ======================================================================


def _grid_cells(tree: ClusterTree, b_target: int):
    """Pick the deepest level whose cells are all <= b_target, returning
    (node_ids, offsets, sizes) tiling [0, N)."""
    level = 0
    while True:
        cells = []
        ok = True
        stack = [0]
        while stack:
            nd = stack.pop()
            if tree.depths[nd] == level or tree.is_leaf(nd):
                cells.append(nd)
                if tree.sizes[nd] > b_target:
                    ok = False
            else:
                stack.extend(reversed(tree.node_children(nd).tolist()))
        if ok or all(
            tree.is_leaf(c) for c in cells
        ):  # cannot split further
            break
        level += 1
    cells = sorted(cells, key=lambda nd: tree.offsets[nd])
    offs = np.array([tree.offsets[c] for c in cells], np.int64)
    szs = np.array([tree.sizes[c] for c in cells], np.int64)
    return np.array(cells), offs, szs, level


def build_blr(
    generator: Generator,
    tree: ClusterTree,
    epsilon: float = 1e-6,
    eta: float = 10.0,
    block_size: int = 256,
    R_half: Optional[int] = None,
) -> BLRMatrix:
    """Assemble a BLR matrix: admissible cells via batched partial ACA,
    the rest dense — one ACA kernel and one dense-gather kernel total."""
    cells, offs, szs, level = _grid_cells(tree, block_size)
    nL = len(cells)
    b = max(8, int(-(-int(szs.max()) // 8) * 8))
    N = tree.n_points
    perm = tree.permutation
    dtype = generator.dtype

    if R_half is None:
        R_half = max(16, min(b // 2, 64))
    R_half = int(-(-R_half // 8) * 8)
    R_buf = 2 * R_half

    # classify cell pairs by admissibility (same rule as the block tree)
    from .block_tree import rjasanow_steinbach

    cls = np.zeros((nL, nL), np.int8)
    for i in range(nL):
        for j in range(nL):
            ti, sj = cells[i], cells[j]
            adm = rjasanow_steinbach(
                tree.centers[ti], tree.radii[ti], tree.centers[sj], tree.radii[sj], eta
            )
            cls[i, j] = LR if adm else DENSE

    ar = np.arange(b)[None, :]

    def gather_idx(sel):  # user-numbering indices per cell in sel
        rel = np.minimum(ar, szs[sel][:, None] - 1)
        return perm[offs[sel][:, None] + rel]

    # --- low-rank cells: one batched ACA ---
    lr_pairs = np.argwhere(cls == LR)
    lr_slot = np.full((nL, nL), -1, np.int32)
    U_list = V_list = None
    if lr_pairs.size:
        rows = jnp.asarray(gather_idx(lr_pairs[:, 0]), jnp.int32)
        colsx = jnp.asarray(gather_idx(lr_pairs[:, 1]), jnp.int32)
        Ua, Va, rank, failed = batched_partial_aca(
            generator,
            rows,
            colsx,
            jnp.asarray(szs[lr_pairs[:, 0]], jnp.int32),
            jnp.asarray(szs[lr_pairs[:, 1]], jnp.int32),
            epsilon,
            R_half,
        )
        rank = np.asarray(rank)
        failed = np.asarray(failed)
        ok = ~failed
        for t, (i, j) in enumerate(lr_pairs):
            if not ok[t]:
                cls[i, j] = DENSE
        sel = np.nonzero(ok)[0]
        nl = sel.size
        U = jnp.zeros((nl + 1, b, R_buf), dtype)
        V = jnp.zeros((nl + 1, R_buf, b), dtype)
        U = U.at[:nl, :, :R_half].set(Ua[sel])
        V = V.at[:nl, :R_half, :].set(Va[sel])
        ranks = jnp.concatenate(
            [jnp.asarray(rank[sel], jnp.int32), jnp.zeros((1,), jnp.int32)]
        )
        for t_new, t_old in enumerate(sel):
            i, j = lr_pairs[t_old]
            lr_slot[i, j] = t_new
    else:
        nl = 0
        U = jnp.zeros((1, b, R_buf), dtype)
        V = jnp.zeros((1, R_buf, b), dtype)
        ranks = jnp.zeros((1,), jnp.int32)

    # --- dense cells: one batched gather ---
    dn_pairs = np.argwhere(cls == DENSE)
    dense_slot = np.full((nL, nL), -1, np.int32)
    nd = dn_pairs.shape[0]
    if nd:
        rows = jnp.asarray(gather_idx(dn_pairs[:, 0]), jnp.int32)
        colsx = jnp.asarray(gather_idx(dn_pairs[:, 1]), jnp.int32)
        data = generator.block(rows, colsx)
        rmask = jnp.asarray(ar < szs[dn_pairs[:, 0]][:, None])
        cmask = jnp.asarray(ar < szs[dn_pairs[:, 1]][:, None])
        data = jnp.where(rmask[:, :, None] & cmask[:, None, :], data, 0)
        D = jnp.concatenate([data, jnp.zeros((1, b, b), dtype)], axis=0)
        for t, (i, j) in enumerate(dn_pairs):
            dense_slot[i, j] = t
    else:
        D = jnp.zeros((1, b, b), dtype)

    # identity on diagonal padding so diagonal cells stay invertible
    diag_cells = [dense_slot[i, i] for i in range(nL)]
    eye = jnp.eye(b, dtype=dtype)
    for i, s in enumerate(diag_cells):
        if s >= 0 and szs[i] < b:
            pad_eye = jnp.where(
                (jnp.arange(b) >= szs[i])[:, None] & (jnp.arange(b)[:, None] == jnp.arange(b)[None, :]),
                eye,
                0,
            )
            D = D.at[s].add(pad_eye)

    return BLRMatrix(
        n=N,
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
        epsilon=epsilon,
        permutation=perm,
        info=dict(level=level, n_cells=nL),
    )


# ======================================================================
# batched kernels (jitted; counts padded by caller)
# ======================================================================


def _b_lu_diag(D, slot):
    lu, piv = jax.scipy.linalg.lu_factor(D[slot])
    return D.at[slot].set(lu), piv


def _b_col_panel_dense(D, slots, lu_k, piv_k):
    """L_ik = A_ik A_kk^{-1} for dense cells: Xᵀ = solve(A_kkᵀ, A_ikᵀ)."""
    A = D[slots]  # [c, b, b]
    Xt = jax.vmap(lambda a: jax.scipy.linalg.lu_solve((lu_k, piv_k), a.T, trans=1))(A)
    return D.at[slots].set(jnp.swapaxes(Xt, 1, 2))


def _b_col_panel_lr(V, slots, lu_k, piv_k):
    """L_ik = U (V A_kk^{-1}) for LR cells: transform V."""
    Vv = V[slots]  # [c, R, b]
    Xt = jax.vmap(lambda v: jax.scipy.linalg.lu_solve((lu_k, piv_k), v.T, trans=1))(Vv)
    return V.at[slots].set(jnp.swapaxes(Xt, 1, 2))


def _b_chol_diag(D, slot):
    """L_kk = chol(A_kk) (lower). Hermitian/real-symmetric positive definite
    diagonal cells only (the potrf path, factorization.hpp:131-205)."""
    L = jnp.linalg.cholesky(D[slot])
    return D.at[slot].set(L)


def _b_col_panel_dense_chol(D, slots, L_k):
    """L_ik = A_ik L_kk^{-H} for dense cells: X^H = L_kk^{-1} A_ik^H."""
    A = D[slots]  # [c, b, b]
    Xh = jax.vmap(
        lambda a: jax.scipy.linalg.solve_triangular(L_k, jnp.conj(a).T, lower=True)
    )(A)
    return D.at[slots].set(jnp.conj(jnp.swapaxes(Xh, 1, 2)))


def _b_col_panel_lr_chol(V, slots, L_k):
    """L_ik = U (V L_kk^{-H}) for LR cells: transform V."""
    Vv = V[slots]  # [c, R, b]
    Xh = jax.vmap(
        lambda v: jax.scipy.linalg.solve_triangular(L_k, jnp.conj(v).T, lower=True)
    )(Vv)
    return V.at[slots].set(jnp.conj(jnp.swapaxes(Xh, 1, 2)))


def _b_densify(D, dslots, U, V, lslots):
    """Materialize LR cells into dense slots (class upgrade)."""
    blk = jnp.einsum("cbr,crn->cbn", U[lslots], V[lslots])
    return D.at[dslots].set(blk)


def _b_schur_dense_target(
    Da, Ua, Va, Db, Ub, Vb, Dt,
    ia_cls, ia_slot, jb_cls, jb_slot, t_slot, Rh, herm_b=False, neg=True,
):
    """Dt_ij (-)= A_ik B_kj into dense targets, any class combo.

    ``(Da, Ua, Va)`` / ``(Db, Ub, Vb)`` hold the left/right operand cells
    (the factorization passes its own arrays three times; the compressed
    product passes two different matrices).  ia_cls/jb_cls: [c] int32
    (1 dense, 2 lr); slots index D or U/V.  With ``herm_b`` the B operand is
    applied conj-transposed (the Cholesky Schur update A_ij -= L_ik L_jk^H,
    factorization.hpp:131-205).  ``neg`` selects subtraction (Schur) vs
    accumulation (product)."""
    La_d = Da[ia_slot]  # [c, b, b]
    La_u = Ua[ia_slot][:, :, :Rh]
    La_v = Va[ia_slot][:, :Rh, :]
    if herm_b:
        Rb_d = jnp.conj(jnp.swapaxes(Db[jb_slot], 1, 2))
        Rb_u = jnp.conj(jnp.swapaxes(Vb[jb_slot][:, :Rh, :], 1, 2))  # [c, b, Rh]
        Rb_v = jnp.conj(jnp.swapaxes(Ub[jb_slot][:, :, :Rh], 1, 2))  # [c, Rh, b]
    else:
        Rb_d = Db[jb_slot]
        Rb_u = Ub[jb_slot][:, :, :Rh]
        Rb_v = Vb[jb_slot][:, :Rh, :]

    a_lr = (ia_cls == LR)[:, None, None]
    b_lr = (jb_cls == LR)[:, None, None]

    # evaluate both sides to dense equivalents lazily by combo
    # dense x dense
    dd = jnp.einsum("cij,cjk->cik", La_d, Rb_d)
    # dense x lr: (A Uu) Vv
    dl = jnp.einsum("cij,cjr,crk->cik", La_d, Rb_u, Rb_v)
    # lr x dense: Uu (Vv B)
    ld = jnp.einsum("cir,crj,cjk->cik", La_u, La_v, Rb_d)
    # lr x lr: Uu (Vv Uu') Vv'
    ll = jnp.einsum("cir,crj,cjs,csk->cik", La_u, La_v, Rb_u, Rb_v)

    contrib = jnp.where(
        a_lr & b_lr, ll, jnp.where(a_lr, ld, jnp.where(b_lr, dl, dd))
    )
    return Dt.at[t_slot].add(-contrib if neg else contrib)


def _b_schur_lr_target(
    Da, Ua, Va, Db, Ub, Vb, Ut, Vt, ranks_t, ranks_a, ranks_b,
    ia_cls, ia_slot, jb_cls, jb_slot, t_slot, Rh, herm_b=False, neg=True,
):
    """Ut·Vt at t_slot (-)= A_ik B_kj appended as factor pairs (at least one
    side LR); ranks_t tracks the append offsets."""
    La_d = Da[ia_slot]
    La_u = Ua[ia_slot][:, :, :Rh]
    La_v = Va[ia_slot][:, :Rh, :]
    if herm_b:
        Rb_d = jnp.conj(jnp.swapaxes(Db[jb_slot], 1, 2))
        Rb_u = jnp.conj(jnp.swapaxes(Vb[jb_slot][:, :Rh, :], 1, 2))
        Rb_v = jnp.conj(jnp.swapaxes(Ub[jb_slot][:, :, :Rh], 1, 2))
    else:
        Rb_d = Db[jb_slot]
        Rb_u = Ub[jb_slot][:, :, :Rh]
        Rb_v = Vb[jb_slot][:, :Rh, :]
    a_lr = (ia_cls == LR)
    b_lr = (jb_cls == LR)

    # contribution factors (width R_half), by combo:
    # dl: (A Uu') , Vv'      rank rb
    # ld: Uu , (Vv B)        rank ra
    # ll: Uu , ((Vv Uu') Vv') rank min(ra, rb) (bounded by ra mask)
    Uc_dl = jnp.einsum("cij,cjr->cir", La_d, Rb_u)
    Vc_dl = Rb_v
    Uc_ld = La_u
    Vc_ld = jnp.einsum("crj,cjk->crk", La_v, Rb_d)
    W = jnp.einsum("crj,cjs->crs", La_v, Rb_u)
    Vc_ll = jnp.einsum("crs,csk->crk", W, Rb_v)

    Uc = jnp.where(
        (a_lr & b_lr)[:, None, None],
        La_u,
        jnp.where(a_lr[:, None, None], Uc_ld, Uc_dl),
    )
    Vc = jnp.where(
        (a_lr & b_lr)[:, None, None],
        Vc_ll,
        jnp.where(a_lr[:, None, None], Vc_ld, Vc_dl),
    )
    rc = jnp.where(
        a_lr & b_lr,
        jnp.minimum(ranks_a[ia_slot], ranks_b[jb_slot]),
        jnp.where(a_lr, ranks_a[ia_slot], ranks_b[jb_slot]),
    ).astype(jnp.int32)

    # append at column offset ranks_t[t_slot] (invariant: fits in 2*Rh buffer)
    off = ranks_t[t_slot]

    # vectorized append: build updated blocks then scatter back
    def upd(t, u, v, r, o, Uarr, Varr):
        z = jnp.zeros((), o.dtype)
        Uu = jax.lax.dynamic_update_slice(Uarr[t], -u if neg else u, (z, o))
        Vv = jax.lax.dynamic_update_slice(Varr[t], v, (o, z))
        return Uu, Vv

    Unew, Vnew = jax.vmap(upd, in_axes=(0, 0, 0, 0, 0, None, None))(
        t_slot, Uc, Vc, rc, off, Ut, Vt
    )
    Ut = Ut.at[t_slot].set(Unew)
    Vt = Vt.at[t_slot].set(Vnew)
    ranks_t = ranks_t.at[t_slot].set(
        jnp.minimum(off + rc, jnp.asarray(Ut.shape[2], jnp.int32))
    )
    return Ut, Vt, ranks_t


def _b_recompress(U, V, ranks, slots, epsilon, Rh, capped=None):
    """Batched epsilon-truncation of touched LR cells, capped at R_half.

    ``capped`` (optional [n_lr] bool) accumulates, per cell, whether the
    epsilon-rank EXCEEDED the cap — the silent-accuracy-loss detector behind
    the factorization's backward-error guard."""
    Us, Vs, rs = U[slots], V[slots], ranks[slots]
    U2, V2, r2 = batched_recompress(Us, Vs, rs, epsilon)
    hit = r2 > Rh
    r2 = jnp.minimum(r2, Rh)
    keep = jnp.arange(U.shape[2])[None, :] < r2[:, None]
    U2 = U2 * keep[:, None, :].astype(U.dtype)
    V2 = V2 * keep[:, :, None].astype(V.dtype)
    out = (
        U.at[slots].set(U2),
        V.at[slots].set(V2),
        ranks.at[slots].set(r2.astype(jnp.int32)),
    )
    if capped is not None:
        out = out + (capped.at[slots].max(hit.astype(jnp.int32)),)
    return out


# jitted aliases of the step bodies (legacy per-step dispatch path, still
# used by blr_matmul's middle-index sweep)
_k_lu_diag = precise_jit(_b_lu_diag)
_k_col_panel_dense = precise_jit(_b_col_panel_dense)
_k_col_panel_lr = precise_jit(_b_col_panel_lr)
_k_chol_diag = precise_jit(_b_chol_diag)
_k_col_panel_dense_chol = precise_jit(_b_col_panel_dense_chol)
_k_col_panel_lr_chol = precise_jit(_b_col_panel_lr_chol)
_k_densify = precise_jit(_b_densify)
_k_schur_dense_target = partial(
    precise_jit, static_argnames=("Rh", "herm_b", "neg")
)(_b_schur_dense_target)
_k_schur_lr_target = partial(
    precise_jit, static_argnames=("Rh", "herm_b", "neg")
)(_b_schur_lr_target)
_k_recompress = partial(precise_jit, static_argnames=("Rh",))(_b_recompress)


def _pad_pow2(arr_list, dummy):
    """Pad index arrays to the next power of two with a dummy slot (bounds
    the number of distinct compiled shapes)."""
    n = len(arr_list[0])
    if n == 0:
        return None
    p = 1
    while p < n:
        p *= 2
    out = []
    for a in arr_list:
        a = np.asarray(a, np.int32)
        out.append(jnp.asarray(np.concatenate([a, np.full(p - n, dummy, np.int32)])))
    return out


# ======================================================================
# factorization — scanned static-schedule engine
# ======================================================================


def _pow2c(n: int) -> int:
    if n == 0:
        return 0
    p = 1
    while p < n:
        p *= 2
    return p


def _facto_schedule(A: BLRMatrix, kind: str):
    """Host symbolic pass for the scanned factorization: simulate the
    fill-in / class-upgrade evolution once (data-independent) and emit, per
    elimination step, the index lists of every device phase — the planning
    role of the reference's task-dependency pass (``task_dependencies.hpp``)
    for its recursive H-LU (``factorization.hpp:19-79`` LU, ``:131-205``
    Cholesky)."""
    nL = A.nL
    herm = kind == "chol"
    cls = A.cls.copy()
    if herm:
        for i in range(nL):
            for j in range(i + 1, nL):
                cls[i, j] = ZERO  # upper triangle unused
    densify_at, fill_lr_at, fill_dn_at = {}, {}, {}
    for k in range(nL):
        assert cls[k, k] == DENSE, "diagonal cells must be dense"
        for i in range(k + 1, nL):
            if cls[i, k] == ZERO:
                continue
            js = range(k + 1, i + 1) if herm else range(k + 1, nL)
            for j in js:
                ck2 = cls[j, k] if herm else cls[k, j]
                if ck2 == ZERO:
                    continue
                contrib = DENSE if (cls[i, k] == DENSE and ck2 == DENSE) else LR
                if cls[i, j] == ZERO:
                    cls[i, j] = contrib
                    (fill_dn_at if contrib == DENSE else fill_lr_at)[(i, j)] = k
                elif cls[i, j] == LR and contrib == DENSE:
                    cls[i, j] = DENSE
                    densify_at[(i, j)] = k

    # final slot allocation (every ever-dense cell gets a dense slot)
    dense_slot = A.dense_slot.copy()
    lr_slot = A.lr_slot.copy()
    nd = int(np.asarray(A.D).shape[0]) - 1
    nl = int(np.asarray(A.U).shape[0]) - 1
    for (i, j) in sorted(list(densify_at) + list(fill_dn_at)):
        if dense_slot[i, j] < 0:
            dense_slot[i, j] = nd
            nd += 1
    for (i, j) in sorted(fill_lr_at):
        if lr_slot[i, j] < 0:
            lr_slot[i, j] = nl
            nl += 1

    # re-simulate step by step, emitting phase lists
    cls2 = A.cls.copy()
    if herm:
        for i in range(nL):
            for j in range(i + 1, nL):
                cls2[i, j] = ZERO
    steps = []
    for k in range(nL):
        st = {"k": k, "ds": int(dense_slot[k, k])}
        st["cd"] = [int(dense_slot[i, k]) for i in range(k + 1, nL)
                    if cls2[i, k] == DENSE]
        st["cl"] = [int(lr_slot[i, k]) for i in range(k + 1, nL)
                    if cls2[i, k] == LR]
        dens = sorted((i, j) for (i, j), kk in densify_at.items() if kk == k)
        st["dfd"] = [int(dense_slot[i, j]) for i, j in dens]
        st["dfl"] = [int(lr_slot[i, j]) for i, j in dens]
        for i, j in dens:
            cls2[i, j] = DENSE
        for (i, j), kk in fill_dn_at.items():
            if kk == k:
                cls2[i, j] = DENSE
        for (i, j), kk in fill_lr_at.items():
            if kk == k:
                cls2[i, j] = LR

        sd = {key: [] for key in ("ac", "a", "bc", "b", "t")}
        sl = {key: [] for key in ("ac", "a", "bc", "b", "t")}
        touched = []
        for i in range(k + 1, nL):
            cik = cls2[i, k]
            if cik == ZERO:
                continue
            ia = int(dense_slot[i, k] if cik == DENSE else lr_slot[i, k])
            js = range(k + 1, i + 1) if herm else range(k + 1, nL)
            for j in js:
                cjk = cls2[j, k] if herm else cls2[k, j]
                if cjk == ZERO:
                    continue
                if herm:
                    jb = int(dense_slot[j, k] if cjk == DENSE else lr_slot[j, k])
                else:
                    jb = int(dense_slot[k, j] if cjk == DENSE else lr_slot[k, j])
                if cls2[i, j] == DENSE:
                    g = sd
                    g["t"].append(int(dense_slot[i, j]))
                else:
                    g = sl
                    g["t"].append(int(lr_slot[i, j]))
                    touched.append(int(lr_slot[i, j]))
                g["ac"].append(int(cik))
                g["a"].append(ia)
                g["bc"].append(int(cjk))
                g["b"].append(jb)
        st["sd"] = sd
        st["sl"] = sl
        st["rc"] = sorted(set(touched))
        steps.append(st)
    return steps, cls, dense_slot, lr_slot, nd, nl


def _stack_facto_tables(steps, DUMMY_D, DUMMY_L):
    """Stack every step's phase lists into ONE set of padded int32 tables
    (widths = pow2 cover of the per-phase maxima over all steps) for a
    single ``lax.scan``: the whole factorization compiles to one program
    and dispatches once.  The padded no-op rows cost < 2x the ideal Schur
    flops (measured; the einsums are far from the walltime bottleneck),
    while host dispatch and per-shape compiles — the actual bottleneck —
    drop from O(nL) to O(1).  Pad rules keep padded rows no-ops: dense
    slots pad with the zero dummy dense slot, LR slots with the zero dummy
    LR slot, class columns with DENSE (padded Schur rows read
    D[dummy] = 0)."""
    def widths(st):
        return (
            _pow2c(len(st["cd"])), _pow2c(len(st["cl"])),
            _pow2c(len(st["dfd"])),
            _pow2c(len(st["sd"]["t"])), _pow2c(len(st["sl"]["t"])),
            _pow2c(len(st["rc"])),
        )

    wmax = tuple(max(t) for t in zip(*(widths(st) for st in steps)))
    groups: list = [(wmax, list(steps))]

    out = []
    for (wcd, wcl, wdf, wsd, wsl, wrc), sts in groups:
        L = len(sts)

        def pad2(get, W, dummy):
            t = np.full((L, W), dummy, np.int32)
            for r, st in enumerate(sts):
                v = get(st)
                t[r, : len(v)] = v
            return jnp.asarray(t)

        tab = {
            "kk": jnp.asarray(np.array([st["k"] for st in sts], np.int32)),
            "ds": jnp.asarray(np.array([st["ds"] for st in sts], np.int32)),
        }
        if wcd:
            tab["cd"] = pad2(lambda s: s["cd"], wcd, DUMMY_D)
        if wcl:
            tab["cl"] = pad2(lambda s: s["cl"], wcl, DUMMY_L)
        if wdf:
            tab["dfd"] = pad2(lambda s: s["dfd"], wdf, DUMMY_D)
            tab["dfl"] = pad2(lambda s: s["dfl"], wdf, DUMMY_L)
        if wsd:
            tab["sd_ac"] = pad2(lambda s: s["sd"]["ac"], wsd, DENSE)
            tab["sd_a"] = pad2(lambda s: s["sd"]["a"], wsd, DUMMY_D)
            tab["sd_bc"] = pad2(lambda s: s["sd"]["bc"], wsd, DENSE)
            tab["sd_b"] = pad2(lambda s: s["sd"]["b"], wsd, DUMMY_D)
            tab["sd_t"] = pad2(lambda s: s["sd"]["t"], wsd, DUMMY_D)
        if wsl:
            tab["sl_ac"] = pad2(lambda s: s["sl"]["ac"], wsl, DENSE)
            tab["sl_a"] = pad2(lambda s: s["sl"]["a"], wsl, DUMMY_D)
            tab["sl_bc"] = pad2(lambda s: s["sl"]["bc"], wsl, DENSE)
            tab["sl_b"] = pad2(lambda s: s["sl"]["b"], wsl, DUMMY_D)
            tab["sl_t"] = pad2(lambda s: s["sl"]["t"], wsl, DUMMY_L)
        if wrc:
            tab["rc"] = pad2(lambda s: s["rc"], wrc, DUMMY_L)
        out.append(tab)
    return out


@partial(
    precise_jit,
    static_argnames=("eps", "Rh", "herm"),
    donate_argnums=(0, 1, 2, 3, 4, 5),
)
def _k_facto_scan(D, U, V, ranks, piv_all, capped, tab, eps, Rh, herm):
    """One ``lax.scan`` over a group of elimination steps with identical
    phase widths: the whole right-looking factorization executes as a
    handful of compiled programs instead of O(nL) host-dispatched kernels.
    Buffers are donated — the scan updates them in
    place."""
    has_cd = "cd" in tab
    has_cl = "cl" in tab
    has_df = "dfd" in tab
    has_sd = "sd_t" in tab
    has_sl = "sl_t" in tab
    has_rc = "rc" in tab

    def body(carry, row):
        D, U, V, ranks, piv_all, capped = carry
        ds = row["ds"]
        if herm:
            D = _b_chol_diag(D, ds)
            piv_k = jnp.zeros((D.shape[1],), jnp.int32)
        else:
            D, piv_k = _b_lu_diag(D, ds)
        piv_all = piv_all.at[row["kk"]].set(piv_k)
        diag_k = D[ds]
        if has_cd:
            D = (
                _b_col_panel_dense_chol(D, row["cd"], diag_k)
                if herm
                else _b_col_panel_dense(D, row["cd"], diag_k, piv_k)
            )
        if has_cl:
            V = (
                _b_col_panel_lr_chol(V, row["cl"], diag_k)
                if herm
                else _b_col_panel_lr(V, row["cl"], diag_k, piv_k)
            )
        if has_df:
            D = _b_densify(D, row["dfd"], U, V, row["dfl"])
        if has_sd:
            D = _b_schur_dense_target(
                D, U, V, D, U, V, D,
                row["sd_ac"], row["sd_a"], row["sd_bc"], row["sd_b"],
                row["sd_t"], Rh, herm_b=herm,
            )
        if has_sl:
            U, V, ranks = _b_schur_lr_target(
                D, U, V, D, U, V, U, V, ranks, ranks, ranks,
                row["sl_ac"], row["sl_a"], row["sl_bc"], row["sl_b"],
                row["sl_t"], Rh, herm_b=herm,
            )
        if has_rc:
            U, V, ranks, capped = _b_recompress(
                U, V, ranks, row["rc"], eps, Rh, capped
            )
        return (D, U, V, ranks, piv_all, capped), None

    carry, _ = jax.lax.scan(body, (D, U, V, ranks, piv_all, capped), tab)
    return carry


def _facto_scanned(A: BLRMatrix, eps: float, kind: str,
                   auto_escalate: int, error_estimate: bool) -> BLRMatrix:
    """Shared scanned driver for :func:`blr_lu` / :func:`blr_cholesky`."""
    nL, b, Rh = A.nL, A.b, A.R_half
    t0 = time.perf_counter()
    steps, cls, dense_slot, lr_slot, nd, nl = _facto_schedule(A, kind)

    dtype = A.dtype
    D = jnp.concatenate(
        [A.D[:-1], jnp.zeros((nd - (A.D.shape[0] - 1) + 1, b, b), dtype)], axis=0
    )
    U = jnp.concatenate(
        [A.U[:-1], jnp.zeros((nl - (A.U.shape[0] - 1) + 1, b, A.R_buf), dtype)], axis=0
    )
    V = jnp.concatenate(
        [A.V[:-1], jnp.zeros((nl - (A.V.shape[0] - 1) + 1, A.R_buf, b), dtype)], axis=0
    )
    ranks = jnp.concatenate(
        [A.ranks[:-1], jnp.zeros((nl - (A.ranks.shape[0] - 1) + 1,), jnp.int32)]
    )
    piv_all = jnp.zeros((nL, b), jnp.int32)
    capped = jnp.zeros((U.shape[0],), jnp.int32)
    herm = kind == "chol"
    tabs = _stack_facto_tables(steps, nd, nl)
    for tab in tabs:
        D, U, V, ranks, piv_all, capped = _k_facto_scan(
            D, U, V, ranks, piv_all, capped, tab, float(eps), Rh, herm
        )

    out = BLRMatrix(
        n=A.n,
        cell_off=A.cell_off,
        cell_size=A.cell_size,
        b=b,
        cls=cls,
        dense_slot=dense_slot,
        lr_slot=lr_slot,
        D=D,
        U=U,
        V=V,
        ranks=ranks,
        piv=piv_all if kind == "lu" else None,
        R_half=Rh,
        epsilon=eps,
        factorized=True,
        kind=kind,
        permutation=A.permutation,
        info=dict(A.info),
    )
    out.info[f"{'lu' if kind == 'lu' else 'cholesky'}_walltime"] = (
        time.perf_counter() - t0
    )
    out.info["n_scan_groups"] = len(tabs)
    out.info["n_rank_capped_cells"] = int(np.asarray(capped[:nl]).sum())
    out.info["R_half"] = Rh
    if out.info["n_rank_capped_cells"] > 0 and auto_escalate > 0:
        redo = blr_lu if kind == "lu" else blr_cholesky
        return redo(widen_blr(A, 2 * Rh), eps, auto_escalate - 1, error_estimate)
    if error_estimate:
        out.info["backward_error_est"] = blr_backward_error(A, out, n_probe=2)
    return out


def blr_lu(A: BLRMatrix, epsilon: Optional[float] = None,
           auto_escalate: int = 1, error_estimate: bool = True) -> BLRMatrix:
    """Right-looking BLR LU (the H-LU equivalent, factorization.hpp:19-79).

    Returns a new factorized BLRMatrix: diagonal cells hold their pivoted LU
    factors, subdiagonal cells hold L_ik = A_ik A_kk⁻¹, superdiagonal cells
    hold the updated U_kj = A_kj.

    Accuracy guard: cells whose epsilon-rank exceeds the R_half cap during
    the Schur recompressions are counted (``info['n_rank_capped_cells']``);
    with ``auto_escalate`` > 0 the factorization re-runs with doubled
    R_half buffers until no cell is capped (or the budget is spent).  With
    ``error_estimate`` a stochastic backward error ‖(A − LU)Z‖/‖AZ‖ is
    reported in ``info['backward_error_est']``."""
    eps = A.epsilon if epsilon is None else epsilon
    return _facto_scanned(A, eps, "lu", auto_escalate, error_estimate)


def blr_cholesky(A: BLRMatrix, epsilon: Optional[float] = None,
                 auto_escalate: int = 1,
                 error_estimate: bool = True) -> BLRMatrix:
    """Right-looking BLR Cholesky A = L·L^H — the H-Cholesky equivalent
    (``factorization.hpp:131-205``): per step k factor the diagonal cell
    (potrf), transform the subdiagonal column panel L_ik = A_ik L_kk^{-H},
    then Schur-update the trailing LOWER triangle A_ij -= L_ik L_jk^H.

    Only the lower triangle of ``A`` is read (real symmetric or complex
    hermitian positive definite, matching LAPACK potrf); the returned matrix
    stores L in the lower triangle and zeros the upper class map."""
    eps = A.epsilon if epsilon is None else epsilon
    return _facto_scanned(A, eps, "chol", auto_escalate, error_estimate)


# ======================================================================
# solve and products
# ======================================================================


@partial(precise_jit, static_argnames=("Rh", "t_cells", "c_cells", "diag"))
def _k_block_sweep(D, U, V, piv_g, y, order, dsl, dj, lsl, lj, dgs,
                   Rh, t_cells, c_cells, diag):
    """Generic block-triangular sweep as ONE ``lax.scan`` over block rows —
    the level-scheduled batched replacement for the reference's recursive
    triangular solves (triangular_hmatrix_matrix_solve.hpp:18,114,
    factorization.hpp:119-128).

    Per visited row (in ``order``): gather the row's off-diagonal cells
    (dense slots ``dsl`` reading source rows ``dj``; LR slots ``lsl``/``lj``,
    padded with the zero dummy slot), accumulate their products with the
    already-solved rows, subtract, then apply the diagonal operation.

    t_cells/c_cells: apply off-diagonal cells transposed / conjugated.
    diag: 'none' (unit block diagonal), 'lu'/'lu_t'/'lu_c' (factored diag
    cell + pivots), 'lo'/'lo_t'/'lo_c' and 'up'/'up_t'/'up_c' (triangular
    diag cell, optional (conj-)transpose)."""

    def body(yc, row):
        i, ds, djr, ls, ljr, dg, pv = row
        Dw = D[ds]
        Uw = U[ls][:, :, :Rh]
        Vw = V[ls][:, :Rh, :]
        if c_cells:
            Dw, Uw, Vw = jnp.conj(Dw), jnp.conj(Uw), jnp.conj(Vw)
        yd = yc[djr]
        yl = yc[ljr]
        if t_cells:
            acc = jnp.einsum("wji,wjk->ik", Dw, yd)
            acc = acc + jnp.einsum("wri,wjr,wjk->ik", Vw, Uw, yl)
        else:
            acc = jnp.einsum("wij,wjk->ik", Dw, yd)
            acc = acc + jnp.einsum("wir,wrj,wjk->ik", Uw, Vw, yl)
        r = yc[i] - acc.astype(yc.dtype)
        dgD = D[dg].astype(yc.dtype)
        if diag == "none":
            xi = r
        elif diag.startswith("lu"):
            tr = {"lu": 0, "lu_t": 1, "lu_c": 2}[diag]
            xi = jax.scipy.linalg.lu_solve((dgD, pv), r, trans=tr)
        else:
            lower = diag.startswith("lo")
            tr = 0 if diag in ("lo", "up") else (1 if diag.endswith("_t") else 2)
            xi = jax.scipy.linalg.solve_triangular(dgD, r, lower=lower, trans=tr)
        yc = yc.at[i].set(xi.astype(yc.dtype))
        return yc, None

    yc, _ = jax.lax.scan(body, y, (order, dsl, dj, lsl, lj, dgs, piv_g))
    return yc


def _sweep_tables(F: BLRMatrix, which: str, trans: str):
    """Host-side plan for one block-triangular sweep over factor ``which``
    ('L' strict lower + diag, 'U' strict upper + diag) applied as
    ``op(T, trans)``.  Returns numpy (order, dsl, dj, lsl, lj, dgs) where
    padded entries point at the zero dummy slots.  Cached on F.info."""
    key = ("_sweep", which, trans != "N")
    cached = F.cache.get(key)
    if cached is not None:
        return cached
    nL = F.nL
    lower = which == "L"
    fwd = lower == (trans == "N")
    order = list(range(nL)) if fwd else list(range(nL - 1, -1, -1))
    DUMMY_D = int(np.asarray(F.D).shape[0]) - 1
    DUMMY_L = int(np.asarray(F.U).shape[0]) - 1
    rows = []
    for i in order:
        ds, djs, ls, ljs = [], [], [], []
        if trans == "N":
            rng = range(i) if lower else range(i + 1, nL)
            for j in rng:
                c = F.cls[i, j]
                if c == DENSE:
                    ds.append(int(F.dense_slot[i, j])); djs.append(j)
                elif c == LR:
                    ls.append(int(F.lr_slot[i, j])); ljs.append(j)
        else:
            # op(T) row i uses cells (j, i) of T, applied transposed
            rng = range(i + 1, nL) if lower else range(i)
            for j in rng:
                c = F.cls[j, i]
                if c == DENSE:
                    ds.append(int(F.dense_slot[j, i])); djs.append(j)
                elif c == LR:
                    ls.append(int(F.lr_slot[j, i])); ljs.append(j)
        rows.append((ds, djs, ls, ljs))
    Wd = max(1, max(len(r[0]) for r in rows))
    Wl = max(1, max(len(r[2]) for r in rows))
    dsl = np.full((nL, Wd), DUMMY_D, np.int32)
    dj = np.zeros((nL, Wd), np.int32)
    lsl = np.full((nL, Wl), DUMMY_L, np.int32)
    lj = np.zeros((nL, Wl), np.int32)
    for t, (ds, djs, ls, ljs) in enumerate(rows):
        dsl[t, : len(ds)] = ds
        dj[t, : len(djs)] = djs
        lsl[t, : len(ls)] = ls
        lj[t, : len(ljs)] = ljs
    dgs = np.array([int(F.dense_slot[i, i]) for i in order], np.int32)
    plan = (
        np.asarray(order, np.int32), dsl, dj, lsl, lj, dgs,
    )
    F.cache[key] = plan
    return plan


def _cells_plan(F: BLRMatrix):
    """Pad/compact index maps for cell layout <-> flat vectors (cached)."""
    plan = F.cache.get("_cells")
    if plan is None:
        ar = np.arange(F.b)[None, :]
        pad_idx = np.minimum(F.cell_off[:, None] + ar, F.n - 1)
        mask = ar < F.cell_size[:, None]
        keep = np.concatenate(
            [i * F.b + np.arange(sz) for i, sz in enumerate(F.cell_size)]
        )
        plan = (
            jnp.asarray(pad_idx, jnp.int32),
            jnp.asarray(mask),
            jnp.asarray(keep, jnp.int32),
        )
        F.cache["_cells"] = plan
    return plan


def _to_cells(F: BLRMatrix, x, dtype):
    pad_idx, mask, _ = _cells_plan(F)
    return jnp.where(mask[:, :, None], x[pad_idx].astype(dtype), 0)


def _from_cells(F: BLRMatrix, yc):
    _, _, keep = _cells_plan(F)
    return yc.reshape(F.nL * F.b, yc.shape[-1])[keep]


def _run_sweep(F: BLRMatrix, y, which: str, trans: str, diag: str,
               conj_cells: bool = False):
    order, dsl, dj, lsl, lj, dgs = _sweep_tables(F, which, trans)
    piv = F.piv if F.piv is not None else jnp.zeros((F.nL, F.b), jnp.int32)
    piv_g = piv[jnp.asarray(order)]
    return _k_block_sweep(
        F.D, F.U, F.V, piv_g, y,
        jnp.asarray(order), jnp.asarray(dsl), jnp.asarray(dj),
        jnp.asarray(lsl), jnp.asarray(lj), jnp.asarray(dgs),
        F.R_half, trans != "N", conj_cells or trans == "C", diag,
    )


def blr_solve(F: BLRMatrix, rhs, user_numbering: bool = False,
              trans: str = "N"):
    """Solve op(A) x = rhs with a factorized BLR matrix — the lu_solve /
    cholesky_solve equivalent (factorization.hpp:119-128,245-273) with the
    reference's trans ∈ {'N','T','C'} surface.

    LU stores A = L̂·Û with unit-block-diagonal L̂ and factored diagonal
    cells in Û; Cholesky stores A = L·L^H.  Each sweep is one scanned
    batched kernel (``_k_block_sweep``)."""
    if not F.factorized:
        raise ValueError("matrix is not factorized; call blr_lu first")
    rhs = jnp.asarray(rhs)
    squeeze = rhs.ndim == 1
    if squeeze:
        rhs = rhs[:, None]
    if user_numbering:
        rhs = rhs[jnp.asarray(F.permutation)]
    dtype = jnp.result_type(F.dtype, rhs.dtype)
    y = _to_cells(F, rhs, dtype)

    if F.kind == "chol":
        if trans == "T":
            # A^T = conj(A) for hermitian A: solve via global conj trick
            y = jnp.conj(y)
        y = _run_sweep(F, y, "L", "N", "lo")
        y = _run_sweep(F, y, "L", "C", "lo_c")
        if trans == "T":
            y = jnp.conj(y)
    else:
        if trans == "N":
            y = _run_sweep(F, y, "L", "N", "none")
            y = _run_sweep(F, y, "U", "N", "lu")
        else:
            # op(A) = op(Û)·op(L̂): sweep Û^T/H first, then L̂^T/H
            d = "lu_t" if trans == "T" else "lu_c"
            y = _run_sweep(F, y, "U", trans, d)
            y = _run_sweep(F, y, "L", trans, "none")

    out = _from_cells(F, y)
    if user_numbering:
        out = jnp.zeros_like(out).at[jnp.asarray(F.permutation)].set(out)
    return out[:, 0] if squeeze else out


def blr_triangular_solve(F: BLRMatrix, B, which: str = "L", side: str = "L",
                         trans: str = "N"):
    """Standalone block-triangular solve with one factor of a BLR matrix:
    ``op(T)·X = B`` (side 'L') or ``X·op(T) = B`` (side 'R'), where T is the
    L or U factor of a factorized BLR matrix, or the (lower/upper) triangle
    of an unfactorized triangular BLR matrix.

    The reference surface this matches: triangular_hmatrix_matrix_solve.hpp:
    18 (side 'L'), :114 (side 'R'), with transa ∈ {'N','T','C'}.  ``B`` may
    also be a ``(Ub, Vb)`` low-rank factor pair (the
    triangular_hmatrix_lrmat_solve.hpp variant): side 'L' solves on the U
    factor, side 'R' on the V factor, returning a new pair."""
    if which not in ("L", "U"):
        raise ValueError("which must be 'L' or 'U'")
    if isinstance(B, tuple):
        Ub, Vb = B
        if side == "L":
            return blr_triangular_solve(F, jnp.asarray(Ub), which, "L", trans), Vb
        return Ub, blr_triangular_solve(F, jnp.asarray(Vb), which, "R", trans)

    B = jnp.asarray(B)
    if side == "R":
        # X op(T) = B  <=>  op(T)^T X^T = B^T ; 'C' via the conj trick
        if trans == "C":
            out = blr_triangular_solve(F, jnp.conj(B).T, which, "L", "N")
            return jnp.conj(out).T
        flipped = "T" if trans == "N" else "N"
        return blr_triangular_solve(F, B.T, which, "L", flipped).T

    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]
    dtype = jnp.result_type(F.dtype, B.dtype)
    y = _to_cells(F, B, dtype)

    if F.factorized and F.kind == "chol":
        if which == "L":
            d = {"N": "lo", "T": "lo_t", "C": "lo_c"}[trans]
            y = _run_sweep(F, y, "L", trans, d)
        else:
            # 'U' factor of a Cholesky factorization is L^H
            if trans == "N":  # L^H x = b
                y = _run_sweep(F, y, "L", "C", "lo_c")
            elif trans == "C":  # (L^H)^H = L
                y = _run_sweep(F, y, "L", "N", "lo")
            else:  # (L^H)^T = conj(L): conj trick
                y = jnp.conj(_run_sweep(F, jnp.conj(y), "L", "N", "lo"))
    elif F.factorized:
        if which == "L":
            d = "none"
        else:
            d = {"N": "lu", "T": "lu_t", "C": "lu_c"}[trans]
        y = _run_sweep(F, y, which, trans, d)
    else:
        # unfactorized triangular BLR matrix: diag cells are triangular
        base = "lo" if which == "L" else "up"
        d = base if trans == "N" else base + ("_t" if trans == "T" else "_c")
        y = _run_sweep(F, y, which, trans, d)

    out = _from_cells(F, y)
    return out[:, 0] if squeeze else out


@partial(precise_jit, static_argnames=("Rh",))
def _k_blr_matvec(D, U, V, xc, d_i, d_j, d_slot, l_i, l_j, l_slot, Rh):
    """All-cells batched y = A x: two einsums + two scatter-adds."""
    yc = jnp.zeros_like(xc)
    cd = jnp.einsum("cij,cjk->cik", D[d_slot].astype(xc.dtype), xc[d_j])
    yc = yc.at[d_i].add(cd)
    cl = jnp.einsum(
        "cir,crj,cjk->cik",
        U[l_slot][:, :, :Rh].astype(xc.dtype),
        V[l_slot][:, :Rh, :].astype(xc.dtype),
        xc[l_j],
    )
    yc = yc.at[l_i].add(cl)
    return yc


def blr_matvec(A: BLRMatrix, x):
    """y = A x in cluster numbering: one batched kernel over all cells."""
    x = jnp.asarray(x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    dtype = jnp.result_type(A.dtype, x.dtype)
    xc = _to_cells(A, x, dtype)

    plan = A.cache.get("_matvec")
    if plan is None:
        DUMMY_D = int(np.asarray(A.D).shape[0]) - 1
        DUMMY_L = int(np.asarray(A.U).shape[0]) - 1
        di, dj_ = np.nonzero(A.cls == DENSE)
        li, lj_ = np.nonzero(A.cls == LR)
        dsl = A.dense_slot[di, dj_]
        lsl = A.lr_slot[li, lj_]
        def padded(a, dummy):
            n = max(1, len(a))
            p = 1
            while p < n:
                p *= 2
            out = np.full(p, dummy, np.int32)
            out[: len(a)] = a
            return jnp.asarray(out)
        plan = (
            padded(di, 0), padded(dj_, 0), padded(dsl, DUMMY_D),
            padded(li, 0), padded(lj_, 0), padded(lsl, DUMMY_L),
        )
        A.cache["_matvec"] = plan
    d_i, d_j, d_slot, l_i, l_j, l_slot = plan
    yc = _k_blr_matvec(A.D, A.U, A.V, xc, d_i, d_j, d_slot, l_i, l_j, l_slot,
                       A.R_half)
    out = _from_cells(A, yc)
    return out[:, 0] if squeeze else out


def blr_matmul(A: BLRMatrix, B: BLRMatrix, epsilon: Optional[float] = None) -> BLRMatrix:
    """C = A·B in BLR form — the compressed×compressed product
    (internal_add_hmatrix_hmatrix_product, add_hmatrix_hmatrix_product.hpp:
    24-312) with truncated low-rank accumulation.

    Operands on different grids are re-tiled onto a common grid first (the
    flat-layout equivalent of the reference's inconsistent-tree recursion,
    add_hmatrix_hmatrix_product.hpp:31-74)."""
    if (
        A.nL != B.nL
        or A.b != B.b
        or not np.array_equal(np.asarray(A.cell_off), np.asarray(B.cell_off))
    ):
        from .conversion import common_grid_blr

        A, B = common_grid_blr(A, B)
    eps = A.epsilon if epsilon is None else epsilon
    nL, b, Rh = A.nL, A.b, max(A.R_half, B.R_half)

    # symbolic: C classification
    clsC = np.zeros((nL, nL), np.int8)
    for i in range(nL):
        for j in range(nL):
            for k in range(nL):
                a, c = A.cls[i, k], B.cls[k, j]
                if a == ZERO or c == ZERO:
                    continue
                contrib = DENSE if (a == DENSE and c == DENSE) else LR
                if clsC[i, j] == ZERO:
                    clsC[i, j] = contrib
                elif contrib == DENSE:
                    clsC[i, j] = DENSE

    dense_slot = np.full((nL, nL), -1, np.int32)
    lr_slot = np.full((nL, nL), -1, np.int32)
    nd = nl = 0
    for i in range(nL):
        for j in range(nL):
            if clsC[i, j] == DENSE:
                dense_slot[i, j] = nd
                nd += 1
            elif clsC[i, j] == LR:
                lr_slot[i, j] = nl
                nl += 1
    dtype = jnp.result_type(A.dtype, B.dtype)
    R_buf = 2 * Rh
    D = jnp.zeros((nd + 1, b, b), dtype)
    U = jnp.zeros((nl + 1, b, R_buf), dtype)
    V = jnp.zeros((nl + 1, R_buf, b), dtype)
    ranks = jnp.zeros((nl + 1,), jnp.int32)
    C = BLRMatrix(
        n=A.n,
        cell_off=A.cell_off,
        cell_size=A.cell_size,
        b=b,
        cls=clsC,
        dense_slot=dense_slot,
        lr_slot=lr_slot,
        D=D,
        U=U,
        V=V,
        ranks=ranks,
        R_half=Rh,
        epsilon=eps,
        permutation=A.permutation,
    )
    return _blr_matmul_batched(A, B, C, eps)


def _widen_lr(M: BLRMatrix, Rh: int):
    """Return (D, U, V, ranks) of M with LR buffers padded to width >= Rh
    so the shared Schur kernels can slice [:Rh] on either operand."""
    if M.U.shape[2] >= Rh:
        return M.D, M.U, M.V, M.ranks
    padU = jnp.zeros((M.U.shape[0], M.b, Rh - M.U.shape[2]), M.dtype)
    padV = jnp.zeros((M.V.shape[0], Rh - M.V.shape[1], M.b), M.dtype)
    return (
        M.D,
        jnp.concatenate([M.U, padU], axis=2),
        jnp.concatenate([M.V, padV], axis=1),
        M.ranks,
    )


def _blr_matmul_batched(A: BLRMatrix, B: BLRMatrix, C: BLRMatrix, eps):
    """Batched middle-index sweep: for each k, one batched Schur-style kernel
    per target class accumulates all A_ik·B_kj contributions, then one
    batched recompression truncates touched LR targets.  O(nL) device
    dispatches total — same schedule machinery as ``blr_lu``, replacing the
    reference's per-(i,j,k) recursion (add_hmatrix_hmatrix_product.hpp:24-312)."""
    nL, Rh = A.nL, C.R_half
    Da, Ua, Va, ranks_a = _widen_lr(A, Rh)
    Db, Ub, Vb, ranks_b = _widen_lr(B, Rh)
    D, U, V, ranks = C.D, C.U, C.V, C.ranks
    DUMMY_DA = Da.shape[0] - 1
    DUMMY_DB = Db.shape[0] - 1
    DUMMY_DT = D.shape[0] - 1
    DUMMY_LT = U.shape[0] - 1

    for k in range(nL):
        tgt_dense = {"ia_cls": [], "ia": [], "jb_cls": [], "jb": [], "t": []}
        tgt_lr = {"ia_cls": [], "ia": [], "jb_cls": [], "jb": [], "t": []}
        touched_lr = []
        for i in range(nL):
            cik = A.cls[i, k]
            if cik == ZERO:
                continue
            ia = int(A.dense_slot[i, k] if cik == DENSE else A.lr_slot[i, k])
            for j in range(nL):
                ckj = B.cls[k, j]
                if ckj == ZERO:
                    continue
                jb = int(B.dense_slot[k, j] if ckj == DENSE else B.lr_slot[k, j])
                if C.cls[i, j] == DENSE:
                    g = tgt_dense
                    g["t"].append(int(C.dense_slot[i, j]))
                else:
                    g = tgt_lr
                    g["t"].append(int(C.lr_slot[i, j]))
                    touched_lr.append(int(C.lr_slot[i, j]))
                g["ia_cls"].append(cik)
                g["ia"].append(ia)
                g["jb_cls"].append(ckj)
                g["jb"].append(jb)

        if tgt_dense["t"]:
            npad = len(tgt_dense["t"])
            ia_cls, jb_cls = _pad_pow2(
                [tgt_dense["ia_cls"], tgt_dense["jb_cls"]], DENSE
            )
            ia = _pad_pow2([tgt_dense["ia"]], DUMMY_DA)[0]
            jb = _pad_pow2([tgt_dense["jb"]], DUMMY_DB)[0]
            t = _pad_pow2([tgt_dense["t"]], DUMMY_DT)[0]
            ia_cls = jnp.where(jnp.arange(ia_cls.shape[0]) < npad, ia_cls, DENSE)
            jb_cls = jnp.where(jnp.arange(jb_cls.shape[0]) < npad, jb_cls, DENSE)
            D = _k_schur_dense_target(
                Da, Ua, Va, Db, Ub, Vb, D,
                ia_cls, ia, jb_cls, jb, t, Rh, neg=False,
            )
        if tgt_lr["t"]:
            npad = len(tgt_lr["t"])
            ia_cls, jb_cls = _pad_pow2([tgt_lr["ia_cls"], tgt_lr["jb_cls"]], DENSE)
            ia = _pad_pow2([tgt_lr["ia"]], DUMMY_DA)[0]
            jb = _pad_pow2([tgt_lr["jb"]], DUMMY_DB)[0]
            t = _pad_pow2([tgt_lr["t"]], DUMMY_LT)[0]
            ia = jnp.where(jnp.arange(ia.shape[0]) < npad, ia, DUMMY_DA)
            jb = jnp.where(jnp.arange(jb.shape[0]) < npad, jb, DUMMY_DB)
            U, V, ranks = _k_schur_lr_target(
                Da, Ua, Va, Db, Ub, Vb, U, V, ranks, ranks_a, ranks_b,
                ia_cls, ia, jb_cls, jb, t, Rh, neg=False,
            )
            sl = sorted(set(touched_lr))
            (slots,) = _pad_pow2([sl], DUMMY_LT)
            U, V, ranks = _k_recompress(U, V, ranks, slots, eps, Rh)
    C.D, C.U, C.V, C.ranks = D, U, V, ranks
    return C


# ======================================================================
# factorization accuracy guard
# ======================================================================


def widen_blr(A: BLRMatrix, R_half: int) -> BLRMatrix:
    """Return a copy of (unfactorized) ``A`` with LR buffers widened to a
    larger ``R_half`` — the rank-cap escalation step.  Cell contents are
    unchanged (padding is zero)."""
    if A.factorized:
        raise ValueError("widen_blr applies to unfactorized matrices")
    R_half = int(-(-R_half // 8) * 8)
    if R_half <= A.R_half:
        return A
    R_buf = 2 * R_half
    padU = jnp.zeros((A.U.shape[0], A.b, R_buf - A.U.shape[2]), A.dtype)
    padV = jnp.zeros((A.V.shape[0], R_buf - A.V.shape[1], A.b), A.dtype)
    from dataclasses import replace

    return replace(
        A,
        U=jnp.concatenate([A.U, padU], axis=2),
        V=jnp.concatenate([A.V, padV], axis=1),
        R_half=R_half,
        info=dict(A.info),
    )


def _cells_matvec_tables(F: BLRMatrix, which: str):
    """Padded all-cells tables restricted to the strict ``which`` triangle
    ('L' j<i, 'U' j>i), for the factor-apply diagnostics."""
    DUMMY_D = int(np.asarray(F.D).shape[0]) - 1
    DUMMY_L = int(np.asarray(F.U).shape[0]) - 1
    di, dj_, li, lj_, dsl, lsl = [], [], [], [], [], []
    for i in range(F.nL):
        rng = range(i) if which == "L" else range(i + 1, F.nL)
        for j in rng:
            c = F.cls[i, j]
            if c == DENSE:
                di.append(i); dj_.append(j); dsl.append(int(F.dense_slot[i, j]))
            elif c == LR:
                li.append(i); lj_.append(j); lsl.append(int(F.lr_slot[i, j]))

    def padded(a, dummy):
        n = max(1, len(a))
        p = 1
        while p < n:
            p *= 2
        out = np.full(p, dummy, np.int32)
        out[: len(a)] = a
        return jnp.asarray(out)

    return (
        padded(di, 0), padded(dj_, 0), padded(dsl, DUMMY_D),
        padded(li, 0), padded(lj_, 0), padded(lsl, DUMMY_L),
    )


def _factor_matvec(F: BLRMatrix, z):
    """Apply the FACTORIZATION as an operator: (L̂·Û) z for LU, (L·L^H) z
    for Cholesky — used to sample the backward error ‖A − LU‖."""
    z = jnp.asarray(z)
    squeeze = z.ndim == 1
    if squeeze:
        z = z[:, None]
    dtype = jnp.result_type(F.dtype, z.dtype)
    zc = _to_cells(F, z, dtype)  # [nL, b, k]
    nL, b = F.nL, F.b
    k = z.shape[1]
    diag = F.D[jnp.asarray([int(F.dense_slot[i, i]) for i in range(nL)])]

    if F.kind == "chol":
        Lw = jnp.tril(diag)
        # w = L^H z: strict-lower cells (j,i) conj-transposed + diag L_i^H
        lowT = _cells_matvec_tables(F, "L")
        d_i, d_j, d_slot, l_i, l_j, l_slot = lowT
        # conj-transposed apply: cell L_ij contributes L_ij^H z_i to row j
        wc = jnp.einsum("cji,cjk->cik", jnp.conj(F.D[d_slot]), zc[d_i])
        w = jnp.zeros_like(zc).at[d_j].add(wc)
        Rh = F.R_half
        wl = jnp.einsum(
            "cri,cjr,cjk->cik",
            jnp.conj(F.V[l_slot][:, :Rh, :]),
            jnp.conj(F.U[l_slot][:, :, :Rh]),
            zc[l_i],
        )
        w = w.at[l_j].add(wl)
        w = w + jnp.einsum("cji,cjk->cik", jnp.conj(Lw), zc)
        # y = L w
        y = _k_blr_matvec_cells(F, w, "L")
        y = y + jnp.einsum("cij,cjk->cik", Lw, w)
    else:
        # w = Û z: strict upper cells + diag A_kk z (reconstructed from LU)
        w = _k_blr_matvec_cells(F, zc, "U")
        lu = diag
        Ut = jnp.triu(lu)
        Lt = jnp.tril(lu, -1) + jnp.eye(b, dtype=lu.dtype)[None]
        t = jnp.einsum("cij,cjk->cik", Ut, zc)
        t = jnp.einsum("cij,cjk->cik", Lt, t)
        # A_kk = (L U)[invp] with p from forward piv swaps
        piv = np.asarray(F.piv)
        invp = np.zeros((nL, b), np.int64)
        for c in range(nL):
            p = np.arange(b)
            for i in range(b):
                pi = int(piv[c, i])
                p[[i, pi]] = p[[pi, i]]
            invp[c] = np.argsort(p)
        t = jnp.take_along_axis(t, jnp.asarray(invp)[:, :, None], axis=1)
        w = w + t
        # y = L̂ w (unit diag)
        y = _k_blr_matvec_cells(F, w, "L") + w

    out = _from_cells(F, y)
    return out[:, 0] if squeeze else out


def _k_blr_matvec_cells(F: BLRMatrix, xc, which: str):
    """Batched product over the strict 'L'/'U' cells only (cells applied
    un-transposed)."""
    key = ("_cellsmv", which)
    tabs = F.cache.get(key)
    if tabs is None:
        tabs = _cells_matvec_tables(F, which)
        F.cache[key] = tabs
    d_i, d_j, d_slot, l_i, l_j, l_slot = tabs
    yc = jnp.zeros_like(xc)
    cd = jnp.einsum("cij,cjk->cik", F.D[d_slot].astype(xc.dtype), xc[d_j])
    yc = yc.at[d_i].add(cd)
    Rh = F.R_half
    cl = jnp.einsum(
        "cir,crj,cjk->cik",
        F.U[l_slot][:, :, :Rh].astype(xc.dtype),
        F.V[l_slot][:, :Rh, :].astype(xc.dtype),
        xc[l_j],
    )
    yc = yc.at[l_i].add(cl)
    return yc


def blr_backward_error(A: BLRMatrix, F: BLRMatrix, n_probe: int = 4,
                       seed: int = 0):
    """Stochastic backward-error estimate of a factorization:
    ‖(A − L·U) Z‖_F / ‖A Z‖_F over ``n_probe`` Gaussian probes — the
    accuracy guard the reference lacks (its H-LU is silently approximate
    too; factorization.hpp:19-79)."""
    rng = np.random.default_rng(seed)
    z = jnp.asarray(rng.standard_normal((A.n, n_probe)))
    if jnp.issubdtype(A.dtype, jnp.complexfloating):
        # complex probes: independent Gaussian real and imaginary parts
        rt = np.finfo(np.dtype(A.dtype)).dtype
        z = jax.lax.complex(
            z.astype(rt), jnp.asarray(rng.standard_normal((A.n, n_probe)), rt)
        )
    az = blr_matvec(A, z)
    fz = _factor_matvec(F, z)
    num = jnp.linalg.norm(az - fz)
    den = jnp.linalg.norm(az)
    return float(num / jnp.where(den == 0, 1.0, den))


# ======================================================================
# compressed-RHS triangular solve (H-H solve surface)
# ======================================================================


def blr_transpose(B: BLRMatrix, conj: bool = False) -> BLRMatrix:
    """op(B) as a new BLRMatrix (cells mirrored, factors swapped)."""
    from dataclasses import replace

    D = jnp.swapaxes(B.D, 1, 2)
    U = jnp.swapaxes(B.V, 1, 2)
    V = jnp.swapaxes(B.U, 1, 2)
    if conj:
        D, U, V = jnp.conj(D), jnp.conj(U), jnp.conj(V)
    return replace(
        B,
        cls=B.cls.T.copy(),
        dense_slot=B.dense_slot.T.copy(),
        lr_slot=B.lr_slot.T.copy(),
        D=D,
        U=U,
        V=V,
        info=dict(B.info),
        cache={},
    )


def blr_triangular_solve_matrix(F: BLRMatrix, B: BLRMatrix, which: str = "L",
                                side: str = "L", trans: str = "N",
                                epsilon: Optional[float] = None) -> BLRMatrix:
    """Solve ``op(T)·X = B`` (side 'L') or ``X·op(T) = B`` (side 'R') where
    ``B`` AND the result are compressed BLR matrices — the reference's H-H
    triangular solve (``triangular_hmatrix_hmatrix_solve.hpp:19-198``).

    One scanned sweep per block-column of B (a dense [n, b] slab at a
    time); each result column is re-tiled and every cell compressed back by
    batched SVD at ``epsilon`` (dense when not advantageous)."""
    if side == "R":
        # X op(T) = B  <=>  op(T)^T X^T = B^T
        if trans == "C":
            Xt = blr_triangular_solve_matrix(
                F, blr_transpose(B, conj=True), which, "L", "N", epsilon
            )
            return blr_transpose(Xt, conj=True)
        flipped = "T" if trans == "N" else "N"
        Xt = blr_triangular_solve_matrix(
            F, blr_transpose(B), which, "L", flipped, epsilon
        )
        return blr_transpose(Xt)

    if (
        F.nL != B.nL
        or F.b != B.b
        or not np.array_equal(np.asarray(F.cell_off), np.asarray(B.cell_off))
    ):
        # factors cannot be re-tiled (their triangular structure is bound to
        # the factorization grid) — re-tile the RHS onto the factor grid
        from .conversion import retile_blr

        B = retile_blr(
            B, np.asarray(F.cell_off), np.asarray(F.cell_size), b=F.b
        )
    eps = B.epsilon if epsilon is None else epsilon
    nL, b, Rh = B.nL, B.b, B.R_half
    dtype = jnp.result_type(F.dtype, B.dtype)

    cls = np.zeros((nL, nL), np.int8)
    dense_slot = np.full((nL, nL), -1, np.int32)
    lr_slot = np.full((nL, nL), -1, np.int32)
    D_list, U_list, V_list, r_list = [], [], [], []
    pad_idx, mask, keep = _cells_plan(B)

    for j in range(nL):
        # materialize column j of B as a dense slab [n, b]
        colD = jnp.stack(
            [
                B.D[int(B.dense_slot[i, j])]
                if B.cls[i, j] == DENSE
                else (
                    B.U[int(B.lr_slot[i, j])][:, :Rh]
                    @ B.V[int(B.lr_slot[i, j])][:Rh, :]
                    if B.cls[i, j] == LR
                    else jnp.zeros((b, b), B.dtype)
                )
                for i in range(nL)
            ]
        )  # [nL, b, b]
        slab = _from_cells(B, colD.astype(dtype))  # [n, b]
        xs = blr_triangular_solve(F, slab, which=which, side="L", trans=trans)
        xc = _to_cells(B, xs, dtype)  # [nL, b, b]
        # compress every cell of the column at once
        Uj, sj, Vj = jnp.linalg.svd(xc, full_matrices=False)
        from .compressors import svd_truncation_rank

        rj = svd_truncation_rank(sj, eps)
        rj_np = np.asarray(rj)
        sz_j = int(B.cell_size[j])
        for i in range(nL):
            r = int(rj_np[i])
            if r == 0:
                continue
            if r * 2 * b < b * b and r <= Rh:
                cls[i, j] = LR
                lr_slot[i, j] = len(U_list)
                w = 2 * Rh
                Uc = jnp.zeros((b, w), dtype).at[:, :r].set(
                    Uj[i][:, :r] * sj[i][:r][None, :].astype(dtype)
                )
                Vc = jnp.zeros((w, b), dtype).at[:r, :].set(Vj[i][:r, :])
                U_list.append(Uc)
                V_list.append(Vc)
                r_list.append(r)
            else:
                cls[i, j] = DENSE
                dense_slot[i, j] = len(D_list)
                D_list.append(xc[i])

    nd, nl = len(D_list), len(U_list)
    D = jnp.stack(D_list + [jnp.zeros((b, b), dtype)])
    U = (
        jnp.stack(U_list + [jnp.zeros((b, 2 * Rh), dtype)])
        if nl
        else jnp.zeros((1, b, 2 * Rh), dtype)
    )
    V = (
        jnp.stack(V_list + [jnp.zeros((2 * Rh, b), dtype)])
        if nl
        else jnp.zeros((1, 2 * Rh, b), dtype)
    )
    ranks = jnp.asarray(np.array(r_list + [0], np.int32))
    return BLRMatrix(
        n=B.n,
        cell_off=B.cell_off,
        cell_size=B.cell_size,
        b=b,
        cls=cls,
        dense_slot=dense_slot,
        lr_slot=lr_slot,
        D=D,
        U=U,
        V=V,
        ranks=ranks,
        R_half=Rh,
        epsilon=eps,
        permutation=B.permutation,
        info=dict(level=B.info.get("level"), n_cells=nL),
    )
