"""Domain-decomposition (Schwarz) preconditioners and the DDM solve driver.

Batched replacement for the reference's DDM + HPDDM stack
(``solvers/ddm.hpp:29-382``, ``solvers/utility.hpp:22-359``): subdomains are
the cluster-tree partitions plus (optional) geometric overlap; local solves
are batched prefactorized dense solves on device (the
``DDMSolverWithDenseLocalSolver`` mode, utility.hpp:195-211); the Krylov
loop is :mod:`.krylov` instead of HPDDM.

Preconditioner variants (HPDDM ``-hpddm_schwarz_method``):
- ``"none"``   : unpreconditioned Krylov
- ``"jacobi"`` : block-Jacobi, no overlap (overlap ignored in the solve)
- ``"asm"``    : Additive Schwarz, M⁻¹ = Σ Rᵢᵀ Aᵢ⁻¹ Rᵢ
- ``"ras"``    : Restricted Additive Schwarz, M⁻¹ = Σ Rᵢᵀ Dᵢ Aᵢ⁻¹ Rᵢ with
  partition of unity Dᵢ = 1 on interior / 0 on overlap (ddm.hpp:59-63)

Subdomain DOF order is interior-then-overlap (``LocalNumberingBuilder``,
utility.hpp:22-52).  All subdomain solves run batched ([P, n_max, n_max]
LU with identity padding), so one device executes them as one kernel and a
mesh shards them along the subdomain axis.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..clustering.cluster_tree import ClusterTree
from ..generator import Generator
from .krylov import KrylovResult, cg, gmres
from ..utils.precision import precise_jit

__all__ = [
    "build_geometric_overlap",
    "SchwarzPreconditioner",
    "DDMSolver",
]


def build_geometric_overlap(
    tree: ClusterTree, n_layers_or_radius: float = 0.0
) -> list[np.ndarray]:
    """Per-partition overlap index sets (cluster numbering), by geometric
    radius: points of other partitions within ``radius`` of the partition's
    own points.  The reference reads overlap decompositions from data files
    (``test_solver_ddm.hpp:110-183``); a geometric rule is the self-contained
    analog.  Returns, per partition, the OVERLAP-ONLY indices (interior
    excluded), sorted."""
    from scipy.spatial import cKDTree

    offs, sizes = tree.partition_offsets_sizes()
    P = tree.n_partitions
    pts_c = tree.points[tree.permutation]  # cluster-ordered coordinates
    radius = float(n_layers_or_radius)
    out = []
    kd = cKDTree(pts_c)
    for p in range(P):
        off, sz = int(offs[p]), int(sizes[p])
        if radius <= 0:
            out.append(np.zeros(0, np.int64))
            continue
        own = np.arange(off, off + sz)
        near = kd.query_ball_point(pts_c[off : off + sz], r=radius)
        idx = np.unique(np.concatenate([np.asarray(a, np.int64) for a in near]))
        mask = (idx < off) | (idx >= off + sz)
        out.append(idx[mask])
    return out


@dataclass
class SchwarzPreconditioner:
    """Batched one-level Schwarz preconditioner over cluster numbering.

    Arrays: ``idx [P, n_max]`` global cluster indices per subdomain (padded
    with the trash slot N), ``weights [P, n_max]`` scatter weights (0 on
    padding; D on overlap per variant), and the PRECOMPUTED local inverses
    ``inv [P, n_max, n_max]``.  The apply is one batched einsum, which reads
    the factors once per Krylov iteration as a plain batched matmul, where a
    batched ``lu_solve`` runs two triangular solves.  A preconditioner only
    needs M ≈ A⁻¹, so inverse roundoff costs at most a few Krylov iterations.
    Whether the inverse beats ``lu_solve`` on the GPU is not measured yet
    (ROADMAP 1.5)
    (the LAPACK-subsolver role of ``solvers/ddm.hpp:65-76``).
    """

    n_global: int
    idx: Any  # [P, n_max] int32 (== n_global on padding)
    weights: Any  # [P, n_max] real
    inv: Any  # [P, n_max, n_max] explicit local inverses
    variant: str = "ras"
    n_sub_sizes: np.ndarray = None  # host [P]

    def apply(self, r):
        """r: [N, k] cluster numbering -> z [N, k]."""
        squeeze = r.ndim == 1
        if squeeze:
            r = r[:, None]
        z = _schwarz_apply(self.idx, self.weights, self.inv, r)
        return z[:, 0] if squeeze else z

    def __call__(self, r):
        return self.apply(r)


@precise_jit
def _schwarz_apply(idx, weights, inv, r):
    k = r.shape[1]
    N = r.shape[0]
    r_pad = jnp.concatenate([r, jnp.zeros((1, k), r.dtype)], axis=0)
    r_loc = r_pad[idx]  # [P, n_max, k]
    # mask padded rows (identity rows of the inverse would pass them through)
    mask = (idx < N)[..., None]
    r_loc = jnp.where(mask, r_loc, 0)
    z_loc = jnp.einsum(
        "pij,pjk->pik", inv.astype(r.dtype), r_loc,
        precision=jax.lax.Precision.HIGHEST,
    )
    z_loc = z_loc * weights[..., None].astype(z_loc.dtype)
    z = jnp.zeros((N + 1, k), r.dtype).at[idx.reshape(-1)].add(
        z_loc.reshape(-1, k)
    )
    return z[:N]


@dataclass
class BLRSchwarzPreconditioner:
    """One-level Schwarz with BLR-compressed local factorizations — the
    H-LU local solver mode (``LocalHMatrixSolver``,
    ``solvers/local_solvers/local_hmatrix_solvers.hpp:14-85``): each
    subdomain matrix is assembled as a BLR matrix and LU-factorized in
    compressed form, so large subdomains stay sub-quadratic in memory."""

    n_global: int
    idx: list  # per-subdomain global cluster indices (host)
    weights: list  # per-subdomain scatter weights (host np)
    factors: list  # per-subdomain factorized BLRMatrix
    variant: str = "ras"

    def apply(self, r):
        import jax.numpy as jnp

        from ..hmatrix.blr import blr_solve
        from ..hmatrix.blr2 import TwoLevelBLR, blr2_solve

        squeeze = r.ndim == 1
        if squeeze:
            r = r[:, None]
        z = jnp.zeros_like(r)
        for idx, w, F in zip(self.idx, self.weights, self.factors):
            r_loc = r[jnp.asarray(idx)]
            if isinstance(F, TwoLevelBLR):
                z_loc = blr2_solve(F, r_loc, user_numbering=True)
            else:
                z_loc = blr_solve(F, r_loc, user_numbering=True)
            z = z.at[jnp.asarray(idx)].add(
                z_loc * jnp.asarray(w)[:, None].astype(z_loc.dtype)
            )
        return z[:, 0] if squeeze else z

    def __call__(self, r):
        return self.apply(r)


def _build_blr_schwarz(
    generator: Generator,
    tree: ClusterTree,
    overlap: Optional[list[np.ndarray]],
    variant: str,
    blr_epsilon: float = 1e-6,
    blr_block_size: int = 256,
    hierarchical: bool = False,
    coarse_size: int = 2048,
) -> BLRSchwarzPreconditioner:
    from ..clustering.cluster_tree import ClusterTreeBuilder
    from ..generator import SubsetGenerator
    from ..hmatrix.blr import blr_lu, build_blr
    from ..hmatrix.blr2 import blr2_lu, build_blr2

    offs, sizes = tree.partition_offsets_sizes()
    P = tree.n_partitions
    perm = tree.permutation

    idxs, wtss, factors = [], [], []
    for p in range(P):
        off, sz = int(offs[p]), int(sizes[p])
        interior = np.arange(off, off + sz)
        ov = (
            np.asarray(overlap[p], np.int64)
            if (overlap is not None and variant in ("asm", "ras"))
            else np.zeros(0, np.int64)
        )
        idx = np.concatenate([interior, ov])
        w = np.ones(idx.size)
        if variant == "ras":
            w[interior.size :] = 0.0
        sub_user = perm[idx]
        sub_pts = tree.points[sub_user]
        sub_tree = ClusterTreeBuilder(
            max_leaf_size=min(blr_block_size, max(32, idx.size // 8))
        ).build(sub_pts)
        sub_gen = SubsetGenerator(generator, sub_user)
        if hierarchical and idx.size > 2 * coarse_size:
            # hierarchical local factorization (the reference's H-LU local
            # solver, local_hmatrix_solvers.hpp:14-85, with recursive
            # asymptotics via the two-level panel format)
            B2 = build_blr2(
                sub_gen, sub_tree, epsilon=blr_epsilon,
                coarse_size=coarse_size, block_size=blr_block_size,
            )
            factors.append(blr2_lu(B2, error_estimate=False))
        else:
            B = build_blr(
                sub_gen, sub_tree, epsilon=blr_epsilon, block_size=blr_block_size
            )
            factors.append(blr_lu(B))
        idxs.append(idx)
        wtss.append(w)
    return BLRSchwarzPreconditioner(
        n_global=tree.n_points,
        idx=idxs,
        weights=wtss,
        factors=factors,
        variant=variant,
    )


# size budget (batch * n^3) for one batched-LU program: larger batches are
# factored in power-of-two chunks, one compiled shape per chunk size, which
# bounds each program's workspace.  Whether the GPU needs the bound is not
# measured yet (ROADMAP 1.5).
_BATCH_LU_BUDGET = 3.5e11


def _chunked_batch_lu(A_loc):
    """Batched LU factorization in compile-bounded chunks (one compiled
    shape per chunk size; the last chunk pads by repeating its first
    matrix)."""
    P, n = int(A_loc.shape[0]), int(A_loc.shape[1])
    chunk = max(1, min(int(_BATCH_LU_BUDGET / float(n) ** 3), P))
    c = 1
    while c * 2 <= chunk:
        c *= 2
    chunk = c
    if chunk >= P:
        return jax.vmap(partial(jax.scipy.linalg.lu_factor))(A_loc)
    lus, pivs = [], []
    for lo in range(0, P, chunk):
        sel = np.arange(lo, min(lo + chunk, P))
        pad = chunk - sel.size
        gat = jnp.asarray(
            np.concatenate([sel, np.repeat(sel[:1], pad)]), jnp.int32
        )
        lu_c, piv_c = jax.vmap(partial(jax.scipy.linalg.lu_factor))(A_loc[gat])
        lus.append(lu_c[: sel.size])
        pivs.append(piv_c[: sel.size])
    return jnp.concatenate(lus), jnp.concatenate(pivs)


@precise_jit
def _k_batch_inv(A_chunk):
    lu, piv = jax.vmap(partial(jax.scipy.linalg.lu_factor))(A_chunk)
    eye = jnp.eye(A_chunk.shape[1], dtype=A_chunk.dtype)
    return jax.vmap(lambda l, p: jax.scipy.linalg.lu_solve((l, p), eye))(lu, piv)


def _chunked_batch_inv(A_loc):
    """Batched explicit inverse in compile-bounded chunks (same budget
    rationale as :func:`_chunked_batch_lu`; setup-time only — the Krylov
    loop then applies the inverses as one einsum)."""
    P, n = int(A_loc.shape[0]), int(A_loc.shape[1])
    chunk = max(1, min(int(_BATCH_LU_BUDGET / float(n) ** 3), P))
    c = 1
    while c * 2 <= chunk:
        c *= 2
    chunk = c
    if chunk >= P:
        return _k_batch_inv(A_loc)
    invs = []
    for lo in range(0, P, chunk):
        sel = np.arange(lo, min(lo + chunk, P))
        pad = chunk - sel.size
        gat = jnp.asarray(
            np.concatenate([sel, np.repeat(sel[:1], pad)]), jnp.int32
        )
        inv_c = _k_batch_inv(A_loc[gat])
        invs.append(inv_c[: sel.size])
    return jnp.concatenate(invs)


def _build_schwarz(
    generator: Generator,
    tree: ClusterTree,
    overlap: Optional[list[np.ndarray]],
    variant: str,
    dtype,
) -> SchwarzPreconditioner:
    offs, sizes = tree.partition_offsets_sizes()
    P = tree.n_partitions
    N = tree.n_points
    perm = tree.permutation

    subs = []
    for p in range(P):
        off, sz = int(offs[p]), int(sizes[p])
        interior = np.arange(off, off + sz)
        ov = (
            overlap[p]
            if (overlap is not None and variant in ("asm", "ras"))
            else np.zeros(0, np.int64)
        )
        subs.append((interior, ov))

    n_max = max(int(i.size + o.size) for i, o in subs)
    idx = np.full((P, n_max), N, np.int64)
    wts = np.zeros((P, n_max), np.float64)
    for p, (interior, ov) in enumerate(subs):
        ni, no = interior.size, ov.size
        idx[p, :ni] = interior
        idx[p, ni : ni + no] = ov
        wts[p, :ni] = 1.0
        if variant == "asm":
            wts[p, ni : ni + no] = 1.0  # no partition of unity
        # ras: overlap weight stays 0 (restricted)

    # assemble local dense matrices batched: rows/cols in user numbering
    perm_ext = np.concatenate([perm, [0]])  # trash slot maps to any point
    rows_user = jnp.asarray(perm_ext[idx], jnp.int32)  # [P, n_max]
    A_loc = generator.block(rows_user[:, :, None].squeeze(-1), rows_user)
    # zero padded rows/cols, identity on padded diagonal to keep LU valid
    valid = jnp.asarray(idx < N)
    vm = valid[:, :, None] & valid[:, None, :]
    A_loc = jnp.where(vm, A_loc, 0)
    eye = jnp.eye(n_max, dtype=A_loc.dtype)[None]
    A_loc = A_loc + jnp.where(valid[:, :, None], 0, eye)

    inv = _chunked_batch_inv(A_loc)

    return SchwarzPreconditioner(
        n_global=N,
        idx=jnp.asarray(idx, jnp.int32),
        weights=jnp.asarray(wts),
        inv=inv,
        variant=variant,
        n_sub_sizes=np.array([i.size + o.size for i, o in subs]),
    )


class DDMSolver:
    """One-level (and, with a coarse space attached, two-level) Schwarz-
    preconditioned Krylov solver — the ``DDM`` equivalent
    (``solvers/ddm.hpp:29-382``).

    ``operator`` may be an :class:`~htool_tpu.hmatrix.hmatrix.HMatrix`, a
    :class:`~htool_tpu.parallel.distributed.DistributedHMatrix`, or any
    callable on cluster-numbered [N, k] arrays.  The solve runs in cluster
    numbering internally and accepts/returns user numbering, like the
    reference (ddm.hpp:179,226).
    """

    def __init__(
        self,
        operator,
        generator: Generator,
        tree: ClusterTree,
        schwarz: str = "ras",
        overlap: Optional[list[np.ndarray]] = None,
        overlap_radius: float = 0.0,
        coarse=None,  # optional GeneoCoarseSpace
        coarse_correction: str = "additive",
        local_solver: str = "dense",  # "dense" | "blr" (flat) | "blr2" (hierarchical)
        blr_epsilon: float = 1e-6,
        blr_block_size: int = 256,
        blr_coarse_size: int = 2048,
    ):
        self.tree = tree
        self.generator = generator
        self.schwarz = schwarz
        self.infos: dict = {}

        from ..hmatrix.hmatrix import HMatrix
        from ..hmatrix.linalg import matvec as h_matvec

        if isinstance(operator, HMatrix):
            self._apply = lambda x: h_matvec(operator, x, op="N")
            dtype = operator.dtype
        elif hasattr(operator, "matvec") and hasattr(operator, "to_local_layout"):
            d = operator
            self._apply = lambda x: d.to_global_layout(
                d.matvec_local(d.to_local_layout(x))
            )
            dtype = d.dtype
        else:
            self._apply = operator
            dtype = generator.dtype

        t0 = time.perf_counter()
        if schwarz in ("jacobi", "asm", "ras"):
            if overlap is None and overlap_radius > 0 and schwarz in ("asm", "ras"):
                overlap = build_geometric_overlap(tree, overlap_radius)
            if local_solver in ("blr", "blr2"):
                self.precond = _build_blr_schwarz(
                    generator, tree, overlap, schwarz, blr_epsilon,
                    blr_block_size, hierarchical=(local_solver == "blr2"),
                    coarse_size=blr_coarse_size,
                )
                self.infos["Local_solver"] = local_solver
            elif local_solver == "dense":
                self.precond = _build_schwarz(generator, tree, overlap, schwarz, dtype)
                self.infos["Local_solver"] = "dense"
                self.infos["Local_size_max"] = int(self.precond.n_sub_sizes.max())
            else:
                raise ValueError(f"unknown local solver {local_solver!r}")
            self.infos["Precond"] = schwarz
            self.infos["Nb_subdomains"] = tree.n_partitions
        elif schwarz == "none":
            self.precond = None
            self.infos["Precond"] = "none"
        else:
            raise ValueError(f"unknown schwarz variant {schwarz!r}")
        self.infos["Facto_one_level_walltime"] = time.perf_counter() - t0

        self.coarse = coarse
        self.coarse_correction = coarse_correction
        if coarse is not None:
            self.infos["Coarse_correction"] = coarse_correction
            self.infos["Coarse_size"] = int(coarse.size)

    # ------------------------------------------------------------------
    def _preconditioner(self) -> Optional[Callable]:
        one = self.precond.apply if self.precond is not None else None
        if self.coarse is None:
            return one
        return self.coarse.combined_preconditioner(
            one, self._apply, self.coarse_correction
        )

    def solve(
        self,
        b,
        tol: float = 1e-6,
        maxiter: int = 200,
        krylov: str = "gmres",
        restart: int = 40,
        x0=None,
    ):
        """Solve A x = b in USER numbering.  Returns (x, infos)."""
        b = jnp.asarray(b)
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        perm = jnp.asarray(self.tree.permutation, jnp.int32)
        bc = b[perm]

        M = self._preconditioner()
        t0 = time.perf_counter()
        if krylov == "cg":
            result: KrylovResult = cg(self._apply, bc, M=M, tol=tol, maxiter=maxiter, x0=x0)
        elif krylov == "gmres":
            result = gmres(
                self._apply, bc, M=M, tol=tol, maxiter=maxiter, restart=restart, x0=x0
            )
        elif krylov == "block_gmres":
            from .krylov import block_gmres

            result = block_gmres(
                self._apply, bc, M=M, tol=tol, maxiter=maxiter, restart=restart, x0=x0
            )
        else:
            raise ValueError(f"unknown krylov method {krylov!r}")
        xc = result.x
        xc.block_until_ready()
        self.infos["Solve_walltime"] = time.perf_counter() - t0
        self.infos["Krylov"] = krylov
        self.infos["Nb_it"] = int(result.iterations)
        self.infos["Residual"] = float(result.residual)
        self.infos["Converged"] = bool(result.converged)

        x = jnp.zeros_like(xc).at[perm].set(xc)
        return (x[:, 0] if squeeze else x), dict(self.infos)
