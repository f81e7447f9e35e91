"""GenEO two-level coarse space.

Mirrors the reference's GenEO builders (``solvers/geneo/coarse_space_builder.
hpp:15-185`` and ``coarse_operator_builder.hpp:18-144``):

- per subdomain, solve the generalized EVP ``(D Aᵢ D) v = λ Bᵢ v`` where D is
  the 1/0 interior partition of unity (DAiD = Aᵢ with only the interior block
  kept, coarse_space_builder.hpp:28-37), Bᵢ a user-supplied local matrix
  (Neumann matrix in the BEM/FEM setting; defaults to Aᵢ);
- select the ν eigenvectors of largest |λ| (or all with |λ| > threshold)
  (coarse_space_builder.hpp:102-107);
- coarse basis Z keeps only interior rows (Z = D·v, :127-133);
- coarse operator E = Z* A Z assembled with global products
  (coarse_operator_builder.hpp:80-128) and dense-factorized.

Two-level corrections (HPDDM ``-hpddm_schwarz_coarse_correction``):
additive, deflated, balanced.

The EVPs are setup-time and run on host (scipy); E and the correction apply
on device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..clustering.cluster_tree import ClusterTree
from ..generator import Generator
from ..utils.precision import precise_jit

__all__ = ["GeneoCoarseSpace", "build_geneo_coarse_space"]


@dataclass
class GeneoCoarseSpace:
    Z: Any  # [N, nc] global coarse basis, cluster numbering (replicated
    # store) — None for the sharded store, which keeps only Z_loc
    E_lu: Any
    E_piv: Any
    size: int
    nu_per_subdomain: np.ndarray = None
    eigenvalues: list = None
    # sharded store (store='local'): per-partition interior-supported
    # columns.  Z column (p, j) lives at rows [row_off[p], row_off[p]+sz_p)
    # and coarse index p*nu_max + j; nothing [N, nc]-sized is ever built
    # (the reference assembles E the same way — per-rank Z blocks +
    # sub-products, coarse_operator_builder.hpp:18-129).
    Z_loc: Any = None  # [P, sz_max, nu_max]
    row_off: np.ndarray = None  # [P]
    row_size: np.ndarray = None  # [P]
    nu_max: int = 0

    def _zt_apply(self, r):
        """Z* r from the sharded store: [N, k] -> [nc_pad, k]."""
        P = self.Z_loc.shape[0]
        sz_max = self.Z_loc.shape[1]
        ar = np.arange(sz_max)[None, :]
        gat = jnp.asarray(
            np.minimum(self.row_off[:, None] + ar, r.shape[0] - 1), jnp.int32
        )
        mask = jnp.asarray(ar < self.row_size[:, None])
        rs = jnp.where(mask[:, :, None], r[gat], 0)  # [P, sz_max, k]
        mu = jnp.einsum("psn,psk->pnk", jnp.conj(self.Z_loc), rs)
        return mu.reshape(P * self.nu_max, r.shape[1])

    def _z_apply(self, c):
        """Z c from the sharded store: [nc_pad, k] -> [N, k]."""
        P, sz_max, _ = self.Z_loc.shape
        k = c.shape[1]
        cp = c.reshape(P, self.nu_max, k)
        zs = jnp.einsum("psn,pnk->psk", self.Z_loc, cp)  # [P, sz_max, k]
        N = int(self.row_size.sum())
        out = jnp.zeros((N, k), zs.dtype)
        ar = np.arange(sz_max)[None, :]
        rows = np.minimum(self.row_off[:, None] + ar, N - 1)
        mask = jnp.asarray(ar < self.row_size[:, None])
        zs = jnp.where(mask[:, :, None], zs, 0)
        return out.at[jnp.asarray(rows.reshape(-1), jnp.int32)].add(
            zs.reshape(P * sz_max, k)
        )

    def coarse_solve(self, r):
        """Q r = Z E⁻¹ Z* r for r [N, k]."""
        squeeze = r.ndim == 1
        if squeeze:
            r = r[:, None]
        if self.Z is not None:
            rhs = jnp.conj(self.Z).T @ r
            c = jax.scipy.linalg.lu_solve((self.E_lu, self.E_piv), rhs)
            out = self.Z @ c
        else:
            rhs = self._zt_apply(r)
            c = jax.scipy.linalg.lu_solve((self.E_lu, self.E_piv), rhs)
            out = self._z_apply(c)
        return out[:, 0] if squeeze else out

    def combined_preconditioner(
        self,
        one_level: Optional[Callable],
        A_apply: Callable,
        correction: str = "additive",
    ) -> Callable:
        M1 = one_level if one_level is not None else (lambda v: v)
        Q = self.coarse_solve

        if correction == "additive":

            def M(r):
                return M1(r) + Q(r)

        elif correction == "deflated":

            def M(r):
                Qr = Q(r)
                return Qr + M1(r - A_apply(Qr))

        elif correction == "balanced":

            def M(r):
                Qr = Q(r)
                t = M1(r - A_apply(Qr))
                return Qr + t - Q(A_apply(t))

        else:
            raise ValueError(f"unknown coarse correction {correction!r}")

        return M


@precise_jit
def _k_geneo_eigh(DAiD, Bi):
    """Batched hermitian-definite generalized EVP over padded subdomains:
    Cholesky-transform Bᵢ = Lᵢ Lᵢ^H, solve the standard EVP on
    Cᵢ = Lᵢ⁻¹ (D Aᵢ D) Lᵢ⁻ᴴ with one batched ``eigh``, and back-transform
    vᵢ = Lᵢ⁻ᴴ yᵢ — the sygv/hegv reduction (coarse_space_builder.hpp:89-92)
    executed as three batched device kernels (SURVEY.md §7.1)."""
    L = jnp.linalg.cholesky(Bi)

    def one(L_p, M_p):
        C1 = jax.scipy.linalg.solve_triangular(L_p, M_p, lower=True)
        C = jnp.conj(
            jax.scipy.linalg.solve_triangular(L_p, jnp.conj(C1).T, lower=True)
        ).T
        C = 0.5 * (C + jnp.conj(C).T)
        w, y = jnp.linalg.eigh(C)
        v = jax.scipy.linalg.solve_triangular(L_p, y, lower=True, trans=2)
        return w, v

    return jax.vmap(one)(L, DAiD)


def build_geneo_coarse_space(
    generator: Generator,
    tree: ClusterTree,
    overlap: list[np.ndarray],
    A_apply: Callable,
    nu: int = 2,
    threshold: float = -1.0,
    local_B: Optional[list[np.ndarray]] = None,
    symmetry: str = "S",
    infos: Optional[dict] = None,
    store: str = "replicated",
    evp_budget_bytes: float = 2e9,
) -> GeneoCoarseSpace:
    """Build the GenEO coarse space.

    ``overlap``: per-partition overlap-only index sets (cluster numbering),
    as produced by :func:`~htool_tpu.solvers.ddm.build_geometric_overlap`.
    ``A_apply``: global operator on cluster-numbered [N, k] arrays (used for
    E = Z* A Z).  ``local_B[p]``: the Bᵢ matrix over [interior; overlap]
    DOFs; defaults to Aᵢ itself.

    Symmetric/hermitian problems run batched device EVPs over padded
    subdomains (:func:`_k_geneo_eigh`), CHUNKED so the [chunk, n_max,
    n_max] workspace stays under ``evp_budget_bytes``; the general path
    falls back to host scipy ``eig`` per subdomain (``ggev``,
    coarse_space_builder.hpp:142-145).  ``infos`` (optional dict) receives
    the reference's GenEO timing entries (ddm.hpp:232-324).

    ``store='replicated'`` keeps the classic [N, nc] basis.
    ``store='local'`` NEVER materializes an [N, nc] array: the basis is
    kept as per-partition interior-supported column blocks
    ``Z_loc [P, sz_max, nu_max]`` and E = Z* A Z is assembled per
    partition-chunk with global sub-products — the memory-scalable path
    for BASELINE's 1M-point two-level target (the reference's distributed
    E assembly, ``coarse_operator_builder.hpp:18-129``)."""
    offs, sizes = tree.partition_offsets_sizes()
    P = tree.n_partitions
    N = tree.n_points
    perm = tree.permutation

    t0 = time.perf_counter()
    sub_idx = []
    for p in range(P):
        off, sz = int(offs[p]), int(sizes[p])
        sub_idx.append(
            np.concatenate([np.arange(off, off + sz), np.asarray(overlap[p], np.int64)])
        )
    n_max = max(i.size for i in sub_idx)

    if store not in ("replicated", "local"):
        raise ValueError("store must be 'replicated' or 'local'")

    # per-subdomain selected eigenvectors, host side: (sz-length rows, nevi)
    vecs: list[np.ndarray] = [None] * P
    nus = [0] * P
    eigs = [None] * P

    def select(p, w, v, n_i, sz):
        order = np.argsort(-np.abs(w))
        if threshold > 0:
            nevi = int(np.sum(np.abs(w) > threshold))
        else:
            nevi = min(nu, n_i)
        sel = order[:nevi]
        eigs[p] = np.abs(w[sel])
        nus[p] = nevi
        vecs[p] = np.ascontiguousarray(v[:sz, sel])  # interior rows only

    if symmetry in ("S", "H"):
        # ---- batched device path, chunked under the workspace budget ----
        itemsize = jnp.dtype(generator.dtype).itemsize
        per_sub = n_max * n_max * itemsize * 8  # Ai+Bi+EVP transients
        chunk = max(1, min(int(evp_budget_bytes // per_sub), P))
        # round DOWN to a power of two: the batched-eigh program compiles
        # per chunk SHAPE, and a ragged last chunk (e.g. 5 then 3 of P=8)
        # doubles the dominant compile cost of the two-level setup
        c2 = 1
        while c2 * 2 <= chunk:
            c2 *= 2
        chunk = c2
        for lo in range(0, P, chunk):
            ps_real = list(range(lo, min(lo + chunk, P)))
            n_real = len(ps_real)
            # pad a ragged final chunk by repeating the first subdomain:
            # results for padded entries are discarded below
            ps = ps_real + [ps_real[0]] * (chunk - n_real)
            c = len(ps)
            rows = np.zeros((c, n_max), np.int64)
            valid = np.zeros((c, n_max), bool)
            for ci, p in enumerate(ps):
                idx = sub_idx[p]
                rows[ci, : idx.size] = perm[idx]
                valid[ci, : idx.size] = True
            Ai = generator.block(
                jnp.asarray(rows, jnp.int32), jnp.asarray(rows, jnp.int32)
            )
            vm = jnp.asarray(valid)
            pair = vm[:, :, None] & vm[:, None, :]
            Ai = jnp.where(pair, Ai, 0)
            if local_B is not None:
                Bi = np.zeros((c, n_max, n_max), np.asarray(local_B[ps[0]]).dtype)
                for ci, p in enumerate(ps):
                    Bp = np.asarray(local_B[p])
                    Bi[ci, : Bp.shape[0], : Bp.shape[1]] = Bp
                Bi = jnp.asarray(Bi)
                Bi = jnp.where(pair, Bi, 0)
            else:
                Bi = Ai
            # identity on padding keeps Bᵢ positive definite
            eye = jnp.eye(n_max, dtype=Ai.dtype)[None]
            Bi = Bi + jnp.where(vm[:, :, None], 0, eye)
            # DAiD: interior block only (coarse_space_builder.hpp:28-37)
            int_mask = jnp.asarray(
                np.arange(n_max)[None, :] < sizes[ps][:, None]
            )
            dpair = int_mask[:, :, None] & int_mask[:, None, :]
            DAiD = jnp.where(dpair, Ai, 0)
            w_all, v_all = _k_geneo_eigh(DAiD, Bi)
            w_all = np.asarray(w_all)  # [c, n_max] ascending (real)
            v_all = np.asarray(v_all)
            for ci, p in enumerate(ps_real):
                select(p, w_all[ci], v_all[ci], sub_idx[p].size, int(sizes[p]))
    else:
        # ---- general (non-hermitian) host path ----
        import scipy.linalg as sla

        for p in range(P):
            idx = sub_idx[p]
            sz = int(sizes[p])
            rows_user = perm[idx]
            Ai = np.asarray(generator.block(rows_user, rows_user))
            DAiD = np.zeros_like(Ai)
            DAiD[:sz, :sz] = Ai[:sz, :sz]
            Bi = np.asarray(local_B[p]) if local_B is not None else Ai
            w, v = sla.eig(DAiD, Bi)
            select(p, w, v, idx.size, sz)

    t_evp = time.perf_counter() - t0
    dtype = vecs[0].dtype if P else np.float32

    if store == "local":
        # ---- sharded store: Z_loc [P, sz_max, nu_max], E per q-chunk ----
        nu_max = max(nus) if nus else 0
        sz_max = int(sizes.max()) if P else 0
        Z_loc_np = np.zeros((P, sz_max, nu_max), dtype)
        for p in range(P):
            Z_loc_np[p, : vecs[p].shape[0], : nus[p]] = vecs[p]
        Z_loc = jnp.asarray(Z_loc_np)
        nc_pad = P * nu_max
        nc = int(sum(nus))

        t1 = time.perf_counter()
        E = jnp.zeros((nc_pad, nc_pad), dtype)
        cs = GeneoCoarseSpace(
            Z=None, E_lu=None, E_piv=None, size=nc,
            nu_per_subdomain=np.array(nus), eigenvalues=eigs,
            Z_loc=Z_loc, row_off=np.asarray(offs, np.int64),
            row_size=np.asarray(sizes, np.int64), nu_max=nu_max,
        )
        # E = Z* A Z per partition-chunk: the [N, c*nu_max] transient is the
        # only N-sized buffer (coarse_operator_builder.hpp:80-128 pattern)
        qchunk = max(1, min(64, P))
        eyec = jnp.eye(nc_pad, dtype=dtype)
        for lo in range(0, P, qchunk):
            qs = np.arange(lo, min(lo + qchunk, P))
            sel_cols = (
                (qs[:, None] * nu_max + np.arange(nu_max)[None, :]).reshape(-1)
            )
            cols = cs._z_apply(eyec[:, sel_cols])  # [N, c*nu_max]
            AZ = A_apply(cols)
            Eblk = cs._zt_apply(AZ)  # [nc_pad, c*nu_max]
            E = E.at[:, jnp.asarray(sel_cols, jnp.int32)].set(Eblk)
        # identity on padded (empty) coarse slots keeps E invertible
        slot = np.arange(nc_pad)
        used = (slot % nu_max) < np.repeat(np.array(nus), nu_max) if nu_max else slot < 0
        E = E + jnp.asarray(np.where(used, 0.0, 1.0).astype(np.float32)) * eyec
        t_ztaz = time.perf_counter() - t1
        t2 = time.perf_counter()
        E_lu, E_piv = jax.scipy.linalg.lu_factor(E)
        E_lu.block_until_ready()
        t_facto = time.perf_counter() - t2
        cs.E_lu, cs.E_piv = E_lu, E_piv
    else:
        Z_cols = []
        for p in range(P):
            sz = int(sizes[p])
            for j in range(nus[p]):
                col = np.zeros(N, dtype)
                col[int(offs[p]) : int(offs[p]) + sz] = vecs[p][:, j]
                Z_cols.append(col)
        Z = jnp.asarray(np.stack(Z_cols, axis=1)) if Z_cols else jnp.zeros((N, 0), dtype)
        nc = Z.shape[1]

        # E = Z* A Z via global products (coarse_operator_builder.hpp:80-128)
        t1 = time.perf_counter()
        AZ = A_apply(Z)
        E = jnp.conj(Z).T @ AZ
        t_ztaz = time.perf_counter() - t1
        t2 = time.perf_counter()
        E_lu, E_piv = jax.scipy.linalg.lu_factor(E)
        E_lu.block_until_ready()
        t_facto = time.perf_counter() - t2

        cs = GeneoCoarseSpace(
            Z=Z,
            E_lu=E_lu,
            E_piv=E_piv,
            size=int(nc),
            nu_per_subdomain=np.array(nus),
            eigenvalues=eigs,
        )
    cs.build_walltime = time.perf_counter() - t0
    if infos is not None:
        # the reference's GenEO timing infos (ddm.hpp:232-324)
        infos["GenEO_coarse_space_size"] = int(nc)
        infos["GenEO_geev_walltime"] = t_evp
        infos["GenEO_ZtAZ_walltime"] = t_ztaz
        infos["GenEO_facto_coarse_operator_walltime"] = t_facto
    return cs
