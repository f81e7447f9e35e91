"""Krylov solvers — jittable CG and restarted GMRES with preconditioning.

Jittable replacement for the HPDDM Krylov loop the reference delegates to
(``solvers/ddm.hpp:193`` -> ``HPDDM::IterativeMethod::solve``): pure-JAX
``lax.while_loop`` iterations so the whole solve (operator apply +
preconditioner + dot products) compiles to one XLA program; on a mesh the
global dot products become the psum collectives that MPI_Allreduce provides
in the reference (SURVEY.md §3.3).

Both solvers support multiple right-hand sides (columns iterate jointly but
with per-column step sizes, like HPDDM's block methods), complex dtypes, and
left preconditioning (HPDDM's default variant).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

__all__ = ["cg", "gmres", "block_gmres", "KrylovResult"]


class KrylovResult(NamedTuple):
    x: jnp.ndarray
    iterations: jnp.ndarray  # int32
    residual: jnp.ndarray  # final relative residual, max over RHS columns
    converged: jnp.ndarray  # bool


def _make_vdot(axis_name: Optional[str]):
    """Per-column <a, b> with conjugation: [n, k] x [n, k] -> [k].

    With ``axis_name``, the vectors are per-device slices inside a
    ``shard_map`` and the dot is completed with a ``psum`` over the mesh
    axis — the MPI_Allreduce that HPDDM's Krylov loop issues for its global
    dot products (SURVEY.md §3.3)."""

    def vdot(a, b):
        d = jnp.sum(jnp.conj(a) * b, axis=0)
        if axis_name is not None:
            d = jax.lax.psum(d, axis_name)
        return d

    return vdot


_vdot_cols = _make_vdot(None)


def _norm_cols(a):
    return jnp.sqrt(jnp.abs(_vdot_cols(a, a)).real)


def cg(
    A: Callable,
    b,
    M: Optional[Callable] = None,
    x0=None,
    tol: float = 1e-6,
    maxiter: int = 200,
    axis_name: Optional[str] = None,
) -> KrylovResult:
    """Preconditioned conjugate gradient for SPD/HPD operators.

    ``A`` and ``M`` map [n, k] -> [n, k].  Stops when every column satisfies
    ``||b - A x|| <= tol * ||b||``.  With ``axis_name``, runs on per-device
    vector slices inside a ``shard_map`` (dots psum over the axis; padded
    slice rows must be zero).
    """
    _vdot_cols = _make_vdot(axis_name)

    def _norm_cols(a):
        return jnp.sqrt(jnp.abs(_vdot_cols(a, a)).real)

    b = jnp.asarray(b)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    n, k = b.shape
    if M is None:
        M = lambda v: v
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0).reshape(n, k)

    bnorm = _norm_cols(b)
    bnorm = jnp.where(bnorm == 0, 1.0, bnorm)

    r = b - A(x)
    z = M(r)
    p = z
    rz = _vdot_cols(r, z)

    def cond(st):
        x, r, z, p, rz, it = st
        return (it < maxiter) & jnp.any(_norm_cols(r) > tol * bnorm)

    def body(st):
        x, r, z, p, rz, it = st
        Ap = A(p)
        pAp = _vdot_cols(p, Ap)
        alpha = rz / jnp.where(pAp == 0, 1.0, pAp)
        # freeze converged columns
        active = _norm_cols(r) > tol * bnorm
        alpha = jnp.where(active, alpha, 0.0)
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * Ap
        z = M(r)
        rz_new = _vdot_cols(r, z)
        beta = rz_new / jnp.where(rz == 0, 1.0, rz)
        beta = jnp.where(active, beta, 0.0)
        p = z + beta[None, :] * p
        return (x, r, z, p, rz_new, it + 1)

    x, r, z, p, rz, it = jax.lax.while_loop(cond, body, (x, r, z, p, rz, jnp.int32(0)))
    res = jnp.max(_norm_cols(r) / bnorm)
    out = x[:, 0] if squeeze else x
    return KrylovResult(out, it, res, res <= tol)


def gmres(
    A: Callable,
    b,
    M: Optional[Callable] = None,
    x0=None,
    tol: float = 1e-6,
    maxiter: int = 200,
    restart: int = 40,
    axis_name: Optional[str] = None,
) -> KrylovResult:
    """Left-preconditioned restarted GMRES(m) with modified Gram-Schmidt and
    Givens rotations, vectorized over RHS columns.

    Iterates on the preconditioned system ``M A x = M b``; the convergence
    test uses the preconditioned residual (HPDDM's default), with the final
    reported residual recomputed unpreconditioned.  With ``axis_name``, runs
    on per-device vector slices inside a ``shard_map``.
    """
    _vdot_cols = _make_vdot(axis_name)

    def _norm_cols(a):
        return jnp.sqrt(jnp.abs(_vdot_cols(a, a)).real)

    b = jnp.asarray(b)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    n, k = b.shape
    if M is None:
        M = lambda v: v
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0).reshape(n, k)
    dtype = jnp.result_type(b.dtype, A(b).dtype)
    b = b.astype(dtype)
    x = x.astype(dtype)
    m = int(min(restart, maxiter))

    Mb = M(b)
    bnorm = _norm_cols(Mb)
    bnorm = jnp.where(bnorm == 0, 1.0, bnorm)

    def cycle(carry):
        x, it, _ = carry
        r = M(b - A(x)).astype(dtype)  # [n, k]
        beta = _norm_cols(r)  # [k]
        # Krylov basis: V [m+1, n, k]
        V = jnp.zeros((m + 1, n, k), dtype)
        V = V.at[0].set(r / jnp.where(beta == 0, 1.0, beta)[None, :])
        # Hessenberg (after Givens): H [m+1, m, k]; Givens coeffs cs/sn [m, k]
        H = jnp.zeros((m + 1, m, k), dtype)
        cs = jnp.zeros((m, k), dtype)
        sn = jnp.zeros((m, k), dtype)
        g = jnp.zeros((m + 1, k), dtype).at[0].set(beta.astype(dtype))

        def arnoldi_cond(st):
            V, H, cs, sn, g, it, j = st
            # after j steps the rotated residual of each column is |g[j]|
            res_j = jnp.abs(g[jnp.minimum(j, m)]) / bnorm
            return (j < m) & jnp.any(res_j > tol)

        def arnoldi_step(st):
            V, H, cs, sn, g, it, j = st
            w = M(A(V[j])).astype(dtype)  # [n, k]

            # modified Gram-Schmidt against V[0..j]
            def mgs(i, acc):
                w, h = acc
                coef = jnp.where(i <= j, 1.0, 0.0)
                hij = _vdot_cols(V[i], w) * coef
                w = w - hij[None, :] * V[i]
                h = h.at[i].set(hij)
                return (w, h)

            w, hcol = jax.lax.fori_loop(0, m + 1, mgs, (w, jnp.zeros((m + 1, k), dtype)))
            hlast = _norm_cols(w).astype(dtype)
            hcol = hcol.at[j + 1].set(hlast)
            V = V.at[j + 1].set(w / jnp.where(jnp.abs(hlast) == 0, 1.0, hlast)[None, :])

            # apply previous Givens rotations to the new column.
            # Convention: G = [[c, s], [-conj(s), c]] with c real >= 0.
            def rot(i, hc):
                use = (i < j)
                t1 = cs[i] * hc[i] + sn[i] * hc[i + 1]
                t2 = -jnp.conj(sn[i]) * hc[i] + cs[i] * hc[i + 1]
                hc = hc.at[i].set(jnp.where(use, t1, hc[i]))
                hc = hc.at[i + 1].set(jnp.where(use, t2, hc[i + 1]))
                return hc

            hcol = jax.lax.fori_loop(0, m, rot, hcol)

            # new Givens zeroing hcol[j+1]:
            # c = |h1|/d, s = phase(h1) * conj(h2)/d  ->  G [h1; h2] = [phase*d; 0]
            h1, h2 = hcol[j], hcol[j + 1]
            denom = jnp.sqrt(jnp.abs(h1) ** 2 + jnp.abs(h2) ** 2)
            denom_s = jnp.where(denom == 0, 1.0, denom)
            absh1 = jnp.abs(h1)
            phase = jnp.where(absh1 == 0, jnp.ones_like(h1), h1 / jnp.where(absh1 == 0, 1.0, absh1).astype(h1.dtype))
            c_new = (absh1 / denom_s).astype(dtype)
            s_new = (phase * jnp.conj(h2) / denom_s.astype(h1.dtype)).astype(dtype)
            cs = cs.at[j].set(c_new)
            sn = sn.at[j].set(s_new)
            hcol = hcol.at[j].set(c_new * h1 + s_new * h2)
            hcol = hcol.at[j + 1].set(0.0)
            H = H.at[:, j, :].set(hcol)

            # update residual vector g
            g1, g2 = g[j], g[j + 1]
            g = g.at[j].set(c_new * g1 + s_new * g2)
            g = g.at[j + 1].set(-jnp.conj(s_new) * g1 + c_new * g2)
            return (V, H, cs, sn, g, it + 1, j + 1)

        V, H, cs, sn, g, it, j_used = jax.lax.while_loop(
            arnoldi_cond, arnoldi_step, (V, H, cs, sn, g, it, jnp.int32(0))
        )

        # back-substitute H y = g over the j_used leading columns
        def back(i_rev, y):
            i = m - 1 - i_rev
            num = g[i] - jnp.einsum("jk,jk->k", H[i, :, :], y)
            hii = H[i, i, :]
            yi = num / jnp.where(jnp.abs(hii) == 0, 1.0, hii)
            y = y.at[i].set(jnp.where(i < j_used, yi, 0.0))
            return y

        y = jax.lax.fori_loop(0, m, back, jnp.zeros((m, k), dtype))
        x = x + jnp.einsum("jnk,jk->nk", V[:m], y)
        res = jnp.max(_norm_cols(M(b - A(x))) / bnorm)
        return (x, it, res)

    def cond(carry):
        x, it, res = carry
        return (it < maxiter) & (res > tol)

    rdtype = jnp.zeros((), dtype).real.dtype
    x, it, res = jax.lax.while_loop(
        cond, cycle, (x, jnp.int32(0), jnp.asarray(jnp.inf, rdtype))
    )
    # report the TRUE (unpreconditioned) relative residual
    tnorm = _norm_cols(b)
    tnorm = jnp.where(tnorm == 0, 1.0, tnorm)
    true_res = jnp.max(_norm_cols(b - A(x)) / tnorm)
    out = x[:, 0] if squeeze else x
    return KrylovResult(out, it, true_res, res <= tol)


def block_gmres(
    A: Callable,
    b,
    M: Optional[Callable] = None,
    x0=None,
    tol: float = 1e-6,
    maxiter: int = 200,
    restart: int = 20,
    axis_name: Optional[str] = None,
) -> KrylovResult:
    """TRUE block GMRES(m): all right-hand-side columns share ONE Krylov
    subspace (block Arnoldi with blocked modified Gram-Schmidt + QR), so one
    operator application advances every column — HPDDM's block methods
    behind ``ddm.hpp:193``, vs :func:`gmres` which iterates columns jointly
    but with independent subspaces.

    ``maxiter`` counts BLOCK iterations (operator applications on the block).
    The small least-squares problem min‖H̄ Y − E₁S‖_F is re-solved per step
    for the convergence test (it is (m+1)·mu × m·mu — host-scale).
    """
    b = jnp.asarray(b)
    if b.ndim == 1:
        raise ValueError("block_gmres needs a 2-D [n, mu] right-hand side")
    _vdot = _make_vdot(axis_name)

    def _bdot(Ab, Bb):
        """Block inner product Aᴴ·B [p, q] with optional psum."""
        d = jnp.einsum("np,nq->pq", jnp.conj(Ab), Bb)
        if axis_name is not None:
            d = jax.lax.psum(d, axis_name)
        return d

    def _norm_cols_loc(a):
        return jnp.sqrt(jnp.abs(_vdot(a, a)).real)

    n, mu = b.shape
    if M is None:
        M = lambda v: v
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0).reshape(n, mu)
    dtype = jnp.result_type(b.dtype, A(b).dtype)
    b = b.astype(dtype)
    x = x.astype(dtype)
    m = int(min(restart, maxiter))

    Mb = M(b)
    bnorm = _norm_cols_loc(Mb)
    bnorm = jnp.where(bnorm == 0, 1.0, bnorm)

    def _block_qr(W):
        """Gram-based QR of the tall block W [n, mu] (mesh-aware): W = Q R
        with R from the Cholesky of the psum'd Gram matrix (shifted for
        rank deficiency)."""
        Gm = _bdot(W, W)
        # tiny shift keeps the factor invertible when columns have converged
        eps_sh = jnp.asarray(1e-30, Gm.real.dtype)
        Rf = jnp.linalg.cholesky(
            Gm + eps_sh * jnp.eye(mu, dtype=Gm.dtype)
        )  # lower L with W^H W = L L^H
        R = jnp.conj(Rf).T
        Q = jnp.conj(
            jax.scipy.linalg.solve_triangular(Rf, jnp.conj(W).T, lower=True)
        ).T
        return Q, R

    def cycle(carry):
        x, it, _ = carry
        R0 = M(b - A(x)).astype(dtype)
        V0, S = _block_qr(R0)
        V = jnp.zeros((m + 1, n, mu), dtype).at[0].set(V0)
        # block Hessenberg: H [(m+1), m, mu, mu]
        H = jnp.zeros((m + 1, m, mu, mu), dtype)
        g = jnp.zeros(((m + 1) * mu, mu), dtype)
        g = g.at[:mu, :].set(S.astype(dtype))

        def ls_residual(H, j):
            """Columnwise residual of min ||Hbar Y - g|| over j block cols."""
            Hf = H.transpose(0, 2, 1, 3).reshape((m + 1) * mu, m * mu)
            colmask = (jnp.arange(m * mu) < (j * mu))[None, :]
            rowmask = (jnp.arange((m + 1) * mu) < ((j + 1) * mu))[:, None]
            Hm = jnp.where(colmask & rowmask, Hf, 0)
            gm = jnp.where(rowmask, g, 0)
            Y = jnp.linalg.lstsq(Hm, gm)[0]
            r = gm - Hm @ Y
            return Y, jnp.sqrt(jnp.sum(jnp.abs(r) ** 2, axis=0))

        def step_cond(st):
            V, H, it, j, res = st
            return (j < m) & jnp.any(res > tol) & (it < maxiter)

        def step(st):
            V, H, it, j, _ = st
            W = M(A(V[j])).astype(dtype)

            def mgs(i, acc):
                W, H = acc
                coef = jnp.where(i <= j, 1.0, 0.0).astype(dtype)
                Hij = _bdot(V[i], W) * coef
                W = W - V[i] @ Hij
                H = H.at[i, j].add(jnp.where(i < m, Hij, 0))
                return (W, H)

            W, H = jax.lax.fori_loop(0, m + 1, mgs, (W, H))
            Q, Rj = _block_qr(W)
            H = H.at[j + 1, j].set(Rj.astype(dtype))
            V = V.at[j + 1].set(Q.astype(dtype))
            _, res = ls_residual(H, j + 1)
            return (V, H, it + 1, j + 1, res / bnorm)

        rinf = jnp.full((mu,), jnp.inf, jnp.zeros((), dtype).real.dtype)
        V, H, it, j_used, res = jax.lax.while_loop(
            step_cond, step, (V, H, it, jnp.int32(0), rinf)
        )
        Y, _ = ls_residual(H, j_used)
        # x += sum_i V_i Y[i*mu:(i+1)*mu, :]
        Yb = Y.reshape(m, mu, mu)
        x = x + jnp.einsum("jnp,jpq->nq", V[:m], Yb)
        res_now = jnp.max(_norm_cols_loc(M(b - A(x))) / bnorm)
        return (x, it, res_now)

    def cond(carry):
        x, it, res = carry
        return (it < maxiter) & (res > tol)

    rdtype = jnp.zeros((), dtype).real.dtype
    x, it, res = jax.lax.while_loop(
        cond, cycle, (x, jnp.int32(0), jnp.asarray(jnp.inf, rdtype))
    )
    tnorm = _norm_cols_loc(b)
    tnorm = jnp.where(tnorm == 0, 1.0, tnorm)
    true_res = jnp.max(_norm_cols_loc(b - A(x)) / tnorm)
    return KrylovResult(x, it, true_res, res <= tol)
