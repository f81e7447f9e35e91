"""Batched partial ACA on device.

Batched re-design of the reference's sequential partial-pivot ACA
(``hmatrix/lrmat/partialACA.hpp:42-184``): one jitted ``lax.while_loop`` runs
masked pivoting steps **simultaneously for a whole bucket of admissible
blocks** (same padded shape, early exit once every block converged), with the
generator evaluated as a
batched gather+kernel on device.  Per-block state (current pivot row, visited
rows/cols, Frobenius estimator, rank, convergence) is carried as arrays.

Parity-preserving behavioral details:
- first pivot row is row 0 of the block (partialACA.hpp:51)
- pivot = argmax |residual| over unvisited cols/rows (partialACA.hpp:99-133)
- stopping estimator: incremental Frobenius norm of the accumulated low-rank
  matrix; stop when sqrt(aux/frob) <= epsilon (partialACA.hpp:78,136-150)
- advantage bound: abort to dense when rank·(M+N) > M·N (partialACA.hpp:84)
- zero pivot (<=1e-15): stop; dense fallback if it was the first cross
  (partialACA.hpp:115,158-165)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from ..utils.precision import precise_jit

__all__ = ["batched_partial_aca"]


@partial(precise_jit, static_argnames=("rmax", "reqrank"))
def batched_partial_aca(
    gen,
    rows,  # [nb, m] int — user-numbering row indices (padded entries clamped)
    cols,  # [nb, n] int
    t_sizes,  # [nb] int — true (unpadded) block row counts
    s_sizes,  # [nb] int
    epsilon: float,
    rmax: int,
    reqrank: int = -1,
):
    """Returns (U [nb, m, rmax], V [nb, rmax, n], rank [nb], failed [nb]).

    ``failed`` marks blocks that must fall back to dense storage (the
    reference's "false positives", tree_builder.hpp:572-577).
    """
    nb, m = rows.shape
    n = cols.shape[1]
    dtype = gen.dtype
    rdtype = jnp.zeros((), dtype).real.dtype

    row_mask = jnp.arange(m)[None, :] < t_sizes[:, None]  # [nb, m]
    col_mask = jnp.arange(n)[None, :] < s_sizes[:, None]  # [nb, n]

    U0 = jnp.zeros((nb, m, rmax), dtype)
    V0 = jnp.zeros((nb, rmax, n), dtype)
    state = dict(
        U=U0,
        V=V0,
        visited_row=jnp.zeros((nb, m), bool),
        visited_col=jnp.zeros((nb, n), bool),
        I=jnp.zeros((nb,), jnp.int32),
        frob=jnp.zeros((nb,), rdtype),
        q=jnp.zeros((nb,), jnp.int32),
        active=jnp.ones((nb,), bool),
        failed=jnp.zeros((nb,), bool),
    )

    state["k"] = jnp.zeros((), jnp.int32)
    eps2 = jnp.asarray(epsilon, rdtype) ** 2
    barange = jnp.arange(nb)

    def body(st):
        k = st["k"]
        active = st["active"]
        failed = st["failed"]

        # advantage bound (partialACA.hpp:84)
        if reqrank < 0:
            not_adv = (k + 1) * (t_sizes + s_sizes) > t_sizes * s_sizes
        else:
            not_adv = jnp.zeros((nb,), bool)
        failed = failed | (active & not_adv)
        active = active & ~not_adv

        # ---- row cross: residual of row I ----
        rows_I = rows[barange, st["I"]]  # [nb]
        r = gen.block(rows_I[:, None], cols)[:, 0, :]  # [nb, n]
        u_I = st["U"][barange, st["I"], :]  # [nb, rmax]
        r = r - jnp.einsum("br,brn->bn", u_I, st["V"])
        r = jnp.where(col_mask, r, 0)

        pivot_score = jnp.where(
            st["visited_col"] | ~col_mask, -jnp.inf, jnp.abs(r)
        )
        J = jnp.argmax(pivot_score, axis=1).astype(jnp.int32)  # [nb]
        rJ = r[barange, J]

        visited_row = st["visited_row"] | (
            (jnp.arange(m)[None, :] == st["I"][:, None]) & active[:, None]
        )

        # zero pivot (partialACA.hpp:115,158-165)
        zero_pivot = jnp.abs(rJ) <= 1e-15
        failed = failed | (active & zero_pivot & (st["q"] == 0))
        active = active & ~zero_pivot

        # ---- column cross ----
        cols_J = cols[barange, J]  # [nb]
        c = gen.block(rows, cols_J[:, None])[:, :, 0]  # [nb, m]
        v_J = st["V"][barange, :, J]  # [nb, rmax]
        c = c - jnp.einsum("bmr,br->bm", st["U"], v_J)
        gamma = jnp.where(zero_pivot, jnp.ones_like(rJ), 1.0 / jnp.where(zero_pivot, 1, rJ))
        c = c * gamma[:, None]
        c = jnp.where(row_mask, c, 0)

        next_score = jnp.where(visited_row | ~row_mask, -jnp.inf, jnp.abs(c))
        I_next = jnp.argmax(next_score, axis=1).astype(jnp.int32)

        visited_col = st["visited_col"] | (
            (jnp.arange(n)[None, :] == J[:, None]) & active[:, None]
        )

        # ---- Frobenius estimator (partialACA.hpp:136-150) ----
        aux = jnp.abs(jnp.sum(c * c, axis=1)) * jnp.abs(jnp.sum(r * r, axis=1))
        Vr = jnp.einsum("brn,bn->br", st["V"], r)  # [nb, rmax]
        Uc = jnp.einsum("bmr,bm->br", st["U"], c)  # [nb, rmax]
        frob_cross = jnp.sum(Vr * Uc, axis=1)
        frob = jnp.where(
            active, st["frob"] + aux + 2.0 * jnp.real(frob_cross), st["frob"]
        )

        # ---- commit cross k for still-active blocks ----
        # select INSIDE the written slice: a where over the full [nb, m,
        # rmax] state would copy the whole buffer every iteration (2 GB+/it
        # at panel scale — measured as the ACA walltime driver); the masked
        # slice write updates the loop-carried buffer in place
        upd = active
        c_k = jnp.where(upd[:, None], c, st["U"][:, :, k])
        r_k = jnp.where(upd[:, None], r, st["V"][:, k, :])
        U = st["U"].at[:, :, k].set(c_k)
        V = st["V"].at[:, k, :].set(r_k)
        q = jnp.where(upd, k + 1, st["q"])
        I = jnp.where(upd, I_next, st["I"])

        # ---- stopping test ----
        if reqrank < 0:
            converged = upd & (aux <= eps2 * frob)
        else:
            limit = jnp.minimum(
                jnp.asarray(reqrank, jnp.int32),
                jnp.minimum(t_sizes, s_sizes).astype(jnp.int32),
            )
            converged = upd & (q >= limit)
        active = active & ~converged

        # visited_row/visited_col one-hots above are already gated on `active`
        return dict(
            U=U,
            V=V,
            visited_row=visited_row,
            visited_col=visited_col,
            I=I,
            frob=frob,
            q=q,
            active=active,
            failed=failed,
            k=k + 1,
        )

    st = jax.lax.while_loop(
        lambda st: (st["k"] < rmax) & jnp.any(st["active"]), body, state
    )
    # blocks that never converged within rmax steps fall back to dense
    failed = st["failed"] | (st["active"] if reqrank < 0 else jnp.zeros((nb,), bool))
    rank = jnp.where(failed, 0, st["q"])
    return st["U"], st["V"], rank, failed
