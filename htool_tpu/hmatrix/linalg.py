"""H-matrix products (matvec / multi-RHS matmat) and dense export.

Batched re-design of the reference leaf-loop products
(``hmatrix/linalg/add_hmatrix_vector_product.hpp:17-206`` and the row-major
multi-RHS variants): the per-leaf gemv loop becomes, per bucket, a gather of
the input slices, ONE batched einsum against the stacked blocks, and a
scatter-add into the output, which XLA compiles as it stands.  For large
float32 operators with several right-hand sides on a GPU the same bucket
terms run through the output-tiled Triton kernel of :mod:`.tiled_product`
instead (:func:`product_route`).  Padded rows/cols are exact zeros so no
masking is needed.  Symmetric/hermitian mirrored contributions
(``add_hmatrix_vector_product.hpp:56-104``) are separate bucket terms with
the transposed/conjugated operand.

All core routines work in **cluster numbering** on 2-D ``[n, nrhs]`` arrays;
user-numbering wrappers apply the permutations as gathers
(``add_hmatrix_vector_product.hpp:172-206``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import tiled_product as tp
from .hmatrix import DenseBucket, HMatrix, LowRankBucket
from ..utils.precision import precise_jit

__all__ = [
    "product_route",
    "matvec",
    "matvec_user",
    "matmat",
    "matmat_user",
    "to_dense",
    "copy_diagonal",
    "copy_diagonal_user",
]


def _gather(x_pad, off, width):
    """x_pad [L, k], off [nb] -> [nb, width, k]."""
    idx = off[:, None] + jnp.arange(width)[None, :]
    return x_pad[idx]


def _scatter_add(y_pad, off, width, contrib):
    idx = off[:, None] + jnp.arange(width)[None, :]
    return y_pad.at[idx].add(contrib)


def _apply_dense(data, xg, mode):
    """data [nb, m, n] applied to xg [nb, ·, k] under mode."""
    if mode == "N":
        return jnp.einsum("bmn,bnk->bmk", data, xg)
    if mode == "T":
        return jnp.einsum("bmn,bmk->bnk", data, xg)
    if mode == "C":
        return jnp.einsum("bmn,bmk->bnk", jnp.conj(data), xg)
    if mode == "conj":  # conj(A) · x
        return jnp.einsum("bmn,bnk->bmk", jnp.conj(data), xg)
    raise ValueError(mode)


def _apply_lr(U, V, xg, mode):
    """U [nb, m, r], V [nb, r, n] applied to xg under mode."""
    if mode == "N":
        t = jnp.einsum("brn,bnk->brk", V, xg)
        return jnp.einsum("bmr,brk->bmk", U, t)
    if mode == "T":
        t = jnp.einsum("bmr,bmk->brk", U, xg)
        return jnp.einsum("brn,brk->bnk", V, t)
    if mode == "C":
        t = jnp.einsum("bmr,bmk->brk", jnp.conj(U), xg)
        return jnp.einsum("brn,brk->bnk", jnp.conj(V), t)
    if mode == "conj":
        t = jnp.einsum("brn,bnk->brk", jnp.conj(V), xg)
        return jnp.einsum("bmr,brk->bmk", jnp.conj(U), t)
    raise ValueError(mode)


def _bucket_terms(bucket, op: str, symmetry: str):
    """Yield (in_side, out_side, mode, is_mirror) contribution terms for a
    bucket under product op in {'N','T','C'}.

    The stored block A sits at (t, s).  A symmetric matrix additionally has
    g(A) at (s, t) with g = transpose ('S') or conj-transpose ('H') for
    mirror buckets.  Sides are 't' or 's'.  For partition-restricted
    symmetric storage, mirror blocks live inside the diagonal partition
    block, so their 's'-side offsets are in ROW (local) space — the caller
    localizes the 's' side of mirror terms and the 't' side of stored terms.
    """
    terms = []
    if op == "N":
        terms.append(("s", "t", "N", False))
    elif op == "T":
        terms.append(("t", "s", "T", False))
    elif op == "C":
        terms.append(("t", "s", "C", False))
    else:
        raise ValueError(op)

    if bucket.mirror:
        if symmetry == "S":
            # g(A) = A^T at (s, t)
            mirror_modes = {"N": "T", "T": "N", "C": "conj"}
        elif symmetry == "H":
            # g(A) = A^H at (s, t)
            mirror_modes = {"N": "C", "T": "conj", "C": "N"}
        else:
            raise ValueError("mirror bucket in non-symmetric matrix")
        mode = mirror_modes[op]
        if op == "N":
            terms.append(("t", "s", mode, True))
        else:
            terms.append(("s", "t", mode, True))
    return terms


# When the output-tiled kernel beats XLA (one H100, float32, see PERF.md):
# its fixed cost — two launches and an argsort per bucket term, ≈0.3 ms —
# pays off only on large operators.  It was 27% faster at n=100k (1.87 GB
# stored, 2 to 8 right-hand sides) and 40% slower at n=10k (0.11 GB); with
# one right-hand side XLA already runs at the copy bound.  512 MiB is the
# crossover those two sizes give; above 64 columns the kernel's register
# tile is unmeasured.
KERNEL_MIN_BYTES = 512 * 2**20
KERNEL_RHS = (2, 64)


def product_route(dtype, nrhs: int, nbytes: int,
                  backend: str | None = None) -> str:
    """How :func:`matvec` runs the buckets: ``"triton"`` (the output-tiled
    kernel of :mod:`.tiled_product`) for float32 on a GPU with 2 to 64
    right-hand sides and at least ``KERNEL_MIN_BYTES`` of stored entries,
    ``"xla"`` (gather → batched einsum → scatter-add) otherwise.  No
    fallback: a kernel failure is an error."""
    backend = jax.default_backend() if backend is None else backend
    lo, hi = KERNEL_RHS
    if (backend == "gpu" and jnp.dtype(dtype) == jnp.float32
            and lo <= nrhs <= hi and nbytes >= KERNEL_MIN_BYTES):
        return "triton"
    return "xla"


def matvec(h: HMatrix, x, op: str = "N"):
    """Product in cluster numbering: ``op(H) @ x``.

    ``x``: [N] or [N, k] (cluster numbering of the source tree for 'N',
    target for 'T'/'C').  For a partition-restricted block-row, 'N' returns
    the local rows; 'T'/'C' takes the local rows slice as input and returns a
    GLOBAL-size output (the caller reduces across partitions).
    """
    nrhs = 1 if x.ndim == 1 else x.shape[1]
    route = product_route(jnp.result_type(h.dtype, x.dtype), nrhs, h.nbytes)
    return _matvec(h, x, op=op, route=route)


@partial(precise_jit, static_argnames=("op", "route"))
def _matvec(h: HMatrix, x, op: str, route: str):
    """``route``: "xla", "triton", or "interpret" (the Triton kernel run by
    the Pallas interpreter, for tests on the CPU)."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]

    m_loc, n_glob = h.shape
    out_is_t = op == "N"
    out_len = m_loc if out_is_t else n_glob
    dtype = jnp.result_type(h.dtype, x.dtype)
    k = x.shape[1]

    # pad widths: max block extent so gathers/scatters stay in range
    widths = [b.block_shape for b in h.dense_buckets] + [
        b.block_shape for b in h.lr_buckets
    ]
    max_bm = max([w[0] for w in widths], default=1)
    max_bn = max([w[1] for w in widths], default=1)
    pad_in = max(max_bm, max_bn)

    if route == "xla":
        x_pad = jnp.concatenate(
            [x.astype(dtype), jnp.zeros((pad_in, k), dtype)], axis=0
        )
        y_pad = jnp.zeros((out_len + pad_in, k), dtype)
    else:
        k_pad = tp.pad_len(k, tp.K_ALIGN)
        x_pad = jnp.zeros((x.shape[0] + pad_in + tp.X_OVERREAD, k_pad), dtype)
        x_pad = x_pad.at[: x.shape[0], :k].set(x.astype(dtype))
        y_pad = jnp.zeros((tp.pad_len(out_len), k_pad), dtype)
    kernel = partial(tp.tiled_bucket_apply, interpret=route == "interpret")

    # input offset base: x is indexed in the numbering of its own root
    # (local t-offsets are shifted by t_root_off)
    for bucket in h.dense_buckets + h.lr_buckets:
        is_dense = isinstance(bucket, DenseBucket)
        bm, bn = bucket.block_shape
        for in_side, out_side, mode, is_mirror in _bucket_terms(
            bucket, op, h.symmetry
        ):
            # the "row/local" side (localized by t_root_off) is 't' for
            # stored terms and 's' for mirror terms (mirror blocks sit in
            # the diagonal partition block, see _bucket_terms)
            local_side = "s" if is_mirror else "t"

            def off_of(side):
                base = bucket.t_off if side == "t" else bucket.s_off
                return base - h.t_root_off if side == local_side else base

            in_off = off_of(in_side)
            out_off = off_of(out_side)
            in_w = bm if in_side == "t" else bn
            out_w = bm if out_side == "t" else bn

            if route != "xla":
                # real dtype: 'C' is 'T' and 'conj' is 'N'
                trans = mode in ("T", "C")
                y_rows = y_pad.shape[0]
                if is_dense:
                    y_pad = y_pad + kernel(bucket.data.astype(dtype), x_pad,
                                           in_off, out_off, out_rows=y_rows,
                                           trans=trans)
                    continue
                # t = op(first)·x per block into a compact [nb·r, k] vector,
                # then y += op(second)·t
                first, second = (bucket.U, bucket.V) if trans else (bucket.V, bucket.U)
                r = bucket.rank_padded
                mid_off = jnp.arange(bucket.n_blocks, dtype=jnp.int32) * r
                t_rows = tp.pad_len(bucket.n_blocks * r + tp.X_OVERREAD)
                t = kernel(first.astype(dtype), x_pad, in_off, mid_off,
                           out_rows=t_rows, trans=trans)
                y_pad = y_pad + kernel(second.astype(dtype), t, mid_off, out_off,
                                       out_rows=y_rows, trans=trans)
                continue

            xg = _gather(x_pad, in_off, in_w)
            if is_dense:
                yb = _apply_dense(bucket.data.astype(dtype), xg, mode)
            else:
                yb = _apply_lr(
                    bucket.U.astype(dtype), bucket.V.astype(dtype), xg, mode
                )
            y_pad = _scatter_add(y_pad, out_off, out_w, yb)

    y = y_pad[:out_len, :k]
    return y[:, 0] if squeeze else y


def matmat(h: HMatrix, X, op: str = "N"):
    """Multi-RHS product in cluster numbering (row-major multi-RHS analog,
    ``add_hmatrix_matrix_product_row_major.hpp``)."""
    return matvec(h, X, op=op)


def matvec_user(h: HMatrix, x, op: str = "N"):
    """Product in USER numbering (global): permute in, product, permute out
    (``add_hmatrix_vector_product.hpp:172-206``).  Only valid for global
    (non-partition-restricted) H-matrices."""
    x = jnp.asarray(x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    n_in = h.shape[1] if op == "N" else h.shape[0]
    if x.shape[0] != n_in:
        raise ValueError(
            f"input has {x.shape[0]} rows, operator expects {n_in} (op={op!r})"
        )
    in_perm = h.perm_s if op == "N" else h.perm_t
    out_perm = h.perm_t if op == "N" else h.perm_s
    xc = x[in_perm]
    yc = matvec(h, xc, op=op)
    y = jnp.zeros_like(yc).at[out_perm].set(yc)
    return y[:, 0] if squeeze else y


def matmat_user(h: HMatrix, X, op: str = "N"):
    return matvec_user(h, X, op=op)


def copy_diagonal(h: HMatrix):
    """Diagonal of a square H-matrix in CLUSTER numbering (``copy_diagonal``,
    hmatrix.hpp:401).  Diagonal entries live only in dense (inadmissible)
    blocks sitting on the diagonal, so this is a batched gather over the
    dense buckets."""
    m_loc, n_glob = h.shape
    out = jnp.zeros((m_loc + 1,), h.dtype)  # last slot = trash
    for bucket in h.dense_buckets:
        bm, bn = bucket.block_shape
        t_loc = bucket.t_off - h.t_root_off
        # entry (t_off + i, s_off + i) is diagonal when global row == col
        k = min(bm, bn)
        ar = jnp.arange(k)
        rows_g = bucket.t_off[:, None] + ar[None, :]  # global rows
        cols_g = bucket.s_off[:, None] + ar[None, :]
        vals = bucket.data[:, ar, ar]  # [nb, k]
        on_diag = rows_g == cols_g
        idx = jnp.where(on_diag, t_loc[:, None] + ar[None, :], m_loc)
        out = out.at[idx.reshape(-1)].add(jnp.where(on_diag, vals, 0).reshape(-1))
    return out[:-1]


def copy_diagonal_user(h: HMatrix):
    """Diagonal in USER numbering (``copy_diagonal_in_user_numbering``,
    hmatrix.hpp:434).  Global square H-matrices only."""
    if h.t_root_off != 0 or h.shape[0] != h.shape[1]:
        raise ValueError("user-numbering diagonal requires a global square H-matrix")
    d = copy_diagonal(h)
    return jnp.zeros_like(d).at[h.perm_t].set(d)


def to_dense(h: HMatrix, user_numbering: bool = True) -> np.ndarray:
    """Materialize the dense matrix (``copy_to_dense``, hmatrix.hpp:298 and
    ``copy_to_dense_in_user_numbering:333``).  Host-side; for tests/oracles."""
    m_loc, n_glob = h.shape
    dtype = np.asarray(jnp.zeros((), h.dtype)).dtype
    A = np.zeros((m_loc, n_glob), dtype)

    def blocks(bucket):
        t_off = np.asarray(bucket.t_off)
        s_off = np.asarray(bucket.s_off)
        t_sz = np.asarray(bucket.t_sizes)
        s_sz = np.asarray(bucket.s_sizes)
        if isinstance(bucket, DenseBucket):
            data = np.asarray(bucket.data)
            for i in range(t_off.shape[0]):
                yield t_off[i], s_off[i], data[i, : t_sz[i], : s_sz[i]]
        else:
            U = np.asarray(bucket.U)
            V = np.asarray(bucket.V)
            for i in range(t_off.shape[0]):
                yield t_off[i], s_off[i], U[i, : t_sz[i]] @ V[i, :, : s_sz[i]]

    for bucket in h.dense_buckets + h.lr_buckets:
        for toff, soff, blk in blocks(bucket):
            A[toff - h.t_root_off : toff - h.t_root_off + blk.shape[0], soff : soff + blk.shape[1]] = blk
            if bucket.mirror:
                g = blk.T if h.symmetry == "S" else np.conj(blk.T)
                # mirrored block lives at (s, t) — only valid for global
                # square symmetric matrices
                A[soff - h.t_root_off : soff - h.t_root_off + blk.shape[1], toff : toff + blk.shape[0]] = g

    if user_numbering:
        perm_t = np.asarray(h.perm_t)
        perm_s = np.asarray(h.perm_s)
        if h.t_root_off != 0 or m_loc != perm_t.shape[0]:
            raise ValueError(
                "user-numbering dense export requires a global (non-partition-"
                "restricted) H-matrix; use user_numbering=False"
            )
        out = np.zeros_like(A)
        out[np.ix_(perm_t, perm_s)] = A
        return out
    return A
