"""Output-tiled bucket product for NVIDIA GPUs: Pallas through Triton.

For one bucket of same-shape blocks ``W [nb, P, Q]`` it accumulates::

    y[out_off[b] + i] += sum_j op(W[b])[i, j] * x[in_off[b] + j]

with ``op`` the identity or the transpose.  The output vector is cut into
tiles of ``tm`` rows and one program owns each tile.  The (tile, block)
pairs that touch a tile are listed in output order (built in-jit from the
offsets: one ``argsort`` and two histograms); the program walks its pairs, loads the rows of
each block that fall in its tile and the matching slice of ``x`` chunk by
chunk, keeps the sum in registers and stores the tile once.  So the
product reads every stored entry once, with no gathered copy of ``x``, no
scatter-add of per-block results and no atomics.  Padded rows and columns
of ``W`` are exact zeros; masked loads keep every read in range, so blocks
whose padded ranges overlap need no special case.

A low-rank bucket ``U [nb, P, r] · V [nb, r, Q]`` is two calls: the first
writes ``t = V·x`` per block into a compact ``[nb·r, k]`` vector, the
second adds ``U·t`` into ``y``.

Sums use float32 IEEE products (``Precision.HIGHEST``): Triton's default
for a float32 ``dot`` is TF32.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["ROW_ALIGN", "K_ALIGN", "X_OVERREAD", "tiled_bucket_apply", "pad_len"]

# y buffers are padded to a multiple of the largest tile, x buffers by one
# contraction chunk past the last block, right-hand sides to 16 columns (the
# smallest operand Triton's dot takes)
ROW_ALIGN = 64
K_ALIGN = 16
X_OVERREAD = 64


def pad_len(n: int, align: int = ROW_ALIGN) -> int:
    return -(-n // align) * align


def _tiles(n_out: int, n_in: int) -> tuple[int, int]:
    """(rows per output tile, contraction chunk): powers of two, at most
    64 x 64 float32 (16 KB) of ``W`` per step; the chunk divides ``n_in``
    where it can, so the loads need no column mask."""
    tm = min(ROW_ALIGN, max(16, pl.next_power_of_2(n_out)))
    tk = next((c for c in (64, 32, 16) if n_in % c == 0), X_OVERREAD)
    return tm, tk


def _tile_ranges(out_off, n_out: int, tm: int, n_tiles: int):
    """Blocks in output order and, per tile, the range of them that touch
    it.  With equal block heights a block's first and last tile are both
    nondecreasing in ``out_off``, so tile ``t``'s blocks are those after the
    ones that end before ``t`` and up to the last that starts at or before
    ``t``: two histogram prefix sums."""
    order = jnp.argsort(out_off).astype(jnp.int32)
    first = jnp.minimum(out_off // tm, n_tiles)
    last = jnp.minimum((out_off + n_out - 1) // tm, n_tiles)
    ends_before = jnp.bincount(last + 1, length=n_tiles + 2)[:n_tiles]
    started = jnp.bincount(first, length=n_tiles + 1)[:n_tiles]
    lo = jnp.cumsum(ends_before).astype(jnp.int32)
    hi = jnp.cumsum(started).astype(jnp.int32)
    return order, lo, hi


def _kernel(order_ref, lo_ref, hi_ref, in_off_ref, out_off_ref, w_ref, x_ref,
            y_ref, *, tm, tk, n_out, n_in, trans, k_pad):
    t = pl.program_id(0)
    kcols = jnp.arange(k_pad)
    col_mask = n_in % tk != 0  # static: a partial last chunk

    def pair(j, acc):
        b = order_ref[j]
        brow = t * tm - out_off_ref[b] + jnp.arange(tm)  # block-local rows
        rmask = (brow >= 0) & (brow < n_out)
        x0 = in_off_ref[b]

        def chunk(c, acc):
            bcol = c * tk + jnp.arange(tk)
            mask = rmask[:, None]
            if col_mask:
                mask = mask & (bcol < n_in)[None, :]
            else:
                mask = jnp.broadcast_to(mask, (tm, tk))
            if trans:  # W[b] is [n_in, n_out]: load its transpose tile
                idx = (b, bcol[None, :], brow[:, None])
            else:
                idx = (b, brow[:, None], bcol[None, :])
            w = plgpu.load(w_ref.at[idx], mask=mask, other=0.0)
            xc = x_ref[(x0 + bcol)[:, None], kcols[None, :]]
            return acc + jnp.dot(w, xc, precision=lax.Precision.HIGHEST,
                                 preferred_element_type=jnp.float32)

        return lax.fori_loop(0, pl.cdiv(n_in, tk), chunk, acc)

    acc = lax.fori_loop(lo_ref[t], hi_ref[t], pair,
                        jnp.zeros((tm, k_pad), jnp.float32))
    y_ref[t * tm + jnp.arange(tm)[:, None], kcols[None, :]] = acc.astype(
        y_ref.dtype)


@partial(jax.jit, static_argnames=("out_rows", "trans", "interpret"))
def tiled_bucket_apply(w, x, in_off, out_off, *, out_rows, trans=False,
                       interpret=False):
    """``[out_rows, k_pad]`` vector of ``sum_b op(w[b]) @ x[in_off[b] : ...]``
    placed at ``out_off[b]``; rows a block's padding pushes past
    ``out_rows`` are dropped (they are zero).

    ``w [nb, P, Q]`` (``op(w[b])`` is ``[Q, P]`` when ``trans``);
    ``x [Lx, k_pad]`` with ``Lx >= max(in_off) + n_in + X_OVERREAD`` and
    ``k_pad`` a multiple of ``K_ALIGN``; ``out_rows`` a multiple of
    ``ROW_ALIGN``.  Real dtypes only.  ``interpret`` runs the kernel on the
    CPU (tests)."""
    nb, P, Q = w.shape
    n_out, n_in = (Q, P) if trans else (P, Q)
    k_pad = x.shape[1]
    if out_rows % ROW_ALIGN or k_pad % K_ALIGN:
        raise ValueError(f"unaligned buffers: out_rows {out_rows}, x {x.shape}")
    tm, tk = _tiles(n_out, n_in)
    n_tiles = out_rows // tm
    out_off = out_off.astype(jnp.int32)
    order, lo, hi = _tile_ranges(out_off, n_out, tm, n_tiles)
    kernel = partial(_kernel, tm=tm, tk=tk, n_out=n_out, n_in=n_in,
                     trans=trans, k_pad=k_pad)
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((out_rows, k_pad), x.dtype),
        grid=(n_tiles,),
        interpret=interpret,
        backend="triton",
        # 2, 4 or 8 warps and 2 or 3 stages measured within 10% at n=100k
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        name=f"tiled_bucket_apply_{'t' if trans else 'n'}",
    )(order, lo, hi, in_off.astype(jnp.int32), out_off, w, x)
