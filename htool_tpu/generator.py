"""Matrix generators — the user-supplied entry oracle.

Equivalent of the reference's ``VirtualGenerator`` /
``VirtualInternalGenerator`` (``hmatrix/interfaces/virtual_generator.hpp``):
the user supplies a rule for arbitrary sub-blocks of the (never materialized)
dense matrix.  The difference: instead of a ``copy_submatrix`` filling
a host pointer, a generator exposes a **jittable, batched gather**:
``block(rows, cols) -> entries`` where ``rows``/``cols`` are integer index
arrays in *user numbering* with arbitrary leading batch dimensions.  This is
what lets assembly and ACA run as single fused device kernels over whole
buckets of blocks at once.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "Generator",
    "KernelGenerator",
    "MatrixGenerator",
    "SubsetGenerator",
    "TransposedGenerator",
]


class Generator:
    """Entry oracle in user numbering.

    Subclasses implement :meth:`block`.  ``rows``: int array ``[..., m]``;
    ``cols``: int array ``[..., n]`` -> entries ``[..., m, n]``.  Must be
    jittable (traced inside assembly/compression kernels).
    """

    shape: tuple[int, int]
    dtype: jnp.dtype

    def block(self, rows, cols):
        raise NotImplementedError

    # convenience: full dense materialization (oracle for tests)
    def to_dense(self):
        M, N = self.shape
        return self.block(jnp.arange(M), jnp.arange(N))


class KernelGenerator(Generator):
    """Generator defined by a coordinate kernel ``k(x, y)``.

    ``kernel`` maps broadcastable coordinate arrays ``[..., d]`` to scalars
    ``[...]`` using jnp ops.  Equivalent to the reference's BEM-style test
    generators (``testing/generator_test.hpp:155-205``) but evaluated batched
    on device.
    """

    def __init__(self, kernel: Callable, target_points, source_points, dtype=None):
        self.kernel = kernel
        self.target_points = jnp.asarray(target_points)
        self.source_points = jnp.asarray(source_points)
        self.shape = (self.target_points.shape[0], self.source_points.shape[0])
        if dtype is None:
            # eval_shape: dtype inference with zero device work
            probe = jax.eval_shape(
                kernel,
                jax.ShapeDtypeStruct(
                    self.target_points.shape[1:], self.target_points.dtype
                ),
                jax.ShapeDtypeStruct(
                    self.source_points.shape[1:], self.source_points.dtype
                ),
            )
            dtype = probe.dtype
        self.dtype = dtype

    def _block_impl(self, rows, cols):
        tx = self.target_points[rows]  # [..., m, d]
        sy = self.source_points[cols]  # [..., n, d]
        out = self.kernel(tx[..., :, None, :], sy[..., None, :, :])
        return out.astype(self.dtype)

    def block(self, rows, cols):
        if isinstance(rows, jax.core.Tracer) or isinstance(cols, jax.core.Tracer):
            return self._block_impl(rows, cols)
        # eager call sites go through jit so kernel constants (e.g. complex
        # scalars) compile into the program instead of being device_put.
        # lazy: pytree unflattening bypasses __init__ (object.__new__)
        jit_fn = self.__dict__.get("_block_jit")
        if jit_fn is None:
            jit_fn = self._block_jit = jax.jit(self._block_impl)
        return jit_fn(jnp.asarray(rows), jnp.asarray(cols))


class SubsetGenerator(Generator):
    """Restriction of a generator to index subsets — the analog of
    ``LocalGeneratorInUserNumberingFromMatrix`` (testing/generator_test.hpp:
    263-277): local index i maps to global user index ``row_index[i]``."""

    def __init__(self, base: "Generator", row_index, col_index=None):
        self.base = base
        self.row_index = jnp.asarray(row_index, jnp.int32)
        self.col_index = (
            self.row_index if col_index is None else jnp.asarray(col_index, jnp.int32)
        )
        self.shape = (int(self.row_index.shape[0]), int(self.col_index.shape[0]))
        self.dtype = base.dtype

    def block(self, rows, cols):
        return self.base.block(self.row_index[rows], self.col_index[cols])


class TransposedGenerator(Generator):
    """View of a generator's transpose: ``block(r, c) = base.block(c, r)ᵀ``
    (used by the sympartialACA orientation, sympartialACA.hpp:48-63)."""

    def __init__(self, base: "Generator"):
        self.base = base
        self.shape = (base.shape[1], base.shape[0])
        self.dtype = base.dtype

    def block(self, rows, cols):
        return jnp.swapaxes(self.base.block(cols, rows), -1, -2)


class MatrixGenerator(Generator):
    """Generator backed by a stored dense matrix (user numbering) —
    equivalent of ``GeneratorInUserNumberingFromMatrix``
    (``testing/generator_test.hpp:207-221``)."""

    def __init__(self, matrix):
        self.matrix = jnp.asarray(matrix)
        self.shape = tuple(self.matrix.shape)
        self.dtype = self.matrix.dtype

    def block(self, rows, cols):
        rows = jnp.asarray(rows)
        cols = jnp.asarray(cols)
        return self.matrix[rows[..., :, None], cols[..., None, :]]


# ----------------------------------------------------------------------
# pytree registration
#
# Generators are passed INTO jitted kernels (assembly, ACA) as pytree
# arguments, never closed over: a closed-over coordinate/matrix array gets
# baked into the HLO as a constant, which blows XLA compile time up by
# orders of magnitude at realistic point counts.
# ----------------------------------------------------------------------


def _kernel_flatten(g: KernelGenerator):
    return (g.target_points, g.source_points), (g.kernel, g.dtype, g.shape)


def _kernel_unflatten(aux, leaves):
    g = object.__new__(KernelGenerator)
    g.target_points, g.source_points = leaves
    g.kernel, g.dtype, g.shape = aux
    return g


def _matrix_flatten(g: MatrixGenerator):
    return (g.matrix,), (g.dtype, g.shape)


def _matrix_unflatten(aux, leaves):
    g = object.__new__(MatrixGenerator)
    (g.matrix,) = leaves
    g.dtype, g.shape = aux
    return g


def _transposed_flatten(g: TransposedGenerator):
    return (g.base,), (g.dtype, g.shape)


def _transposed_unflatten(aux, leaves):
    g = object.__new__(TransposedGenerator)
    (g.base,) = leaves
    g.dtype, g.shape = aux
    return g


def _subset_flatten(g: SubsetGenerator):
    return (g.base, g.row_index, g.col_index), (g.dtype, g.shape)


def _subset_unflatten(aux, leaves):
    g = object.__new__(SubsetGenerator)
    g.base, g.row_index, g.col_index = leaves
    g.dtype, g.shape = aux
    return g


jax.tree_util.register_pytree_node(KernelGenerator, _kernel_flatten, _kernel_unflatten)
jax.tree_util.register_pytree_node(MatrixGenerator, _matrix_flatten, _matrix_unflatten)
jax.tree_util.register_pytree_node(SubsetGenerator, _subset_flatten, _subset_unflatten)
jax.tree_util.register_pytree_node(
    TransposedGenerator, _transposed_flatten, _transposed_unflatten
)
