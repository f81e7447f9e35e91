"""Full-precision matmul policy for the compute path.

A float32 ``dot_general`` on a Hopper GPU may run in TF32 (about three
decimal digits) unless a precision is requested, which breaks the library's
accuracy contract — the reference computes in full f64 BLAS
(``wrappers/wrapper_blas.hpp:24-42``) and its acceptance tests require
relative Frobenius error < ε
(``tests/functional_tests/hmatrix/test_hmatrix_build.hpp:191``).  The
package sets ``jax_default_matmul_precision="highest"`` at import
(``htool_tpu/__init__.py``); ``chip_smoke.py``'s precision phase checks on
the card that the product's arithmetic stays at float32 accuracy.

``precise_jit`` is a drop-in for :func:`jax.jit` that traces its function
under ``jax.default_matmul_precision('highest')``, so the policy holds even
where a caller opted out of the global default.  ``full_precision()`` is
the bare context manager for eager (non-jitted) compute sections.
"""

from __future__ import annotations

import functools

import jax

__all__ = ["precise_jit", "full_precision"]


def full_precision():
    """Context manager: full-f32 matmul precision for eager sections."""
    return jax.default_matmul_precision("highest")


def precise_jit(fn=None, **jit_kwargs):
    """``jax.jit`` that traces under full matmul precision.

    Usable bare (``@precise_jit``) or with jit keywords
    (``@precise_jit(static_argnames=...)`` / via ``functools.partial``)."""
    if fn is None:
        return lambda f: precise_jit(f, **jit_kwargs)

    @functools.wraps(fn)
    def _traced(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return jax.jit(_traced, **jit_kwargs)
