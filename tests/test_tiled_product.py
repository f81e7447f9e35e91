"""The output-tiled Triton product on the CPU: the kernel in interpret mode
against a plain loop over blocks, its wiring into ``matvec`` against the
XLA route, the buffer checks, and the rule that picks the route."""

import numpy as np
import pytest

import jax.numpy as jnp

import htool_tpu as ht
from htool_tpu.hmatrix.linalg import KERNEL_MIN_BYTES, _matvec, product_route
from htool_tpu.hmatrix.tiled_product import X_OVERREAD, pad_len, tiled_bucket_apply
from htool_tpu.testing import create_sphere, laplace_kernel_symmetric


def _loop_reference(w, x, in_off, out_off, y, trans):
    y = np.array(y, np.float64)
    for b in range(w.shape[0]):
        blk = w[b].T if trans else w[b]
        y[out_off[b] : out_off[b] + blk.shape[0]] += (
            blk.astype(np.float64) @ x[in_off[b] : in_off[b] + blk.shape[1]]
        )
    return y


# (nb, P, Q, trans, vector length): overlapping offsets throughout; tiles
# narrower and wider than a block; contraction shorter and longer than a
# chunk, with and without a partial last chunk; a rank below 16
CASES = [
    (7, 40, 24, False, 300),
    (7, 40, 24, True, 300),
    (5, 100, 16, False, 500),
    (9, 16, 70, False, 400),
    (6, 33, 130, True, 700),
    (8, 8, 96, True, 400),
]


@pytest.mark.parametrize("nb,P,Q,trans,L", CASES)
def test_kernel_matches_loop_reference(nb, P, Q, trans, L):
    rng = np.random.RandomState(nb + P)
    w = rng.randn(nb, P, Q).astype(np.float32)
    n_out, n_in = (Q, P) if trans else (P, Q)
    out_off = rng.randint(0, L - n_out + 1, nb)
    in_off = rng.randint(0, L - n_in + 1, nb)
    x = np.zeros((L + n_in + X_OVERREAD, 16), np.float32)
    x[:L, :5] = rng.randn(L, 5)
    rows = pad_len(L + n_out)
    got = tiled_bucket_apply(
        jnp.asarray(w), jnp.asarray(x), jnp.asarray(in_off),
        jnp.asarray(out_off), out_rows=rows, trans=trans, interpret=True,
    )
    want = _loop_reference(w, x, in_off, out_off, np.zeros((rows, 16)), trans)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_kernel_rejects_unaligned_buffers():
    w = jnp.zeros((2, 16, 16), jnp.float32)
    off = jnp.zeros((2,), jnp.int32)
    with pytest.raises(ValueError, match="unaligned"):
        tiled_bucket_apply(w, jnp.zeros((100, 16)), off, off, out_rows=100,
                           interpret=True)
    with pytest.raises(ValueError, match="unaligned"):
        tiled_bucket_apply(w, jnp.zeros((100, 8)), off, off, out_rows=128,
                           interpret=True)


def test_product_route_rule():
    big = KERNEL_MIN_BYTES
    assert product_route(jnp.float32, 8, big, "gpu") == "triton"
    assert product_route(jnp.float32, 2, big, "gpu") == "triton"
    assert product_route(jnp.float32, 64, big, "gpu") == "triton"
    # one right-hand side, very many, a small operator, another dtype or
    # platform: XLA
    assert product_route(jnp.float32, 1, big, "gpu") == "xla"
    assert product_route(jnp.float32, 65, big, "gpu") == "xla"
    assert product_route(jnp.float32, 8, big - 1, "gpu") == "xla"
    for dtype in (jnp.float64, jnp.complex64, jnp.complex128):
        assert product_route(dtype, 8, big, "gpu") == "xla"
    assert product_route(jnp.float32, 8, big, "cpu") == "xla"


def test_nbytes_counts_padded_buckets():
    pts = create_sphere(500).astype(np.float32)
    gen = ht.KernelGenerator(laplace_kernel_symmetric, pts, pts)
    H = ht.build_hmatrix(gen, ht.build_cluster_tree(pts, max_leaf_size=40),
                         epsilon=1e-4, eta=10.0)
    want = sum(b.data.size for b in H.dense_buckets)
    want += sum(b.U.size + b.V.size for b in H.lr_buckets)
    assert H.nbytes == 4 * want


@pytest.mark.parametrize("symmetry", ["N", "S"])
@pytest.mark.parametrize("op", ["N", "T"])
def test_matvec_kernel_route_matches_xla(symmetry, op):
    n = 700
    pts = create_sphere(n).astype(np.float32)
    gen = ht.KernelGenerator(laplace_kernel_symmetric, pts, pts)
    tree = ht.build_cluster_tree(pts, max_leaf_size=40)
    H = ht.build_hmatrix(gen, tree, epsilon=1e-4, eta=10.0, symmetry=symmetry,
                         UPLO="L" if symmetry == "S" else "N")
    assert H.lr_buckets and H.dense_buckets
    for k in (1, 3):
        x = np.random.RandomState(k).randn(n, k).astype(np.float32)
        x = jnp.asarray(x[:, 0] if k == 1 else x)
        want = np.asarray(_matvec(H, x, op=op, route="xla"))
        got = np.asarray(_matvec(H, x, op=op, route="interpret"))
        assert got.shape == want.shape
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-6
