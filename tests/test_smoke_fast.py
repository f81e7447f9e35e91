"""Fast default-tier smokes for the subsystems whose full grids are marked
slow (distributed operator, sharded DDM, hierarchical factorization).  One minimal end-to-end case each, so `pytest -m "not slow"` still
exercises every layer — the reference's quick tier is `ctest -LE mpi`
(tests/functional_tests/CMakeLists.txt)."""

import numpy as np
import pytest

import htool_tpu as ht
from htool_tpu.testing import create_sphere, grid_laplacian, laplace_kernel_symmetric


def test_distributed_matvec_smoke():
    import jax
    from jax.sharding import Mesh

    from htool_tpu.parallel import build_distributed_hmatrix

    n, P = 600, 2
    pts = create_sphere(n)
    gen = ht.KernelGenerator(laplace_kernel_symmetric, pts, pts)
    tree = ht.build_cluster_tree(pts, max_leaf_size=40, n_partitions=P)
    mesh = Mesh(np.array(jax.devices("cpu")[:P]), ("p",))
    D = build_distributed_hmatrix(gen, tree, mesh, epsilon=1e-6, eta=10.0)
    A = np.asarray(gen.to_dense())
    x = np.random.RandomState(0).randn(n)
    y = np.asarray(D.matvec(x))
    assert np.linalg.norm(y - A @ x) / np.linalg.norm(A @ x) < 1e-5


def test_dist_ddm_smoke():
    import jax
    from jax.sharding import Mesh

    from htool_tpu.parallel import build_distributed_hmatrix
    from htool_tpu.solvers.dist_ddm import DistributedDDMSolver

    pts, A = grid_laplacian((6, 6, 4))
    P = 2
    tree = ht.build_cluster_tree(pts, max_leaf_size=24, n_partitions=P)
    gen = ht.MatrixGenerator(A)
    mesh = Mesh(np.array(jax.devices("cpu")[:P]), ("p",))
    D = build_distributed_hmatrix(gen, tree, mesh, epsilon=1e-8, eta=10.0)
    s = DistributedDDMSolver(D, gen, tree, schwarz="ras", overlap_radius=1.5)
    b = np.random.RandomState(0).randn(A.shape[0])
    x, infos = s.solve(b, tol=1e-8, krylov="cg")
    res = np.linalg.norm(A @ np.asarray(x) - b) / np.linalg.norm(b)
    assert res < 1e-6, (res, infos)


def test_blr2_smoke():
    from htool_tpu.hmatrix.blr2 import blr2_lu, blr2_solve, build_blr2

    n = 500
    pts = create_sphere(n)
    tree = ht.build_cluster_tree(pts, max_leaf_size=32)
    gen = ht.KernelGenerator(laplace_kernel_symmetric, pts, pts)
    A = build_blr2(gen, tree, epsilon=1e-8, coarse_size=128, diag_mode="dense")
    F = blr2_lu(A, error_estimate=False)
    Ad = np.asarray(gen.to_dense())
    x = np.random.RandomState(0).randn(n)
    xs = np.asarray(blr2_solve(F, Ad @ x, user_numbering=True))
    assert np.linalg.norm(xs - x) / np.linalg.norm(x) < 1e-6


def test_distributed_matvec_trans_complex_smoke():
    """Distributed 'T'/'C' products and a complex kernel in the default tier
    (full grids: test_distributed.py, slow)."""
    import jax
    from jax.sharding import Mesh

    from htool_tpu.parallel import build_distributed_hmatrix
    from htool_tpu.testing import laplace_kernel_complex_symmetric

    n, P = 500, 2
    pts = create_sphere(n)
    gen = ht.KernelGenerator(laplace_kernel_complex_symmetric, pts, pts)
    tree = ht.build_cluster_tree(pts, max_leaf_size=40, n_partitions=P)
    mesh = Mesh(np.array(jax.devices("cpu")[:P]), ("p",))
    D = build_distributed_hmatrix(gen, tree, mesh, epsilon=1e-6, eta=10.0)
    A = np.asarray(gen.to_dense())
    rng = np.random.RandomState(0)
    x = rng.randn(n, 2) + 1j * rng.randn(n, 2)
    for op, Aop in (("T", A.T), ("C", np.conj(A.T))):
        y = np.asarray(D.matvec(x, op=op))
        ref = Aop @ x
        assert np.linalg.norm(y - ref) / np.linalg.norm(ref) < 1e-5, op


def test_triangular_trans_smoke():
    """One L/U x N/T/C triangular-solve case in the default tier (full grid:
    test_triangular.py, slow).  Oracle = dense triangle solve."""
    from scipy.linalg import solve_triangular

    from htool_tpu.hmatrix.blr import blr_triangular_solve, build_blr

    n = 400
    pts = create_sphere(n)
    gen = ht.KernelGenerator(laplace_kernel_symmetric, pts, pts)
    tree = ht.build_cluster_tree(pts, max_leaf_size=32)
    A = build_blr(gen, tree, epsilon=1e-9, eta=10.0, block_size=64)
    Pm = tree.permutation
    Ad = np.asarray(gen.to_dense())[np.ix_(Pm, Pm)]
    rng = np.random.RandomState(0)
    B = rng.randn(n, 3)
    for which, tri in (("L", np.tril(Ad)), ("U", np.triu(Ad))):
        for trans in ("N", "T"):
            X = np.asarray(blr_triangular_solve(A, B, which=which, trans=trans))
            op = tri.T if trans == "T" else tri
            ref = solve_triangular(op, B, lower=(which == "L") ^ (trans == "T"))
            assert (
                np.linalg.norm(X - ref) / np.linalg.norm(ref) < 1e-5
            ), (which, trans)


def test_blr2_solve_trans_smoke():
    """trans='T' on the two-level factorization in the default tier."""
    from htool_tpu.hmatrix.blr2 import blr2_lu, blr2_solve, build_blr2

    n = 500
    pts = create_sphere(n)
    tree = ht.build_cluster_tree(pts, max_leaf_size=32)
    gen = ht.KernelGenerator(laplace_kernel_symmetric, pts, pts)
    A = build_blr2(gen, tree, epsilon=1e-8, coarse_size=128, diag_mode="dense")
    F = blr2_lu(A, error_estimate=False)
    Ad = np.asarray(gen.to_dense())
    x = np.random.RandomState(0).randn(n)
    xs = np.asarray(blr2_solve(F, Ad.T @ x, user_numbering=True, trans="T"))
    assert np.linalg.norm(xs - x) / np.linalg.norm(x) < 1e-6


def test_dist_ddm_gmres_blr_smoke():
    """Sharded RAS + GMRES with the compressed (BLR) local solver — the
    flagship solve path — in the default tier."""
    import jax
    from jax.sharding import Mesh

    from htool_tpu.parallel import build_distributed_hmatrix
    from htool_tpu.solvers.dist_ddm import DistributedDDMSolver

    pts, A = grid_laplacian((6, 6, 4))
    P = 2
    tree = ht.build_cluster_tree(pts, max_leaf_size=24, n_partitions=P)
    gen = ht.MatrixGenerator(A)
    mesh = Mesh(np.array(jax.devices("cpu")[:P]), ("p",))
    D = build_distributed_hmatrix(gen, tree, mesh, epsilon=1e-8, eta=10.0)
    s = DistributedDDMSolver(
        D, gen, tree, schwarz="ras", overlap_radius=1.5, local_solver="blr"
    )
    b = np.random.RandomState(0).randn(A.shape[0])
    x, infos = s.solve(b, tol=1e-8, krylov="gmres", restart=40)
    res = np.linalg.norm(A @ np.asarray(x) - b) / np.linalg.norm(b)
    assert res < 1e-6, (res, infos)


def test_blr2_nested_smoke():
    """Nested (>= 3-level) factorization in the default tier: TwoLevelBLR
    diagonal panels inside a TwoLevelBLR (the reference's full-depth
    recursion asymptotics, factorization.hpp:19-79)."""
    from htool_tpu.hmatrix.blr2 import TwoLevelBLR, blr2_lu, blr2_solve, build_blr2
    from htool_tpu.testing import create_sphere, laplace_kernel_symmetric

    n = 700
    pts = create_sphere(n)
    tree = ht.build_cluster_tree(pts, max_leaf_size=16)
    gen = ht.KernelGenerator(laplace_kernel_symmetric, pts, pts)
    A = build_blr2(gen, tree, epsilon=1e-8, coarse_size=256,
                   diag_mode="nested", mid_size=64)
    assert A.info["n_levels"] == 3 and isinstance(A.diag[0], TwoLevelBLR)
    F = blr2_lu(A, error_estimate=False)
    Ad = np.asarray(gen.to_dense())
    x = np.random.RandomState(0).randn(n)
    xs = np.asarray(blr2_solve(F, Ad @ x, user_numbering=True))
    assert np.linalg.norm(xs - x) / np.linalg.norm(x) < 1e-6
