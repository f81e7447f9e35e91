"""Persistence tests: cluster-tree CSV round trip (cluster_output.hpp
save/read), H-matrix structure dump, H-matrix npz round trip."""

import numpy as np

import htool_tpu as ht
from htool_tpu.clustering.io import (
    read_cluster_tree,
    save_cluster_tree,
    save_clustered_geometry,
)
from htool_tpu.hmatrix.output import load_hmatrix, save_hmatrix, save_leaves_with_rank
from htool_tpu.testing import create_sphere, laplace_kernel_symmetric


def test_cluster_tree_roundtrip(tmp_path):
    pts = create_sphere(400)
    tree = ht.build_cluster_tree(pts, max_leaf_size=30, n_partitions=4)
    prefix = str(tmp_path / "ct")
    save_cluster_tree(tree, prefix)
    tree2 = read_cluster_tree(prefix, pts)
    assert np.array_equal(tree.permutation, tree2.permutation)
    assert np.array_equal(tree.offsets, tree2.offsets)
    assert np.array_equal(tree.sizes, tree2.sizes)
    assert np.array_equal(tree.ranks, tree2.ranks)
    assert np.array_equal(tree.children, tree2.children)
    assert np.allclose(tree.centers, tree2.centers)
    assert tree2.n_partitions == 4
    # reloaded tree must drive the full pipeline identically
    gen = ht.KernelGenerator(laplace_kernel_symmetric, pts, pts)
    H1 = ht.build_hmatrix(gen, tree, epsilon=1e-4)
    H2 = ht.build_hmatrix(gen, tree2, epsilon=1e-4)
    assert np.allclose(H1.to_dense(), H2.to_dense())


def test_clustered_geometry_dump(tmp_path):
    pts = create_sphere(200)
    tree = ht.build_cluster_tree(pts, max_leaf_size=20)
    path = str(tmp_path / "geom.csv")
    save_clustered_geometry(tree, 2, path)
    data = np.genfromtxt(path, delimiter=",", names=True)
    assert data.shape[0] == 200
    assert len(set(data["cluster"])) >= 2


def test_leaves_csv(tmp_path):
    pts = create_sphere(400)
    tree = ht.build_cluster_tree(pts, max_leaf_size=30)
    gen = ht.KernelGenerator(laplace_kernel_symmetric, pts, pts)
    H = ht.build_hmatrix(gen, tree, epsilon=1e-4)
    path = str(tmp_path / "leaves.csv")
    save_leaves_with_rank(H, path)
    import csv

    with open(path) as f:
        rows = list(csv.DictReader(f))
    info = ht.hmatrix_info(H)
    assert len(rows) == info["n_dense_blocks"] + info["n_low_rank_blocks"]
    # leaves tile the full matrix (non-symmetric storage covers everything)
    area = sum(int(r["t_size"]) * int(r["s_size"]) for r in rows)
    assert area == 400 * 400


def test_hmatrix_npz_roundtrip(tmp_path):
    pts = create_sphere(300)
    tree = ht.build_cluster_tree(pts, max_leaf_size=30)
    gen = ht.KernelGenerator(laplace_kernel_symmetric, pts, pts)
    H = ht.build_hmatrix(gen, tree, epsilon=1e-5, symmetry="S", UPLO="L")
    path = str(tmp_path / "h.npz")
    save_hmatrix(H, path)
    H2 = load_hmatrix(path)
    assert np.allclose(H.to_dense(), H2.to_dense())
    x = np.random.RandomState(0).randn(300)
    assert np.allclose(np.asarray(H @ x), np.asarray(H2 @ x))


def test_save_levels_and_dot(tmp_path):
    import htool_tpu as ht
    from htool_tpu.hmatrix.output import save_levels, view_block_tree
    from htool_tpu.testing import create_sphere, laplace_kernel_symmetric

    pts = create_sphere(500)
    gen = ht.KernelGenerator(laplace_kernel_symmetric, pts, pts)
    tree = ht.build_cluster_tree(pts, max_leaf_size=40)
    H = ht.build_hmatrix(gen, tree, epsilon=1e-4, eta=10.0)
    p = tmp_path / "levels.csv"
    save_levels(H, str(p))
    lines = p.read_text().strip().splitlines()
    assert lines[0].startswith("block_extent") and len(lines) > 1
    dot = view_block_tree(H, str(tmp_path / "bt.dot"))
    assert dot.startswith("digraph") and "palegreen" in dot and "lightcoral" in dot


def test_save_load_matvec_equal(tmp_path):
    """A reloaded operator gives the same product, bit for bit, in both
    orientations: every bucket array survives the npz round trip."""
    from htool_tpu.hmatrix.linalg import matvec

    pts = create_sphere(600)
    gen = ht.KernelGenerator(laplace_kernel_symmetric, pts, pts)
    tree = ht.build_cluster_tree(pts, max_leaf_size=40)
    H = ht.build_hmatrix(gen, tree, epsilon=1e-6, eta=10.0)
    path = str(tmp_path / "h.npz")
    save_hmatrix(H, path)
    H2 = load_hmatrix(path)
    assert [b.block_shape for b in H2.dense_buckets + H2.lr_buckets] == [
        b.block_shape for b in H.dense_buckets + H.lr_buckets
    ]
    x = np.random.RandomState(0).randn(600, 2)
    for op in ("N", "T"):
        assert np.array_equal(np.asarray(matvec(H, x, op=op)),
                              np.asarray(matvec(H2, x, op=op))), op
