"""htool_tpu — a hierarchical-matrix + DDM-solver framework in JAX.

JAX/XLA framework with the capabilities of Htool-DDM
(https://github.com/htool-ddm/htool): geometric cluster trees, H-matrix
compression (batched partial ACA / SVD), H-arithmetic, a row-partitioned
distributed operator over a ``jax.sharding.Mesh``, and CG/GMRES Krylov
solvers with one- and two-level (GenEO) domain-decomposition
preconditioners.

Design: trees and block plans are built on host in NumPy; the device sees
only flat, static, padded bucket arrays driven by batched einsums.  See
SURVEY.md §7 for the blueprint.
"""

import os as _os

import jax as _jax

# A float32 matmul on Hopper GPUs may run in TF32 (~3 decimal digits) unless
# a precision is requested, which breaks the library's accuracy contract
# (compression error < epsilon, reference test_hmatrix_build.hpp:191).
# Full f32 products are the contract; chip_smoke.py's precision phase checks
# it on the card.  Opt out with HTOOL_TPU_DEFAULT_PRECISION=default.
_prec = _os.environ.get("HTOOL_TPU_DEFAULT_PRECISION", "highest")
if _prec != "default":
    _jax.config.update("jax_default_matmul_precision", _prec)

from .clustering.cluster_tree import ClusterTree, ClusterTreeBuilder, build_cluster_tree
from .generator import Generator, KernelGenerator, MatrixGenerator
from .hmatrix.aca import batched_partial_aca
from .hmatrix.assembly import (
    HMatrixBuilder,
    assemble_from_plan,
    build_hmatrix,
    hmatrix_from_dense,
)
from .hmatrix.block_tree import BlockTreePlan, plan_block_tree
from .hmatrix.hmatrix import DenseBucket, HMatrix, LowRankBucket
from .hmatrix.info import hmatrix_info, print_hmatrix_information
from .hmatrix.linalg import matmat, matmat_user, matvec, matvec_user, to_dense
from .hmatrix.blr2 import (
    TwoLevelBLR,
    blr2_cholesky,
    blr2_lu,
    blr2_matvec,
    blr2_solve,
    blr2_triangular_solve,
    build_blr2,
)
from .hmatrix.conversion import (
    blr_to_hmatrix,
    cholesky_factorization,
    cholesky_solve,
    common_grid_blr,
    hmatrix_hmatrix_product,
    lu_factorization,
    lu_solve,
    permute_blr,
    recompress_hmatrix,
    retile_blr,
    to_blr,
    to_blr2,
)
from .hmatrix.output import load_hmatrix, save_hmatrix

__version__ = "0.1.0"

__all__ = [
    "ClusterTree",
    "ClusterTreeBuilder",
    "build_cluster_tree",
    "Generator",
    "KernelGenerator",
    "MatrixGenerator",
    "BlockTreePlan",
    "plan_block_tree",
    "HMatrix",
    "DenseBucket",
    "LowRankBucket",
    "HMatrixBuilder",
    "build_hmatrix",
    "assemble_from_plan",
    "hmatrix_from_dense",
    "batched_partial_aca",
    "matvec",
    "matvec_user",
    "matmat",
    "matmat_user",
    "to_dense",
    "hmatrix_info",
    "print_hmatrix_information",
    "recompress_hmatrix",
    "to_blr",
    "blr_to_hmatrix",
    "to_blr2",
    "TwoLevelBLR",
    "build_blr2",
    "blr2_lu",
    "blr2_cholesky",
    "blr2_solve",
    "blr2_triangular_solve",
    "blr2_matvec",
    "lu_factorization",
    "lu_solve",
    "cholesky_factorization",
    "cholesky_solve",
    "hmatrix_hmatrix_product",
    "retile_blr",
    "permute_blr",
    "common_grid_blr",
    "save_hmatrix",
    "load_hmatrix",
]
