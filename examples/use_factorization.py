"""Compressed factorization flow — the reference's ``lu_factorization`` /
``cholesky_factorization`` surface (``hmatrix/linalg/factorization.hpp:82-290``)
on the batched engines:

- flat one-level BLR (single lax.scan over a host-planned static schedule),
- two-level panels, and
- the NESTED (>= 3 level) format whose diagonal panels are TwoLevelBLR
  themselves — the reference's full-depth recursion asymptotics.

Run: python examples/use_factorization.py
"""

import numpy as np

import htool_tpu as ht
from htool_tpu.hmatrix.blr2 import blr2_lu, blr2_solve, build_blr2
from htool_tpu.testing import create_sphere, laplace_kernel_symmetric

n = 3000
pts = create_sphere(n)
gen = ht.KernelGenerator(laplace_kernel_symmetric, pts, pts)
tree = ht.build_cluster_tree(pts, max_leaf_size=64)

# assemble the compressed operator, then factorize THROUGH the assembled
# H-matrix (to_blr re-tiling, no generator re-evaluation)
H = ht.build_hmatrix(gen, tree, epsilon=1e-6, eta=10.0)
F = ht.lu_factorization(H, tree, epsilon=1e-8, method="blr", block_size=128)
rng = np.random.RandomState(0)
x = rng.randn(n)
b = np.asarray(H @ x)
sol = np.asarray(ht.lu_solve(F, b))
print(f"flat BLR LU   : rel err {np.linalg.norm(sol - x) / np.linalg.norm(x):.2e}, "
      f"scan groups {F.info.get('n_scan_groups')}")

# nested three-level factorization straight from the generator
A3 = build_blr2(gen, tree, epsilon=1e-8, coarse_size=1024,
                diag_mode="nested", mid_size=256)
F3 = blr2_lu(A3)
sol3 = np.asarray(blr2_solve(F3, b, user_numbering=True))
print(f"nested (3-lvl): rel err {np.linalg.norm(sol3 - x) / np.linalg.norm(x):.2e}, "
      f"levels {A3.info['n_levels']}, factor bytes {F3.memory_bytes():,}, "
      f"backward error {F3.info['backward_error_est']:.2e}")
