"""Worker process for the two-process multi-host test (the mpiexec analog
of the reference's MPI test sweep, tests/functional_tests/solvers/
CMakeLists.txt:27-43).  Each process owns 2 emulated CPU devices; the global
mesh spans 4 devices across 2 processes, so every collective in the package
actually crosses the process boundary.

Usage: python multihost_worker.py <process_id> <num_processes> <port> <out>
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax

jax.config.update("jax_platforms", "cpu")  # the emulated mesh is on the CPU

pid, nproc, port, out_path = (
    int(sys.argv[1]),
    int(sys.argv[2]),
    sys.argv[3],
    sys.argv[4],
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from htool_tpu.parallel.multihost import (  # noqa: E402
    global_mesh,
    initialize_multihost,
    is_multihost,
)

initialize_multihost(f"localhost:{port}", nproc, pid)
assert jax.process_count() == nproc, jax.process_count()
assert is_multihost()

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import htool_tpu as ht  # noqa: E402
from htool_tpu.parallel import build_distributed_hmatrix  # noqa: E402
from htool_tpu.testing import create_sphere, laplace_kernel_symmetric  # noqa: E402

results = {}

n = 800
pts = create_sphere(n)
gen = ht.KernelGenerator(laplace_kernel_symmetric, pts, pts)
mesh = global_mesh()
P = int(mesh.devices.size)
assert P == 2 * nproc, P
tree = ht.build_cluster_tree(pts, max_leaf_size=40, n_partitions=P)
D = build_distributed_hmatrix(gen, tree, mesh, epsilon=1e-6, eta=10.0)

A = np.asarray(gen.to_dense())
rng = np.random.RandomState(0)
x = rng.randn(n)
for op, ref in (("N", A @ x), ("T", A.T @ x)):
    y = D.matvec(x, op=op)
    y = np.asarray(jax.device_get(y))
    results[f"matvec_{op}_err"] = float(
        np.linalg.norm(y - ref) / np.linalg.norm(ref)
    )

# distributed DDM solve across the process boundary
from htool_tpu.solvers.dist_ddm import DistributedDDMSolver  # noqa: E402

s = DistributedDDMSolver(D, gen, tree, schwarz="ras", overlap_radius=0.3)
b = A @ x
xs, infos = s.solve(b, tol=1e-6, krylov="gmres")
xs = np.asarray(jax.device_get(xs))
results["solve_err"] = float(np.linalg.norm(xs - x) / np.linalg.norm(x))
results["iterations"] = int(infos.get("Nb_it", -1))
results["process_count"] = int(jax.process_count())

import json  # noqa: E402

with open(out_path, "w") as f:
    json.dump(results, f)
print("WORKER_OK", pid, results, flush=True)
