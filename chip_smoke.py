"""Run the H-matrix + DDM main path once on the GPU and check every result.

Usage::

    python chip_smoke.py               # one card: six phases, below
    python chip_smoke.py --four-cards  # four cards: the distributed path only

Everything runs in this one process, through the public API, in float32
under the package's "highest" matmul precision.  Each phase compares its
result with a plain reference and prints one line: the phase, its sizes,
each error beside its tolerance, and its wall time (compile included).

One card (the shapes of the ``bench.py`` rows):

1. ``matvec``     n=100000, 8 right-hand sides; 256 exact rows in float64
                  on the host; rel error < epsilon = 1e-3.  At this size
                  the product runs the Triton kernel (hmatrix/
                  tiled_product.py); it must match the XLA route to 1e-5.
2. ``precision``  n=10000; the device product against the same compressed
                  blocks multiplied on the host in float64; rel diff < 1e-5.
                  A float32 product run in TF32 shows ~1e-4..1e-3 here.
3. ``complex``    complex64 matvec at n=10000, data moved with plain
                  ``jnp.asarray`` / ``np.asarray``; 256-row oracle < 1e-3.
4. ``blr2_lu``    two-level LU at n=10000, epsilon=1e-4: backward-error
                  estimate < 1e-5 and the solve recovers x_true to < 1e-3.
5. ``ddm``        one-level RAS + GMRES(60) to 1e-6 at n=100000, P=64:
                  residual ||b - H x|| / ||b|| < 1e-5.
6. ``geneo``      two-level GenEO (nu=2, local store, additive) at
                  n=20000, P=8: residual < 1e-5; batched ``eigh`` on the card.

Four cards (``--four-cards``): the row-partitioned operator at n=100000 on a
4-device 1-D mesh, its 'N' and 'T' products against the single-device
product of an H-matrix built from the same tree (rel diff < 1e-5), and
``DistributedDDMSolver`` (RAS + GMRES to 1e-6, residual < 1e-5) with its
factors sharded over all four devices.

The script refuses any platform but ``gpu`` and exits nonzero if a phase
fails.  Its last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import htool_tpu as ht  # noqa: E402
from htool_tpu.utils.device import device_summary, gpu_name_and_power  # noqa: E402

DTYPE = np.float32


# ---------------------------------------------------------------------------
# device description and the contract line
# ---------------------------------------------------------------------------


def require_gpu(summary: dict, min_count: int = 1) -> None:
    if summary["platform"] != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX found platform {summary['platform']!r}"
        )
    if summary["count"] < min_count:
        raise SystemExit(
            f"chip_smoke: needs {min_count} GPUs, JAX found {summary['count']}"
        )


def contract_line(summary: dict) -> str:
    return json.dumps({"ok": True, "device": summary})


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def _rel(a, b) -> float:
    a = np.asarray(a)
    b = np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _laplace_problem(n, kernel=None, dtype=None, max_leaf_size=256,
                     n_partitions=None):
    from htool_tpu.testing import create_sphere, laplace_kernel_symmetric

    pts = create_sphere(n).astype(DTYPE)
    gen = ht.KernelGenerator(kernel or laplace_kernel_symmetric, pts, pts,
                             dtype=dtype)
    kw = {} if n_partitions is None else {"n_partitions": n_partitions}
    tree = ht.build_cluster_tree(pts, max_leaf_size=max_leaf_size, **kw)
    return gen, tree


def _oracle_rows_error(gen, y_user, x, n_rows, rng) -> float:
    """Rel error of ``y_user`` on ``n_rows`` random rows against exact rows
    of the generator, multiplied on the host in 128-bit complex / float64."""
    import jax.numpy as jnp

    n = gen.shape[1]
    sub = np.sort(rng.choice(gen.shape[0], min(n_rows, gen.shape[0]),
                             replace=False))
    A_rows = np.asarray(
        gen.block(jnp.asarray(sub, jnp.int32), jnp.arange(n, dtype=jnp.int32))
    )
    wide = np.complex128 if np.iscomplexobj(A_rows) else np.float64
    y_ref = A_rows.astype(wide) @ np.asarray(x).astype(wide)
    return _rel(np.asarray(y_user)[sub], y_ref)


def _residual(H, x, b) -> float:
    return _rel(np.asarray(H @ np.asarray(x)), b)


# ---------------------------------------------------------------------------
# phases: each returns {"sizes": {...}, "checks": [(name, value, tol)], ...}
# ---------------------------------------------------------------------------


def phase_matvec(n=100_000, nrhs=8, epsilon=1e-3, max_leaf_size=256,
                 n_oracle=256, seed=0):
    """Real Laplace matvec at the reference's epsilon contract; the route
    the product takes (the Triton kernel on a GPU at this size) against the
    plain XLA route on the same operator."""
    import jax.numpy as jnp

    from htool_tpu.hmatrix.linalg import _matvec, matvec, matvec_user, product_route

    gen, tree = _laplace_problem(n, max_leaf_size=max_leaf_size)
    H = ht.build_hmatrix(gen, tree, epsilon=epsilon, eta=10.0)
    rng = np.random.RandomState(seed)
    x = rng.randn(n, nrhs).astype(DTYPE)
    y = np.asarray(matvec_user(H, x))
    err = _oracle_rows_error(gen, y, x, n_oracle, rng)
    xc = jnp.asarray(x)
    diff = _rel(matvec(H, xc), _matvec(H, xc, op="N", route="xla"))
    info = ht.hmatrix_info(H)
    return {
        "sizes": {"n": n, "nrhs": nrhs, "leaf": max_leaf_size},
        "checks": [("rel_err_vs_exact_rows", err, epsilon),
                   ("rel_diff_vs_xla_route", diff, 1e-5)],
        "route": product_route(H.dtype, nrhs, H.nbytes),
        "compression_ratio": round(float(info["compression_ratio"]), 3),
        "finite": bool(np.all(np.isfinite(y))),
    }


def phase_precision(n=10_000, nrhs=8, epsilon=1e-3, max_leaf_size=256,
                    seed=1):
    """Device product vs the same compressed blocks in float64 on the host:
    isolates the arithmetic of the product from the compression error."""
    gen, tree = _laplace_problem(n, max_leaf_size=max_leaf_size)
    H = ht.build_hmatrix(gen, tree, epsilon=epsilon, eta=10.0)
    x = np.random.RandomState(seed).randn(n, nrhs).astype(DTYPE)
    y = np.asarray(H @ x)
    y_ref = H.to_dense().astype(np.float64) @ x.astype(np.float64)
    return {
        "sizes": {"n": n, "nrhs": nrhs},
        "checks": [("rel_diff_vs_f64_host", _rel(y, y_ref), 1e-5)],
    }


def phase_complex(n=10_000, nrhs=8, epsilon=1e-3, max_leaf_size=256,
                  n_oracle=256, seed=2):
    """complex64 matvec; plain transfers in both directions."""
    import jax.numpy as jnp

    from htool_tpu.hmatrix.linalg import matvec_user
    from htool_tpu.testing import laplace_kernel_complex_symmetric

    gen, tree = _laplace_problem(
        n, kernel=laplace_kernel_complex_symmetric, dtype=jnp.complex64,
        max_leaf_size=max_leaf_size,
    )
    H = ht.build_hmatrix(gen, tree, epsilon=epsilon, eta=10.0)
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, nrhs) + 1j * rng.randn(n, nrhs)).astype(np.complex64)
    x_dev = jnp.asarray(x)
    y = np.asarray(matvec_user(H, x_dev))
    round_trip = bool(np.array_equal(np.asarray(x_dev), x))
    err = _oracle_rows_error(gen, y, x, n_oracle, rng)
    return {
        "sizes": {"n": n, "nrhs": nrhs, "dtype": str(y.dtype)},
        "checks": [("rel_err_vs_exact_rows", err, epsilon),
                   ("transfer_mismatch", 0.0 if round_trip else 1.0, 0.5)],
    }


def phase_blr2_lu(n=10_000, epsilon=1e-4, max_leaf_size=256, seed=3,
                  **build_kw):
    """Two-level LU: backward-error estimate and a solve against the
    compressed operator it factored."""
    from htool_tpu.hmatrix.blr2 import blr2_lu, blr2_matvec, blr2_solve, build_blr2

    gen, tree = _laplace_problem(n, max_leaf_size=max_leaf_size)
    A = build_blr2(gen, tree, epsilon=epsilon, **build_kw)
    x_true = np.random.RandomState(seed).randn(n).astype(DTYPE)
    b = blr2_matvec(A, x_true)
    F = blr2_lu(A, error_estimate=True)
    x = blr2_solve(F, b)
    bw = float(F.info["backward_error_est"])
    return {
        "sizes": {"n": n, "levels": A.info.get("n_levels", 2)},
        "checks": [("backward_error_est", bw, 1e-5),
                   ("solve_rel_err", _rel(x, x_true), 1e-3)],
    }


def phase_ddm(n=100_000, P=64, epsilon=1e-3, max_leaf_size=256,
              overlap_radius=0.02, tol=1e-6, seed=4):
    """Flagship one-level DDM: RAS, dense local solves, GMRES(60)."""
    from htool_tpu.solvers import DDMSolver

    gen, tree = _laplace_problem(n, max_leaf_size=max_leaf_size, n_partitions=P)
    H = ht.build_hmatrix(gen, tree, epsilon=epsilon, eta=10.0)
    solver = DDMSolver(H, gen, tree, schwarz="ras",
                       overlap_radius=overlap_radius, local_solver="dense")
    x_true = np.random.RandomState(seed).randn(n).astype(DTYPE)
    b = np.asarray(H @ x_true)
    x, infos = solver.solve(b, tol=tol, krylov="gmres", restart=60, maxiter=200)
    return {
        "sizes": {"n": n, "P": P},
        "checks": [("residual", _residual(H, x, b), 10 * tol)],
        "iterations": int(infos.get("Nb_it", -1)),
    }


def phase_geneo(n=20_000, P=8, nu=2, epsilon=1e-3, max_leaf_size=256,
                overlap_radius=0.05, tol=1e-6, seed=5):
    """Two-level GenEO DDM with the local (sharded-layout) coarse store."""
    from htool_tpu.hmatrix.linalg import matvec as h_matvec
    from htool_tpu.solvers import DDMSolver, build_geneo_coarse_space
    from htool_tpu.solvers.ddm import build_geometric_overlap

    gen, tree = _laplace_problem(n, max_leaf_size=max_leaf_size, n_partitions=P)
    H = ht.build_hmatrix(gen, tree, epsilon=epsilon, eta=10.0)
    overlap = build_geometric_overlap(tree, overlap_radius)
    infos = {}
    coarse = build_geneo_coarse_space(
        gen, tree, overlap, lambda v: h_matvec(H, v, op="N"), nu=nu,
        symmetry="S", store="local", infos=infos,
    )
    x_true = np.random.RandomState(seed).randn(n).astype(DTYPE)
    b = np.asarray(H @ x_true)
    one = DDMSolver(H, gen, tree, schwarz="ras", overlap=overlap,
                    local_solver="dense")
    _, infos1 = one.solve(b, tol=tol, krylov="gmres", restart=60, maxiter=200)
    two = DDMSolver(H, gen, tree, schwarz="ras", overlap=overlap, coarse=coarse,
                    coarse_correction="additive", local_solver="dense")
    x, infos2 = two.solve(b, tol=tol, krylov="gmres", restart=60, maxiter=200)
    return {
        "sizes": {"n": n, "P": P, "nu": nu},
        "checks": [("residual", _residual(H, x, b), 10 * tol)],
        "coarse_size": int(infos.get("GenEO_coarse_space_size", -1)),
        "iterations_one_level": int(infos1.get("Nb_it", -1)),
        "iterations_two_level": int(infos2.get("Nb_it", -1)),
    }


def phase_four_cards(n=100_000, n_devices=4, epsilon=1e-3, max_leaf_size=256,
                     overlap_radius=0.02, tol=1e-6, seed=6, devices=None):
    """Row-partitioned operator and sharded DDM solve over a 1-D mesh."""
    import jax
    from jax.sharding import Mesh

    from htool_tpu.parallel import build_distributed_hmatrix
    from htool_tpu.solvers import DistributedDDMSolver

    devs = list(jax.devices() if devices is None else devices)[:n_devices]
    mesh = Mesh(np.array(devs), ("p",))
    gen, tree = _laplace_problem(n, max_leaf_size=max_leaf_size,
                                 n_partitions=n_devices)
    D = build_distributed_hmatrix(gen, tree, mesh, epsilon=epsilon, eta=10.0)
    H = ht.build_hmatrix(gen, tree, epsilon=epsilon, eta=10.0)
    rng = np.random.RandomState(seed)
    x = rng.randn(n).astype(DTYPE)
    diff_N = _rel(D.matvec(x, op="N"), H @ x)
    diff_T = _rel(D.matvec(x, op="T"), ht.matvec_user(H, x, op="T"))
    solver = DistributedDDMSolver(D, gen, tree, schwarz="ras",
                                  overlap_radius=overlap_radius)
    sharded_over = len(solver._lu.sharding.device_set)
    b = np.asarray(H @ x)
    xs, infos = solver.solve(b, tol=tol, krylov="gmres", restart=60, maxiter=200)
    return {
        "sizes": {"n": n, "devices": n_devices},
        "checks": [("matvec_N_rel_diff", diff_N, 1e-5),
                   ("matvec_T_rel_diff", diff_T, 1e-5),
                   ("residual", _residual(H, xs, b), 10 * tol),
                   ("unsharded_devices", float(n_devices - sharded_over), 0.5)],
        "iterations": int(infos.get("Nb_it", -1)),
    }


ONE_CARD_PHASES = [
    ("matvec", phase_matvec),
    ("precision", phase_precision),
    ("complex", phase_complex),
    ("blr2_lu", phase_blr2_lu),
    ("ddm", phase_ddm),
    ("geneo", phase_geneo),
]
FOUR_CARD_PHASES = [("four_cards", phase_four_cards)]


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------


def failed_checks(result: dict) -> list:
    return [name for name, value, tol in result["checks"]
            if not (np.isfinite(value) and value < tol)]


def format_phase(name: str, result: dict, wall_s: float) -> str:
    checks = " ".join(f"{c}={v:.3e}(tol {t:g})" for c, v, t in result["checks"])
    extra = {k: v for k, v in result.items() if k not in ("sizes", "checks")}
    bad = failed_checks(result)
    status = "FAIL " + ",".join(bad) if bad else "ok"
    return (f"phase {name}: {status} sizes={json.dumps(result['sizes'])} "
            f"{checks} extra={json.dumps(extra)} "
            f"wall_s={wall_s:.1f} (compile included)")


def run_phases(phases) -> list:
    """Run each phase, print its line; return the names of failed phases."""
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            result = fn()
        except Exception:  # reported, then counted as a failed phase
            traceback.print_exc()
            print(f"phase {name}: ERROR wall_s={time.perf_counter() - t0:.1f}",
                  flush=True)
            failed.append(name)
            continue
        print(format_phase(name, result, time.perf_counter() - t0), flush=True)
        if failed_checks(result):
            failed.append(name)
        gc.collect()
    return failed


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the distributed path on four GPUs")
    args = parser.parse_args(argv)

    import jax

    from htool_tpu.native import native_available
    from htool_tpu.utils.compile_cache import enable_compile_cache

    summary = device_summary(jax.devices())
    print(f"device: platform={summary['platform']} kind={summary['kind']} "
          f"count={summary['count']}", flush=True)
    print(f"nvidia-smi: {gpu_name_and_power()}", flush=True)
    require_gpu(summary, 4 if args.four_cards else 1)
    cache_dir = enable_compile_cache(ROOT)
    print(f"jax {jax.__version__}; compile cache {cache_dir}; planner "
          f"{'native' if native_available() else 'numpy'}; matmul precision "
          f"{jax.config.jax_default_matmul_precision}", flush=True)

    failed = run_phases(FOUR_CARD_PHASES if args.four_cards else ONE_CARD_PHASES)
    if failed:
        print(f"chip_smoke: FAILED phases: {', '.join(failed)}", flush=True)
        return 1
    print(contract_line(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
