"""Benchmark harness: the H-matrix + DDM cells, measured on one GPU.

Rows (cells), most important first:

- ``matvec_n{10k,100k}``: sphere / Laplace matvec with 8 right-hand sides
  at epsilon = 1e-3 (compressed entries/s, effective GB/s, rel error on 256
  exact rows, which MUST be < epsilon: the reference's acceptance contract,
  test_hmatrix_build.hpp:191).  Each row names the product's route
  (``product_route``); where it is the Triton kernel (the 100k row) the
  row also times the XLA route on the same operator.  The 100k row also
  gives the product's memory bound: the compressed bytes it must read
  divided by the rate of a plain 1 GiB device copy measured in the same
  process;
- ``complex_matvec_n100000``: the same in complex64;
- ``blr2_n{10k,100k}``: two-level LU build + factor + solve, with the
  backward-error estimate;
- ``ddm_n100000``: the flagship DDM workload (use_ddm_solver.cpp:59-136),
  one-level RAS + GMRES to 1e-6, iterations and phase breakdown;
- ``ddm2_n20000``: two-level GenEO DDM, coarse-space phase timings;
- ``weak_scaling_static``: exact host-side accounting of per-device bytes,
  FLOP balance and collective payload for P in {1, 2, 4, 8};
- ``assembly_cold_n10000``: assembly with the persistent compile cache off.

Every row runs in its own child process, one after another: the parent
never imports JAX, so only one process holds the card at a time, and one
failing row cannot poison the rest.  Row errors, timeouts and accuracy
violations are recorded per row and fail the bench with a nonzero exit
after all rows have printed.  Each row names its device: JAX's platform,
device kind and count, and the card's name and power limit.

The bench refuses any platform but ``gpu``.  ``--cpu-rehearsal`` runs the
rows on the CPU to check the control flow; it then prints no timings or
rates, only counts and accuracies.

Output: after every row the cumulative aux JSON goes to stderr and to
``bench_out/bench_aux.json`` (untracked), and a headline JSON line (10k
matvec compressed entries/s) goes to stdout, so a kill mid-run keeps every
finished row.  Rows that would not fit the remaining wall budget
(``BENCH_TOTAL_BUDGET_S``) are skipped and listed as such.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np

# accuracy-contract violations collected across rows; nonzero exit at the end
_VIOLATIONS = []

_ROW_TIMEOUT_S = int(os.environ.get("BENCH_ROW_TIMEOUT", "2700"))
_OUT_DIR = os.path.join(ROOT, "bench_out")

# keys that hold a time or a rate: printed only from a GPU run
_DEVICE_METRIC_SUFFIXES = ("_s", "_per_s", "_tflops", "_gbytes_per_s")


def _device_rates():
    """Rates measured in this process: a plain 1 GiB device copy (read +
    write bytes per second) and a float32 matmul at "highest" precision."""
    import jax
    import jax.numpy as jnp

    def best_of(fn, arg, reps=5):
        fn(arg).block_until_ready()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(arg).block_until_ready()
            best = min(best, time.perf_counter() - t0)
        return best

    a = jnp.ones((256 * 1024 * 1024,), jnp.float32)
    t_copy = best_of(jax.jit(lambda v: v + 1.0), a)
    copy_rate = 2 * a.nbytes / t_copy
    del a
    m = jnp.ones((8192, 8192), jnp.float32)
    mm = jax.jit(lambda v: jnp.matmul(v, v, precision="highest"))
    t_mm = best_of(mm, m)
    return {
        "copy_gbytes_per_s": copy_rate / 1e9,
        "matmul_f32_highest_tflops": 2 * 8192**3 / t_mm / 1e12,
    }, copy_rate


def _product_bytes(H, nrhs):
    """Bytes one product must move: every stored (padded) bucket entry read
    once, x read and y written once."""
    n_out, n_in = H.shape
    return H.nbytes + (n_in + n_out) * nrhs * np.dtype(H.dtype).itemsize


def _bench_matvec(n, nrhs, eps, aux, complex_=False, bound=False):
    """Matvec cell; ``complex_`` switches to the complex64 kernel with plain
    transfers, ``bound`` adds the product's memory bound."""
    import jax
    import jax.numpy as jnp

    import htool_tpu as ht
    from htool_tpu.hmatrix.linalg import _matvec, matvec, matvec_user, product_route
    from htool_tpu.testing import laplace_kernel_complex_symmetric

    pts = create_points(n).astype(np.float32)
    if complex_:
        gen = ht.KernelGenerator(laplace_kernel_complex_symmetric, pts, pts,
                                 dtype=jnp.complex64)
    else:
        gen = ht.KernelGenerator(kernel(), pts, pts)
    tree = ht.build_cluster_tree(pts, max_leaf_size=256)

    t0 = time.perf_counter()
    H = ht.build_hmatrix(gen, tree, epsilon=eps, eta=10.0)
    jax.block_until_ready([b.data for b in H.dense_buckets])
    t_assembly = time.perf_counter() - t0
    info = ht.hmatrix_info(H)

    # warm re-assembly: same shapes, compiled programs cached
    t0 = time.perf_counter()
    H2 = ht.build_hmatrix(gen, tree, epsilon=eps, eta=10.0)
    jax.block_until_ready([b.data for b in H2.dense_buckets])
    t_assembly_warm = time.perf_counter() - t0
    del H2

    rng = np.random.RandomState(0)
    x = rng.randn(n, nrhs)
    if complex_:
        x = x + 1j * rng.randn(n, nrhs)
    xc = jnp.asarray(x.astype(gen.dtype))
    # matvec is jitted with H as a pytree ARGUMENT — never wrap it in a jit
    # that closes over H (bucket data would bake in as HLO constants)
    t0 = time.perf_counter()
    matvec(H, xc).block_until_ready()
    t_first = time.perf_counter() - t0
    iters = 20

    def timed(fn):
        fn().block_until_ready()
        t0 = time.perf_counter()
        for _ in range(iters):
            y = fn()
        y.block_until_ready()
        return (time.perf_counter() - t0) / iters

    t_mv = timed(lambda: matvec(H, xc))
    route = product_route(gen.dtype, nrhs, H.nbytes)

    generated = (float(n) * n) / info["compression_ratio"]
    entries_per_s = generated * nrhs / t_mv
    # error oracle in USER numbering (matvec alone is cluster-numbered)
    yu = np.asarray(matvec_user(H, xc))
    sub = rng.choice(n, 256, replace=False)
    A_rows = np.asarray(
        gen.block(jnp.asarray(sub, jnp.int32), jnp.asarray(np.arange(n), jnp.int32))
    )
    wide = np.complex128 if complex_ else np.float64
    y_ref = A_rows.astype(wide) @ np.asarray(xc).astype(wide)
    rel = np.linalg.norm(yu[sub] - y_ref) / np.linalg.norm(y_ref)

    name = f"{'complex_' if complex_ else ''}matvec_n{n}"
    row = dict(
        n=n,
        nrhs=nrhs,
        epsilon=eps,
        dtype=str(np.dtype(gen.dtype)),
        assembly_s=t_assembly,
        assembly_warm_s=t_assembly_warm,
        block_tree_plan_s=info.get("block_tree_walltime", 0.0),
        matvec_first_call_s=t_first,
        matvec_s=t_mv,
        route=route,
        compression_ratio=info["compression_ratio"],
        rank_mean=info["rank_mean"],
        n_false_positive=info["n_false_positive"],
        matvec_rel_error=float(rel),
        accuracy_ok=bool(rel < eps),
        compressed_entries_per_s=entries_per_s,
        effective_gbytes_per_s=entries_per_s * np.dtype(gen.dtype).itemsize / 1e9,
    )
    if route != "xla":
        # the plain route on the same operator: the kernel must beat it
        row["matvec_xla_route_s"] = timed(
            lambda: _matvec(H, xc, op="N", route="xla"))
    if bound:
        rates, copy_rate = _device_rates()
        nbytes = _product_bytes(H, nrhs)
        row.update(rates)
        row["product_bytes"] = nbytes
        row["product_bound_s"] = nbytes / copy_rate
        row["matvec_over_bound"] = t_mv / row["product_bound_s"]
    aux[name] = row
    if not rel < eps:
        _VIOLATIONS.append(f"{name}: rel_error {rel:.3e} >= eps {eps:g}")


def _bench_blr2(n, eps, aux):
    """Hierarchical (two-level) factorization — the production H-LU path
    (factorization.hpp:19-79 asymptotics)."""
    import jax.numpy as jnp

    import htool_tpu as ht
    from htool_tpu.hmatrix.blr2 import blr2_lu, blr2_solve, build_blr2

    dtype = np.float32
    pts = create_points(n)
    gen = ht.KernelGenerator(kernel(), pts.astype(dtype), pts.astype(dtype))
    tree = ht.build_cluster_tree(pts, max_leaf_size=256)
    t0 = time.perf_counter()
    A = build_blr2(gen, tree, epsilon=eps)
    import jax

    jax.block_until_ready(A.pU)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    F = blr2_lu(A, error_estimate=True)
    jax.block_until_ready(F.pU)
    t_lu = time.perf_counter() - t0
    b = jnp.asarray(np.random.RandomState(1).randn(n, 8).astype(dtype))
    x = blr2_solve(F, b)
    x.block_until_ready()
    t0 = time.perf_counter()
    for _ in range(10):
        x = blr2_solve(F, b)
    x.block_until_ready()
    t_solve = (time.perf_counter() - t0) / 10
    aux[f"blr2_n{n}"] = dict(
        n=n,
        epsilon=eps,
        build_s=t_build,
        build_aca_s=A.info.get("offdiag_aca_walltime"),
        build_diag_s=A.info.get("diag_build_walltime"),
        lu_s=t_lu,
        solve_s=t_solve,
        backward_error_est=F.info.get("backward_error_est"),
        n_rank_capped=F.info.get("n_rank_capped_pairs"),
        diag_mode=A.diag_mode,
        n_levels=A.info.get("n_levels", 2),
        factor_bytes=F.memory_bytes(),
    )
    bw = F.info.get("backward_error_est")
    if bw is not None and not bw < 100 * eps:
        _VIOLATIONS.append(f"blr2_n{n}: backward_error {bw:.3e} >= 100*eps")


def _bench_ddm(n, aux):
    """Flagship workload (use_ddm_solver.cpp:59-136 at BASELINE's 100k
    scale): sphere, H-matrix operator, one-level RAS + GMRES to 1e-6."""
    import jax
    import jax.numpy as jnp

    import htool_tpu as ht
    from htool_tpu.solvers import DDMSolver

    dtype = np.float32
    eps = 1e-3
    # 64 subdomains of ~1.6k points: the dense local factors
    # ([P, n_ext, n_ext]) live inside the jitted Krylov loop, and the
    # subdomain count is the granularity knob (utility.hpp:56)
    P = 64
    tol = 1e-6
    pts = create_points(n)
    gen = ht.KernelGenerator(kernel(), pts.astype(dtype), pts.astype(dtype))
    tree = ht.build_cluster_tree(pts, max_leaf_size=256, n_partitions=P)
    t0 = time.perf_counter()
    H = ht.build_hmatrix(gen, tree, epsilon=eps, eta=10.0)
    jax.block_until_ready([b.data for b in H.dense_buckets])
    t_assembly = time.perf_counter() - t0

    t0 = time.perf_counter()
    solver = DDMSolver(
        H, gen, tree, schwarz="ras", overlap_radius=0.02, local_solver="dense"
    )
    t_facto = time.perf_counter() - t0

    rng = np.random.RandomState(0)
    x_true = rng.randn(n).astype(dtype)
    # rhs via the compressed operator keeps the oracle consistent at f32
    b = np.asarray(H @ jnp.asarray(x_true))
    t0 = time.perf_counter()
    x, infos = solver.solve(b, tol=tol, krylov="gmres", restart=60, maxiter=200)
    t_solve = time.perf_counter() - t0
    # warm re-solve: same shapes, program cached -> true time-to-tol
    t0 = time.perf_counter()
    x, infos = solver.solve(b, tol=tol, krylov="gmres", restart=60, maxiter=200)
    t_solve_warm = time.perf_counter() - t0
    res = float(
        np.linalg.norm(np.asarray(H @ jnp.asarray(np.asarray(x))) - b)
        / np.linalg.norm(b)
    )
    aux[f"ddm_n{n}"] = dict(
        n=n,
        subdomains=P,
        epsilon=eps,
        tol=tol,
        assembly_s=t_assembly,
        facto_one_level_s=t_facto,
        solve_s=t_solve,
        solve_warm_s=t_solve_warm,
        iterations=infos.get("Nb_it"),
        residual=res,
        converged=bool(res < 10 * tol),
    )
    if not res < 10 * tol:
        _VIOLATIONS.append(f"ddm_n{n}: residual {res:.3e} >= 10*tol")


def _bench_ddm_two_level(n, aux):
    """Two-level GenEO DDM (BASELINE's two-level target at a one-card
    scale): sphere, RAS + GenEO(additive) + GMRES,
    sharded coarse store (no [N, nc] basis).  Reports the reference's
    GenEO phase timings (ddm.hpp:80-122)."""
    import jax
    import jax.numpy as jnp

    import htool_tpu as ht
    from htool_tpu.hmatrix.linalg import matvec as h_matvec
    from htool_tpu.solvers import DDMSolver
    from htool_tpu.solvers.ddm import build_geometric_overlap
    from htool_tpu.solvers.geneo import build_geneo_coarse_space

    dtype = np.float32
    eps = 1e-3
    P = 8
    tol = 1e-6
    pts = create_points(n)
    gen = ht.KernelGenerator(kernel(), pts.astype(dtype), pts.astype(dtype))
    tree = ht.build_cluster_tree(pts, max_leaf_size=256, n_partitions=P)
    t0 = time.perf_counter()
    H = ht.build_hmatrix(gen, tree, epsilon=eps, eta=10.0)
    jax.block_until_ready([b.data for b in H.dense_buckets])
    t_assembly = time.perf_counter() - t0

    overlap = build_geometric_overlap(tree, 0.05)
    infos = {}
    A_apply = lambda x: h_matvec(H, x, op="N")
    t0 = time.perf_counter()
    coarse = build_geneo_coarse_space(
        gen, tree, overlap, A_apply, nu=2, symmetry="S", store="local",
        infos=infos,
    )
    t_coarse = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver = DDMSolver(
        H, gen, tree, schwarz="ras", overlap=overlap, coarse=coarse,
        coarse_correction="additive", local_solver="dense",
    )
    t_facto = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    x_true = rng.randn(n).astype(dtype)
    b = np.asarray(H @ jnp.asarray(x_true))
    # one-level comparison run for the iteration-reduction evidence
    solver1 = DDMSolver(
        H, gen, tree, schwarz="ras", overlap=overlap, local_solver="dense"
    )
    _, infos1 = solver1.solve(b, tol=tol, krylov="gmres", restart=60, maxiter=200)
    t0 = time.perf_counter()
    x, infos2 = solver.solve(b, tol=tol, krylov="gmres", restart=60, maxiter=200)
    t_solve = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, infos2 = solver.solve(b, tol=tol, krylov="gmres", restart=60, maxiter=200)
    t_solve_warm = time.perf_counter() - t0
    res = float(
        np.linalg.norm(np.asarray(H @ jnp.asarray(np.asarray(x))) - b)
        / np.linalg.norm(b)
    )
    aux[f"ddm2_n{n}"] = dict(
        n=n,
        subdomains=P,
        tol=tol,
        assembly_s=t_assembly,
        coarse_space_s=t_coarse,
        geneo_evp_s=infos.get("GenEO_geev_walltime"),
        geneo_ztaz_s=infos.get("GenEO_ZtAZ_walltime"),
        coarse_size=infos.get("GenEO_coarse_space_size"),
        facto_one_level_s=t_facto,
        solve_s=t_solve,
        solve_warm_s=t_solve_warm,
        iterations_one_level=infos1.get("Nb_it"),
        iterations_two_level=infos2.get("Nb_it"),
        residual=res,
        converged=bool(res < 10 * tol),
    )
    if not res < 10 * tol:
        _VIOLATIONS.append(f"ddm2_n{n}: residual {res:.3e} >= 10*tol")


def _bench_weak_scaling_static(n, aux):
    """Exact host-side weak-scaling accounting: from one built H-matrix +
    the partition plan, report per-device compressed bytes and matvec FLOP
    balance, and the collective payload bytes per matvec for P in
    {1,2,4,8} — what crosses the interconnect in the local-to-local product
    (all_gather of x 'N' / psum_scatter of y 'T').  Counts only: no time."""
    import htool_tpu as ht

    dtype = np.float32
    itemsize = np.dtype(dtype).itemsize
    eps = 1e-3
    pts = create_points(n)
    gen = ht.KernelGenerator(kernel(), pts.astype(dtype), pts.astype(dtype))
    rows = {}
    for P in (1, 2, 4, 8):
        tree = ht.build_cluster_tree(pts, max_leaf_size=256, n_partitions=P)
        H = ht.build_hmatrix(gen, tree, epsilon=eps, eta=10.0)
        offs, szs = tree.partition_offsets_sizes()
        bounds = np.asarray(offs, np.int64)
        ends = bounds + np.asarray(szs, np.int64)
        per_dev_entries = np.zeros(P, np.int64)
        for b in H.dense_buckets:
            t_off = np.asarray(b.t_off)
            own = np.searchsorted(ends, t_off, side="right")
            sz = int(b.data.shape[1]) * int(b.data.shape[2])
            np.add.at(per_dev_entries, own, sz)
        for b in H.lr_buckets:
            t_off = np.asarray(b.t_off)
            own = np.searchsorted(ends, t_off, side="right")
            bm, bn = b.block_shape
            sz = int(b.rank_padded) * (bm + bn)
            np.add.at(per_dev_entries, own, sz)
        flops = per_dev_entries * 2  # one mul+add per stored entry per rhs col
        comm_N = (n - n // P) * itemsize  # all_gather recv bytes per device
        comm_T = n * itemsize  # psum_scatter reduce bytes per device
        total = float(per_dev_entries.sum())
        rows[str(P)] = dict(
            per_device_entries_max=int(per_dev_entries.max()),
            per_device_entries_mean=total / P,
            balance=float(per_dev_entries.max() / (total / P)),
            flops_per_device_mean=float(flops.mean()),
            collective_bytes_N=int(comm_N),
            collective_bytes_T=int(comm_T),
            comm_to_compute_bytes=float(comm_N / (per_dev_entries.mean() * itemsize)),
        )
        del H
    aux["weak_scaling_static"] = dict(n=n, per_P=rows)


def _bench_blr(n, eps, aux):
    import jax.numpy as jnp

    import htool_tpu as ht
    from htool_tpu.hmatrix.blr import blr_lu, blr_solve, build_blr

    dtype = np.float32
    pts = create_points(n)
    gen = ht.KernelGenerator(kernel(), pts.astype(dtype), pts.astype(dtype))
    tree = ht.build_cluster_tree(pts, max_leaf_size=256)
    t0 = time.perf_counter()
    A = build_blr(gen, tree, epsilon=eps, eta=10.0, block_size=512)
    A.D.block_until_ready()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    F = blr_lu(A, error_estimate=True)
    F.D.block_until_ready()
    t_lu = time.perf_counter() - t0
    b = jnp.asarray(np.random.RandomState(1).randn(n, 8).astype(dtype))
    x = blr_solve(F, b)
    x.block_until_ready()
    t0 = time.perf_counter()
    for _ in range(10):
        x = blr_solve(F, b)
    x.block_until_ready()
    t_solve = (time.perf_counter() - t0) / 10
    aux[f"blr_n{n}"] = dict(
        n=n,
        build_s=t_build,
        lu_s=t_lu,
        solve_s=t_solve,
        backward_error_est=F.info.get("backward_error_est"),
        n_rank_capped=F.info.get("n_rank_capped_cells"),
        compression=A.compression_info()["compression_ratio"],
    )


def _bench_assembly_cold(n, aux):
    """Cold assembly: the child runs with the persistent compile cache off
    (see ``_setup_jax``), so every program compiles from scratch — the
    first-user experience the warm rows hide."""
    import jax

    import htool_tpu as ht

    dtype = np.float32
    eps = 1e-3
    pts = create_points(n)
    gen = ht.KernelGenerator(kernel(), pts.astype(dtype), pts.astype(dtype))
    tree = ht.build_cluster_tree(pts, max_leaf_size=256)
    compiles = {"n": 0, "secs": 0.0}

    def _count(event, duration, **kw):
        if event == "/jax/core/compile/backend_compile_duration":
            compiles["n"] += 1
            compiles["secs"] += duration

    jax.monitoring.register_event_duration_secs_listener(_count)
    t0 = time.perf_counter()
    H = ht.build_hmatrix(gen, tree, epsilon=eps, eta=10.0)
    jax.block_until_ready([b.data for b in H.dense_buckets])
    t_cold = time.perf_counter() - t0
    n_cold = compiles["n"]
    t0 = time.perf_counter()
    H2 = ht.build_hmatrix(gen, tree, epsilon=eps, eta=10.0)
    jax.block_until_ready([b.data for b in H2.dense_buckets])
    t_warm = time.perf_counter() - t0
    jax.monitoring.unregister_event_duration_listener(_count)
    aux[f"assembly_cold_n{n}"] = dict(
        n=n,
        assembly_cold_s=t_cold,
        assembly_warm_s=t_warm,
        backend_compile_s=compiles["secs"],
        n_backend_compiles_cold=n_cold,
        n_backend_compiles_warm=compiles["n"] - n_cold,
    )


def create_points(n):
    from htool_tpu.testing import create_sphere

    return create_sphere(n)


def kernel():
    from htool_tpu.testing import laplace_kernel_symmetric

    return laplace_kernel_symmetric


# ---------------------------------------------------------------------------
# row registry + one child process per row
# ---------------------------------------------------------------------------

_COLD_ROWS = ("assembly_cold",)


def _setup_jax(name, rehearsal):
    """Child-side JAX setup: the one persistent compile cache (off for the
    cold-assembly row), and the platform check."""
    import jax

    from htool_tpu.utils.compile_cache import enable_compile_cache

    if name.startswith(_COLD_ROWS):
        jax.config.update("jax_enable_compilation_cache", False)
    else:
        enable_compile_cache(ROOT)
    platform = jax.devices()[0].platform
    if platform != "gpu" and not rehearsal:
        raise SystemExit(
            f"bench: needs a GPU, JAX found platform {platform!r} "
            "(--cpu-rehearsal runs the rows on the CPU without timings)"
        )
    return jax


def _row_registry():
    small_n = int(os.environ.get("BENCH_N", "10000"))
    return {
        f"matvec_n{small_n}": lambda aux: _bench_matvec(small_n, 8, 1e-3, aux),
        "matvec_n100000": lambda aux: _bench_matvec(
            100_000, 8, 1e-3, aux, bound=not _REHEARSAL),
        "complex_matvec_n100000": lambda aux: _bench_matvec(
            100_000, 8, 1e-3, aux, complex_=True),
        "blr_n10000": lambda aux: _bench_blr(10_000, 1e-4, aux),
        "blr2_n10000": lambda aux: _bench_blr2(10_000, 1e-4, aux),
        "blr2_n100000": lambda aux: _bench_blr2(100_000, 1e-4, aux),
        "ddm_n100000": lambda aux: _bench_ddm(100_000, aux),
        "ddm2_n20000": lambda aux: _bench_ddm_two_level(20_000, aux),
        "weak_scaling_static": lambda aux: _bench_weak_scaling_static(small_n, aux),
        f"assembly_cold_n{small_n}": lambda aux: _bench_assembly_cold(small_n, aux),
    }


# Estimated row cost (s), compile included, used to gate rows against the
# global wall budget: about twice each row's wall time on one H100 (700 W)
# with a cold compile cache; blr_n10000 is opt-in and unmeasured.
def _row_estimates():
    small_n = int(os.environ.get("BENCH_N", "10000"))
    return {
        f"matvec_n{small_n}": 30,
        "ddm_n100000": 60,
        "ddm2_n20000": 60,
        "blr2_n10000": 60,
        "matvec_n100000": 40,
        "complex_matvec_n100000": 60,
        "weak_scaling_static": 30,
        f"assembly_cold_n{small_n}": 40,
        "blr_n10000": 120,
        "blr2_n100000": 300,
    }


def _row_names():
    """Most important first: the headline, then the flagship DDM rows."""
    small_n = int(os.environ.get("BENCH_N", "10000"))
    large = os.environ.get("BENCH_SKIP_LARGE", "0") != "1"
    names = [f"matvec_n{small_n}"]
    if large:
        names += ["ddm_n100000", "ddm2_n20000", "blr2_n10000",
                  "matvec_n100000", "complex_matvec_n100000"]
        if os.environ.get("BENCH_FLAT_BLR", "0") == "1":
            names.append("blr_n10000")
    names.append("weak_scaling_static")
    if large:
        names += [f"assembly_cold_n{small_n}", "blr2_n100000"]
    return names


_ROW_SENTINEL = "##BENCH_ROW_RESULT## "
_REHEARSAL = False


def _strip_device_metrics(frag):
    """CPU rehearsal: drop every time and rate, keep counts and accuracy."""
    if isinstance(frag, dict):
        return {k: _strip_device_metrics(v) for k, v in frag.items()
                if not k.endswith(_DEVICE_METRIC_SUFFIXES)}
    return frag


def _run_row_inline(name, rehearsal):
    """Child-process entry: run one row, print its result as a JSON line."""
    global _REHEARSAL
    _REHEARSAL = rehearsal
    jax = _setup_jax(name, rehearsal)
    from htool_tpu.utils.device import device_summary, gpu_name_and_power

    device = device_summary(jax.devices())
    device["gpu"] = gpu_name_and_power()
    aux = {}
    err = None
    try:
        _row_registry()[name](aux)
    except Exception as e:
        err = repr(e)[:300]
    if rehearsal:
        aux = _strip_device_metrics(aux)
    for frag in aux.values():
        frag["device"] = device
    print(
        _ROW_SENTINEL
        + json.dumps({"aux": aux, "violations": _VIOLATIONS, "error": err,
                      "device": device})
    )
    sys.stdout.flush()
    sys.exit(1 if err else 0)


def _probe_device():
    """Device summary from a short child process (the parent stays off JAX)."""
    code = ("import json, jax; from htool_tpu.utils.device import "
            "device_summary as d; print(json.dumps(d(jax.devices())))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    if proc.returncode != 0:
        return None
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _run_row_subprocess(name, timeout_s, rehearsal):
    """Run one row in a child process; returns (aux, violations, device,
    error).  A timeout is an error, whatever stopped the row."""
    cmd = [sys.executable, os.path.abspath(__file__), "--row", name]
    if rehearsal:
        cmd.append("--cpu-rehearsal")
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout_s, cwd=ROOT)
    except subprocess.TimeoutExpired:
        return {}, [], None, f"row timed out after {timeout_s}s"
    for line in reversed(proc.stdout.splitlines()):
        if line.startswith(_ROW_SENTINEL):
            payload = json.loads(line[len(_ROW_SENTINEL):])
            return (payload["aux"], payload["violations"], payload["device"],
                    payload["error"])
    tail = (proc.stderr or proc.stdout or "")[-300:]
    return {}, [], None, f"row produced no result (rc={proc.returncode}): {tail}"


def _headline_line(headline, device):
    return json.dumps(
        {
            "metric": "hmatrix_matvec_compressed_entries_per_s",
            "value": headline,
            "unit": "entries/s",
            "device": device,
        }
    )


def _collect_iterations(aux):
    """Iteration counts per solver config, compared with the committed
    record (bench_iterations.json) with a loud warning — the reference's
    pinned-convergence tests (test_solver_ddm.hpp:211-217)."""
    its = {}
    for row, keys in (
        ("ddm_n100000", [("ras_gmres_1level", "iterations")]),
        ("ddm2_n20000", [("ras_gmres_1level_20k", "iterations_one_level"),
                         ("ras_geneo_additive_2level_20k", "iterations_two_level")]),
    ):
        frag = aux.get(row)
        if isinstance(frag, dict):
            for label, key in keys:
                if frag.get(key) is not None:
                    its[label] = frag[key]
    if not its:
        return
    aux["iterations"] = its
    with open(os.path.join(ROOT, "bench_iterations.json")) as f:
        pinned = json.load(f)
    for label, nit in its.items():
        old = pinned.get(label)
        if old and nit > 1.5 * old:
            print(f"[bench] ITERATION REGRESSION {label}: {nit} vs pinned {old}",
                  file=sys.stderr)


def main(rehearsal=False):
    """Run the rows one after another, streaming results after each."""
    probed = _probe_device()
    if probed is None or (probed["platform"] != "gpu" and not rehearsal):
        print(f"bench: needs a GPU, JAX found {probed} "
              "(--cpu-rehearsal runs the rows on the CPU without timings)",
              file=sys.stderr)
        sys.exit(2)
    t_start = time.perf_counter()
    budget = float(os.environ.get("BENCH_TOTAL_BUDGET_S", "1680"))
    est = _row_estimates()
    aux = {"platform": None}
    device = None
    headline = None
    small_n = int(os.environ.get("BENCH_N", "10000"))
    os.makedirs(_OUT_DIR, exist_ok=True)
    aux_path = os.path.join(_OUT_DIR, "bench_aux.json")

    for name in _row_names():
        remaining = budget - (time.perf_counter() - t_start)
        # 15% start margin: a row that starts with a hair of budget left
        # would be cut mid-row
        if remaining < 1.15 * est.get(name, 120):
            aux[name] = {"skipped": f"budget: {remaining:.0f}s left < est {est.get(name, 120)}s"}
            print(f"[bench] SKIP {name}: {remaining:.0f}s budget left, "
                  f"estimated {est.get(name, 120)}s", file=sys.stderr)
            continue
        t0 = time.perf_counter()
        frag, violations, row_device, err = _run_row_subprocess(
            name, min(_ROW_TIMEOUT_S, max(60, int(remaining))), rehearsal
        )
        wall = time.perf_counter() - t0
        if row_device is not None:
            device = device or row_device
            aux["platform"] = aux["platform"] or row_device["platform"]
        if err is not None:
            aux[name] = {"error": err, "device": row_device}
            if not rehearsal:
                aux[name]["wall_s"] = wall
            _VIOLATIONS.append(f"{name}: {err[:150]}")
            print(f"[bench] {name} failed: {err}", file=sys.stderr)
        else:
            aux.update(frag)
        if not rehearsal:
            print(f"[bench] {name}: {wall:.1f}s", file=sys.stderr)
        if name == f"matvec_n{small_n}" and err is None and not rehearsal:
            headline = aux[name].get("compressed_entries_per_s")
        _VIOLATIONS.extend(violations)
        # stream: cumulative aux -> stderr + file, fresh headline -> stdout
        _collect_iterations(aux)
        print(json.dumps(aux), file=sys.stderr)
        print(_headline_line(headline, device))
        sys.stdout.flush()
        sys.stderr.flush()
        with open(aux_path, "w") as f:
            json.dump(aux, f, indent=1)

    if headline is None and not rehearsal:
        _VIOLATIONS.append("headline matvec row missing")
    print(json.dumps(aux), file=sys.stderr)
    print(_headline_line(headline, device))
    if _VIOLATIONS:
        # accuracy contract broken or rows errored: fail AFTER all rows are
        # printed so the numbers are still recorded (reference contract:
        # error < epsilon, test_hmatrix_build.hpp:191)
        print("BENCH VIOLATIONS: " + "; ".join(_VIOLATIONS), file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    rehearsal = "--cpu-rehearsal" in sys.argv
    if len(sys.argv) >= 3 and sys.argv[1] == "--row":
        _run_row_inline(sys.argv[2], rehearsal)
    else:
        main(rehearsal)
