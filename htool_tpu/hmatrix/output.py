"""H-matrix structure outputs — per-leaf CSV with ranks, for the plotting
tools (``hmatrix/hmatrix_output.hpp``: ``save_leaves_with_rank:39``,
``save_levels:58``) and H-matrix binary persistence."""

from __future__ import annotations

import csv

import numpy as np

from .hmatrix import DenseBucket, HMatrix, LowRankBucket

__all__ = [
    "save_leaves_with_rank",
    "save_levels",
    "view_block_tree",
    "load_hmatrix",
    "save_hmatrix",
]


def _iter_leaves(h: HMatrix):
    """Yield (t_off, t_size, s_off, s_size, kind, rank, mirror) per leaf."""
    for b in h.dense_buckets:
        t_off = np.asarray(b.t_off)
        s_off = np.asarray(b.s_off)
        t_sz = np.asarray(b.t_sizes)
        s_sz = np.asarray(b.s_sizes)
        for i in range(t_off.shape[0]):
            yield t_off[i], t_sz[i], s_off[i], s_sz[i], "dense", -1, b.mirror
    for b in h.lr_buckets:
        t_off = np.asarray(b.t_off)
        s_off = np.asarray(b.s_off)
        t_sz = np.asarray(b.t_sizes)
        s_sz = np.asarray(b.s_sizes)
        rk = np.asarray(b.ranks)
        for i in range(t_off.shape[0]):
            yield t_off[i], t_sz[i], s_off[i], s_sz[i], "lr", int(rk[i]), b.mirror


def save_leaves_with_rank(h: HMatrix, filename: str) -> None:
    """CSV rows: t_off, t_size, s_off, s_size, kind, rank, mirror —
    the block-picture input (tools/plot_hmatrix.py)."""
    with open(filename, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["t_off", "t_size", "s_off", "s_size", "kind", "rank", "mirror"])
        for t_off, t_sz, s_off, s_sz, kind, rank, mirror in _iter_leaves(h):
            w.writerow([t_off, t_sz, s_off, s_sz, kind, rank, int(mirror)])


def save_levels(h: HMatrix, filename: str) -> None:
    """Per-level aggregate CSV (``save_levels``, hmatrix_output.hpp:58): the
    flat layout has no stored tree depth, so the level is reconstructed as
    log2 of the block extent relative to the root — rows: level proxy
    (max block extent), #dense, #lr, rank min/mean/max."""
    by_extent: dict[int, list] = {}
    for t_off, t_sz, s_off, s_sz, kind, rank, _ in _iter_leaves(h):
        by_extent.setdefault(int(max(t_sz, s_sz)), []).append((kind, rank))
    with open(filename, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["block_extent", "n_dense", "n_lr", "rank_min", "rank_mean", "rank_max"])
        for ext in sorted(by_extent, reverse=True):
            rows = by_extent[ext]
            ranks = [r for k, r in rows if k == "lr"]
            w.writerow(
                [
                    ext,
                    sum(1 for k, _ in rows if k == "dense"),
                    len(ranks),
                    min(ranks) if ranks else 0,
                    float(np.mean(ranks)) if ranks else 0.0,
                    max(ranks) if ranks else 0,
                ]
            )


def view_block_tree(h: HMatrix, filename: str | None = None) -> str:
    """Graphviz DOT of the block structure (``view_block_tree``,
    hmatrix_output_dot.hpp:51-210): one node per leaf labeled with its
    (rows × cols [rank]) footprint, colored green (low-rank) / red (dense)."""
    lines = [
        "digraph block_tree {",
        "  node [shape=box, style=filled];",
        f'  root [label="{h.shape[0]} x {h.shape[1]}", fillcolor=lightgray];',
    ]
    for i, (t_off, t_sz, s_off, s_sz, kind, rank, mirror) in enumerate(
        _iter_leaves(h)
    ):
        if kind == "lr":
            label = f"[{t_off},{t_off + t_sz})x[{s_off},{s_off + s_sz}) r={rank}"
            color = "palegreen"
        else:
            label = f"[{t_off},{t_off + t_sz})x[{s_off},{s_off + s_sz})"
            color = "lightcoral"
        if mirror:
            label += " +mirror"
        lines.append(f'  b{i} [label="{label}", fillcolor={color}];')
        lines.append(f"  root -> b{i};")
    lines.append("}")
    dot = "\n".join(lines)
    if filename:
        with open(filename, "w") as f:
            f.write(dot)
    return dot


def save_hmatrix(h: HMatrix, filename: str) -> None:
    """Persist the full compressed H-matrix (npz).  The reference does not
    serialize H-matrices (SURVEY.md §5 checkpoint/resume); this closes that
    gap for checkpoint/restore of assembled operators.  Files written with
    the older per-bucket product plans still load: the extra arrays are
    ignored."""
    payload = dict(
        shape=np.array(h.shape),
        symmetry=np.array([h.symmetry]),
        UPLO=np.array([h.UPLO]),
        t_root_off=np.array([h.t_root_off]),
        perm_t=np.asarray(h.perm_t),
        perm_s=np.asarray(h.perm_s),
        n_dense=np.array([len(h.dense_buckets)]),
        n_lr=np.array([len(h.lr_buckets)]),
    )
    for k, b in enumerate(h.dense_buckets):
        payload[f"d{k}_data"] = np.asarray(b.data)
        payload[f"d{k}_t_off"] = np.asarray(b.t_off)
        payload[f"d{k}_s_off"] = np.asarray(b.s_off)
        payload[f"d{k}_t_sizes"] = np.asarray(b.t_sizes)
        payload[f"d{k}_s_sizes"] = np.asarray(b.s_sizes)
        payload[f"d{k}_mirror"] = np.array([int(b.mirror)])
    for k, b in enumerate(h.lr_buckets):
        payload[f"l{k}_U"] = np.asarray(b.U)
        payload[f"l{k}_V"] = np.asarray(b.V)
        payload[f"l{k}_t_off"] = np.asarray(b.t_off)
        payload[f"l{k}_s_off"] = np.asarray(b.s_off)
        payload[f"l{k}_t_sizes"] = np.asarray(b.t_sizes)
        payload[f"l{k}_s_sizes"] = np.asarray(b.s_sizes)
        payload[f"l{k}_ranks"] = np.asarray(b.ranks)
        payload[f"l{k}_mirror"] = np.array([int(b.mirror)])
    np.savez_compressed(filename, **payload)


def load_hmatrix(filename: str) -> HMatrix:
    import jax.numpy as jnp

    z = np.load(filename, allow_pickle=False)
    dense, lr = [], []
    for k in range(int(z["n_dense"][0])):
        b = DenseBucket(
            data=jnp.asarray(z[f"d{k}_data"]),
            t_off=jnp.asarray(z[f"d{k}_t_off"]),
            s_off=jnp.asarray(z[f"d{k}_s_off"]),
            t_sizes=z[f"d{k}_t_sizes"],
            s_sizes=z[f"d{k}_s_sizes"],
            mirror=bool(z[f"d{k}_mirror"][0]),
        )
        dense.append(b)
    for k in range(int(z["n_lr"][0])):
        b = LowRankBucket(
            U=jnp.asarray(z[f"l{k}_U"]),
            V=jnp.asarray(z[f"l{k}_V"]),
            t_off=jnp.asarray(z[f"l{k}_t_off"]),
            s_off=jnp.asarray(z[f"l{k}_s_off"]),
            t_sizes=z[f"l{k}_t_sizes"],
            s_sizes=z[f"l{k}_s_sizes"],
            ranks=z[f"l{k}_ranks"],
            mirror=bool(z[f"l{k}_mirror"][0]),
        )
        lr.append(b)
    return HMatrix(
        shape=tuple(int(x) for x in z["shape"]),
        dense_buckets=dense,
        lr_buckets=lr,
        perm_t=jnp.asarray(z["perm_t"]),
        perm_s=jnp.asarray(z["perm_s"]),
        symmetry=str(z["symmetry"][0]),
        UPLO=str(z["UPLO"][0]),
        t_root_off=int(z["t_root_off"][0]),
    )
