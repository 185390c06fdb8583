"""The paper's Fig. 4: minibatch plate entropy against ``(b, f)``.

The port of ``benchmarks/bench_fig4_entropy.py``, built from the port's own
parts: a Tahoe-like store (:func:`~repro_torch.data.generate_tahoe_like`),
``Pipeline.from_uri("sharded-csr://...").diversity(obs="plate")`` and the
§3.4 theory (:func:`~repro_torch.core.theory.entropy_bounds`,
:func:`~repro_torch.core.theory.mean_batch_entropy`).

Each cell ``(b, f)`` draws ``N_BATCHES`` batches of ``M`` cells, rounded up
to whole fetches (a fetch materializes, and the monitor observes, all ``f``
of its batches at once), from ``BlockShuffling(b)`` with seed 0; it
measures the mean and standard deviation of the batches' plate entropy
offline and requires the live ``div_*`` counters of the pipeline's
:class:`~repro_torch.core.dataset.EntropyMonitor` to count the same batches
and hold the same mean (rtol 1e-9).  Beside each cell the theory's bounds
for ``(p, M, b)`` and whether the measurement lies within them, widened by
three standard deviations (at least 0.05 bits), as the benchmark prints.

The paper's numbers (m 64, 14 Tahoe plates, H(p) 3.78): b 16 f 1 gives
1.76 ± 0.33, b 16 f 256 gives 3.61 ± 0.08, random sampling 3.62.  A
synthetic store has a plate distribution of its own, whose H(p) is printed.
Label entropy needs no kernel: the work is on the host.  Run it as::

    python -m repro_torch.train.fig4                       # 150,000 cells x 2,048 genes
    python -m repro_torch.train.fig4 --cells 20000 --genes 64 --b 1 16 --f 1 16
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Sequence

import numpy as np

from ..core.theory import distribution_entropy, entropy_bounds, mean_batch_entropy
from ..data import IOCounters, generate_tahoe_like, load_tahoe_like
from ..pipeline import Pipeline
from .fig5 import DEFAULT_DATA, N_CELLS, N_GENES

__all__ = ["M", "GRID_B", "GRID_F", "N_BATCHES", "PAPER", "plate_distribution",
           "measure_entropy", "cell", "run", "main"]

M = 64  # batch size
GRID_B = (1, 4, 16, 64, 256, 1024)
GRID_F = (1, 4, 16, 64, 256)
N_BATCHES = 160
#: the paper's Fig. 4 readings: (mean, std) at b 16, f 1 and f 256, and
#: random sampling's mean
PAPER = {"b16_f1": (1.76, 0.33), "b16_f256": (3.61, 0.08), "random": 3.62}
RANDOM = (1, 4)  # the benchmark's random-sampling cell


def plate_distribution(root: str) -> np.ndarray:
    """The store's plate shares: each plate is one shard."""
    sizes = np.array([len(s) for s in load_tahoe_like(root).shards], dtype=np.float64)
    return sizes / sizes.sum()


def measure_entropy(root: str, b: int, f: int, *, n_batches: int = N_BATCHES,
                    seed: int = 0, **open_kw) -> tuple[float, float]:
    """Mean and standard deviation of cell ``(b, f)``'s batch plate entropy,
    held to the live ``div_*`` counters over the same batches."""
    stats = IOCounters()
    pipe = (Pipeline.from_uri("sharded-csr://" + root, iostats=stats, **open_kw)
            .strategy("block", block_size=b)
            .batch(M, fetch_factor=f)
            .seed(seed)
            .diversity(obs="plate")
            .build(batch_transform=lambda bb: np.asarray(bb.obs["plate"])))
    n_target = -(-n_batches // f) * f  # whole fetches
    plates = []
    for pl in pipe:
        plates.append(np.asarray(pl))
        if len(plates) >= n_target:
            break
    pipe.close()
    if not plates:
        raise ValueError(f"the store holds fewer cells than one fetch of {M * f} (b={b}, f={f})")
    mean, std = mean_batch_entropy(plates)
    snap = stats.snapshot()
    if snap["div_batches"] != len(plates):
        raise RuntimeError(f"the diversity counters saw {snap['div_batches']} batches, "
                           f"{len(plates)} were delivered (b={b}, f={f})")
    live_mean = snap["div_entropy_sum"] / snap["div_batches"]
    if not np.isclose(live_mean, mean, rtol=1e-9, atol=1e-12):
        raise RuntimeError(f"live entropy {live_mean} != measured {mean} (b={b}, f={f})")
    return mean, std


def cell(root: str, p: np.ndarray, b: int, f: int, **kw) -> dict:
    """One cell: the measurement, the theory's bounds and ``in_bounds``."""
    t0 = time.perf_counter()
    mean, std = measure_entropy(root, b, f, **kw)
    lo, hi = entropy_bounds(p, M, b)
    slack = 3 * max(std, 0.05)
    return {"b": b, "f": f, "H": mean, "std": std, "bounds": [lo, hi],
            "in_bounds": bool(lo - slack <= mean <= hi + slack),
            "seconds": time.perf_counter() - t0}


def run(root: str, *, grid_b: Sequence[int] = GRID_B, grid_f: Sequence[int] = GRID_F,
        log: Callable[[str], None] = print, **kw) -> dict:
    """Every cell of the grid, then random sampling; the paper's readings
    beside the cells they name (where the grid has them)."""
    p = plate_distribution(root)
    hp = distribution_entropy(p)
    log(f"# H(p) = {hp:.3f} over {len(p)} plates (the paper's Tahoe-100M: 3.78)")
    cells = {}
    for b in grid_b:
        for f in grid_f:
            c = cells[f"b{b}_f{f}"] = cell(root, p, b, f, **kw)
            log(f"b={b:5d} f={f:4d}  H={c['H']:.2f}+-{c['std']:.2f}  "
                f"bounds=[{c['bounds'][0]:.2f},{c['bounds'][1]:.2f}]  in_bounds={c['in_bounds']}")
    rnd = cell(root, p, *RANDOM, **kw)
    log(f"random sampling (b={RANDOM[0]}, f={RANDOM[1]}): H={rnd['H']:.2f} "
        f"(paper {PAPER['random']})")
    paper = {"random": {"measured": rnd["H"], "paper": PAPER["random"]}}
    for key in ("b16_f1", "b16_f256"):
        if key in cells:
            paper[key] = {"measured": [cells[key]["H"], cells[key]["std"]], "paper": PAPER[key]}
            log(f"{key}: H={cells[key]['H']:.2f}+-{cells[key]['std']:.2f} "
                f"(paper {PAPER[key][0]}+-{PAPER[key][1]})")
    return {"Hp": hp, "plates": len(p), "m": M, "n_batches": N_BATCHES, "grid": cells,
            "random": rnd, "paper": paper,
            "all_in_bounds": all(c["in_bounds"] for c in cells.values()),
            "live_counters": "div_* equal to the offline measurement in every cell"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", type=int, default=N_CELLS)
    ap.add_argument("--genes", type=int, default=N_GENES)
    ap.add_argument("--data-dir", default=None,
                    help="the store's directory (default: build/repro_torch_fig5/<cells>x<genes> "
                         "in the checkout, shared with the Fig. 5 experiment); generated there "
                         "unless its manifest matches")
    ap.add_argument("--b", type=int, nargs="+", default=list(GRID_B))
    ap.add_argument("--f", type=int, nargs="+", default=list(GRID_F))
    args = ap.parse_args(argv)
    root = args.data_dir or str(DEFAULT_DATA / f"{args.cells}x{args.genes}")
    t0 = time.perf_counter()
    generate_tahoe_like(root, n_cells=args.cells, n_genes=args.genes, seed=0)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    result = run(root, grid_b=args.b, grid_f=args.f, log=lambda s: print(s, flush=True))
    print(json.dumps({"fig4": {"cells": args.cells, "genes": args.genes, "data_seconds": data_s,
                               "seconds": time.perf_counter() - t0, **result}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
