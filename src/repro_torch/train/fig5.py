"""The paper's Fig. 5 experiment: four linear probes trained under four
loading strategies, scored by macro-F1 on a held-out plate.

The port of ``benchmarks/bench_fig5_classification.py``, built from the
port's own parts: :class:`~repro_torch.core.ScIterableDataset` over a
Tahoe-like store (:func:`~repro_torch.data.generate_tahoe_like`), the
two-deep device feed and the Adam step of :mod:`repro_torch.train.probe`,
whose features are the fused ``ell_to_dense`` + ``log1p`` kernel on the card.

- Strategies (:func:`strategies`): ``Streaming()`` and
  ``Streaming(shuffle_buffer=64)`` at ``fetch_factor`` 1,
  ``BlockShuffling(16)`` and ``BlockShuffling(1)`` (random sampling) at 256;
  batch 64.  The buffer of 64 cells keeps the paper's buffer-to-plate ratio
  (16,384 cells against a plate of 7 M) at plates of about 11,000 cells.
- Train on plates 0-12 (:class:`TrainView`), test on plate 13; heads start
  at zero; one epoch per (strategy, seed), seeds 0 and 1; Adam at
  ``probe.LR`` = 1e-2.
- The test plate is densified once, on the heads' device, through
  ``probe.features`` in chunks of :data:`TEST_CHUNK_ROWS` rows.

The claim under test is an ordering: ``BlockShuffling(16)`` scores like
random sampling, and both above the streaming variants, which see one plate
at a time.  Run it as::

    python -m repro_torch.train.fig5                 # 150,000 cells x 2,048 genes, on the card
    python -m repro_torch.train.fig5 --device cpu --cells 20000 --genes 64

Per (strategy, seed) it prints the epoch's seconds, samples/s, the host's
wait for batches and the feature kernel's launches (on the card one per
step, or :func:`train_one` raises); then, per strategy and task, the mean
and standard deviation of macro-F1 over the seeds, the ordering line, and
one JSON object with all of it.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from ..core import BlockShuffling, ScIterableDataset, Streaming
from ..data import generate_tahoe_like, load_tahoe_like
from ..data.csr_store import ShardedCSRStore
from ..kernels import csr_to_dense
from ..precision import full_float32_matmul
from . import probe

__all__ = [
    "M", "SEEDS", "N_CELLS", "N_GENES", "TRAIN_PLATES", "TEST_CHUNK_ROWS", "strategies",
    "TrainView", "held_out_set", "evaluate", "train_dataset", "train_one", "run", "main",
]

M = 64  # batch size
SEEDS = (0, 1)
N_CELLS, N_GENES = 150_000, 2_048  # the benchmark's store
TRAIN_PLATES = 13  # plates 0-12 train, plate 13 tests
TEST_CHUNK_ROWS = 4_096
DEFAULT_DATA = Path(__file__).resolve().parents[3] / "build" / "repro_torch_fig5"


def strategies() -> dict:
    """Name -> (strategy, fetch_factor), in the benchmark's order."""
    return {
        "streaming": (Streaming(), 1),
        "shuffle_buffer": (Streaming(shuffle_buffer=64), 1),
        "block_shuffling": (BlockShuffling(block_size=16), 256),
        "random_sampling": (BlockShuffling(block_size=1), 256),
    }


class TrainView:
    """The first ``n`` cells of a store: the training plates.  Pickles as
    its store does, so a dataset over it travels to ``DataLoader`` workers."""

    def __init__(self, store, n: int):
        self.store, self.n = store, int(n)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, rows):
        return self.store[rows]


def _check_plates(store: ShardedCSRStore) -> None:
    if len(store.shards) != TRAIN_PLATES + 1:
        raise ValueError(f"need {TRAIN_PLATES + 1} plates (train on 0-{TRAIN_PLATES - 1}, "
                         f"test on {TRAIN_PLATES}), the store has {len(store.shards)}")


def held_out_set(store: ShardedCSRStore, device) -> tuple[torch.Tensor, dict]:
    """Plate 13's features on ``device`` (``log1p`` of its counts, densified
    in chunks of TEST_CHUNK_ROWS rows) and its labels per task (numpy)."""
    _check_plates(store)
    device = torch.device(device)
    plate = store.shards[TRAIN_PLATES]
    batch = plate[np.arange(len(plate))]
    x = torch.empty((len(batch), store.n_var), dtype=torch.float32, device=device)
    for lo in range(0, len(batch), TEST_CHUNK_ROWS):
        t = batch[np.arange(lo, min(lo + TEST_CHUNK_ROWS, len(batch)))].to_tensors()
        x[lo:lo + len(t["vals"])] = probe.features(
            t["vals"].to(device), t["cols"].to(device), n_genes=store.n_var)
    return x, {t: np.asarray(batch.obs[t]) for t in probe.TASKS}


def evaluate(heads: probe.ProbeHeads, x: torch.Tensor, y: dict) -> dict:
    """Macro-F1 per task of the heads' argmax on features ``x``."""
    with torch.no_grad(), full_float32_matmul():
        logits = heads(x)
    return {t: probe.macro_f1(logits[t].argmax(-1).cpu().numpy(), y[t], c)
            for t, c in probe.TASKS.items()}


def train_dataset(store: ShardedCSRStore, strategy, fetch_factor: int,
                  seed: int) -> ScIterableDataset:
    """One epoch's loader over the training plates, batch M."""
    _check_plates(store)
    return ScIterableDataset(TrainView(store, int(store.offsets[TRAIN_PLATES])), strategy,
                             batch_size=M, fetch_factor=fetch_factor, seed=seed)


def train_one(store: ShardedCSRStore, strategy, fetch_factor: int, seed: int,
              device) -> tuple[probe.ProbeHeads, dict]:
    """One epoch of zero-initialised heads over the training plates; returns
    the heads and the epoch's record.  On the card every step's features
    must come from one launch of the fused kernel."""
    device = torch.device(device)
    ds = train_dataset(store, strategy, fetch_factor, seed)
    heads = probe.init_heads(store.n_var, device=device)
    opt = probe.init_adam(heads)
    before = csr_to_dense.ell_to_dense.launches
    out = probe.train_probe(ds, heads, opt, device=device)
    launches = csr_to_dense.ell_to_dense.launches - before
    if device.type == "cuda" and launches != out["steps"]:
        raise RuntimeError(f"ell_to_dense launched {launches} times in {out['steps']} steps")
    return heads, {"steps": out["steps"], "seconds": out["seconds"],
                   "samples_per_s": out["steps"] * M / out["seconds"],
                   "loader_wait_s": out["loader_wait_s"], "ell_to_dense_launches": launches}


def run(store: ShardedCSRStore, *, seeds: Sequence[int] = SEEDS, device="cuda",
        log: Callable[[str], None] = print) -> dict:
    """The experiment over ``seeds``.  Returns ``macro_f1`` (strategy ->
    task -> one score per seed), ``epochs`` (one record per strategy and
    seed), ``summary`` (strategy -> task -> [mean, std]) and ``ordering``
    (strategy -> its mean over tasks and seeds)."""
    x_test, y_test = held_out_set(store, device)
    scores = {s: {t: [] for t in probe.TASKS} for s in strategies()}
    epochs = []
    for name, (strategy, f) in strategies().items():
        for seed in seeds:
            heads, record = train_one(store, strategy, f, seed, device)
            for t, score in evaluate(heads, x_test, y_test).items():
                scores[name][t].append(score)
            epochs.append({"strategy": name, "seed": seed, **record})
            log(f"# {name} seed {seed}: epoch {record['seconds']:.2f} s, {record['steps']} steps, "
                f"{record['samples_per_s']:.1f} samples/s, loader wait "
                f"{record['loader_wait_s']:.2f} s, ell_to_dense launches "
                f"{record['ell_to_dense_launches']}, f1="
                f"{ {t: round(scores[name][t][-1], 3) for t in probe.TASKS} }")
    summary = {s: {t: [float(np.mean(v)), float(np.std(v))] for t, v in by.items()}
               for s, by in scores.items()}
    ordering = {s: float(np.mean([np.mean(v) for v in by.values()])) for s, by in scores.items()}
    for s, by in summary.items():
        for t, (mean, std) in by.items():
            log(f"fig5_{s}_{t} macro_f1={mean:.3f}+-{std:.3f}")
    log(f"fig5_ordering streaming={ordering['streaming']:.3f};"
        f"buffer={ordering['shuffle_buffer']:.3f};block={ordering['block_shuffling']:.3f};"
        f"random={ordering['random_sampling']:.3f};claim=block~random>buffer~streaming")
    return {"macro_f1": scores, "epochs": epochs, "summary": summary, "ordering": ordering}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", type=int, default=N_CELLS)
    ap.add_argument("--genes", type=int, default=N_GENES)
    ap.add_argument("--data-dir", default=None,
                    help="the store's directory (default: build/repro_torch_fig5/<cells>x<genes> "
                         "in the checkout); generated there unless its manifest matches")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA card here: pass --device cpu to run on the CPU")
    root = args.data_dir or str(DEFAULT_DATA / f"{args.cells}x{args.genes}")
    t0 = time.perf_counter()
    generate_tahoe_like(root, n_cells=args.cells, n_genes=args.genes, seed=0)
    store = load_tahoe_like(root)
    data_s = time.perf_counter() - t0
    print(f"# data: {len(store)} cells x {store.n_var} genes, {len(store.shards)} plates, "
          f"{data_s:.1f} s", flush=True)
    result = run(store, device=device, log=lambda s: print(s, flush=True))
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps({"fig5": {"device": kind, "cells": len(store), "genes": store.n_var,
                               "data_seconds": data_s, **result}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
