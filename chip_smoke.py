#!/usr/bin/env python3
"""Drive the PyTorch port's cell-training path on one CUDA card, check it,
and time its kernel against its plain version.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card and the CUDA toolkit (``nvcc``); imports
nothing of JAX or of the JAX package.  Phases, each printing one JSON line:

1. device: the card's name, count and power limit;
2. build: every ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a``, all started together;
3. data: a Tahoe-like dataset at Tahoe-100M's width, 62,710 genes (14
   plates, 65,536 cells = four fetches of 64 x 256, 2,048 counts per cell,
   seed 0), generated under ``build/chip_smoke_data`` in the checkout or
   reused when its manifest matches;
4. kernel: ``ell_to_dense`` on the card against its plain PyTorch version:
   the JAX package's sweep with duplicate columns (atol 1e-6, the order in
   which duplicates add up differs) and a real batch of the path (bitwise:
   canonical CSR has no duplicates, so every output is one value or 0),
   with CUDA-event times of the kernel (also at 132 and 264 rows), the
   plain version and one PyTorch call of the same function, each over
   back-to-back calls queued behind a sleep kernel so that the host's
   time per call is hidden; one train step on the card against the same
   step on the CPU (loss within rtol 1e-4: float32 products summed in
   another order);
5. main path: ``BlockShuffling(16)``, batch 64, ``fetch_factor=256``, the
   two-deep device feed and one epoch of ``train_step`` (1,024 steps, four
   fetches of 16,384 random 16-cell blocks) through
   ``train_probe``, with the kernel's launch count set to 0 just before and
   read just after;
6. trace: 64 steps of the next epoch under ``torch.profiler``, for the
   device's kernel time by name and ``ell_to_dense``'s own.

Then the kernels line (one entry per kernel of the path), and as the last
line ``{"ok": true, "device": {...}}``.  Any failure exits non-zero before it.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

N_GENES = 62_710  # Tahoe-100M's gene count: the probe's full width
DATA = dict(n_cells=65_536, n_genes=N_GENES, n_plates=14, total_counts=2048, chunk=256, seed=0)
BATCH, FETCH_FACTOR, BLOCK = 64, 256, 16
MIN_STEPS = 200
# the JAX package's ELL sweep (tests/test_kernels.py): (rows, K, n_cols)
SWEEP = [(16, 8, 64), (33, 5, 100), (8, 16, 512), (1, 1, 8)]
SWEEP_ATOL = 1e-6
TIMED_CALLS, TIMED_GROUPS = 100, 5
SLEEP_CYCLES = 50_000_000  # ~30 ms of sleep kernel: time to queue TIMED_CALLS calls
SWEEP_ROWS = (64, 132, 264)  # one row per block: the path's batch, one and two per SM
TRACE_STEPS = 64
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def event_ms(fn) -> float:
    """Device ms per call of ``fn``: one CUDA-event pair around
    ``TIMED_CALLS`` back-to-back calls, divided by their number; the median
    of ``TIMED_GROUPS`` such groups.  A sleep kernel ahead of each group
    holds the stream while the host queues the calls, so the host's time
    per call does not count unless ``fn`` itself waits for the device."""
    import torch

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(TIMED_GROUPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(TIMED_CALLS):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / TIMED_CALLS)
    return statistics.median(per_call)


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script measures the card and has no CPU mode")
    from repro_torch.core import BlockShuffling, ScIterableDataset
    from repro_torch.data import generate_tahoe_like, load_tahoe_like
    from repro_torch.kernels import _build, csr_to_dense, ref
    from repro_torch.train import probe

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "capability": list(torch.cuda.get_device_capability(0))})

    # 2. build
    t0 = time.perf_counter()
    built = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "built": built})

    # 3. data
    root = os.path.join(HERE, "build", "chip_smoke_data")
    t0 = time.perf_counter()
    generate_tahoe_like(root, **DATA)
    store = load_tahoe_like(root)
    emit({"phase": "data", "seconds": time.perf_counter() - t0, "cells": len(store),
          "genes": store.n_var, "plates": len(store.shards),
          "fetches_per_epoch": math.ceil(len(store) / (BATCH * FETCH_FACTOR))})

    def dataset():
        return ScIterableDataset(store, BlockShuffling(BLOCK), batch_size=BATCH,
                                 fetch_factor=FETCH_FACTOR, seed=0)

    # 4. the kernel against its plain version
    rng = np.random.default_rng(0)
    cases = [(rng.normal(0, 1, (R, K)), rng.integers(-1, G, (R, K)), G) for R, K, G in SWEEP]
    cases.append(([[1.0, 2.0, 3.0]], [[4, 4, -1]], 8))  # explicit duplicates
    sweep_err = 0.0
    for v, c, G in cases:
        vals = torch.tensor(np.asarray(v, np.float32), device=dev)
        cols = torch.tensor(np.asarray(c, np.int32), device=dev)
        got = csr_to_dense.ell_to_dense(vals, cols, n_cols=G)
        sweep_err = max(sweep_err, (got - ref.ell_to_dense_ref(vals, cols, G)).abs().max().item())
    if not sweep_err <= SWEEP_ATOL:
        fail(f"ell_to_dense disagrees with its plain version on the sweep: {sweep_err} > {SWEEP_ATOL}")

    batches = dataset().fetch(0, 0)[:3]
    t = batches[0].to_tensors()
    vals, cols = t["vals"].to(dev), t["cols"].to(dev)
    R, K = vals.shape
    got = csr_to_dense.ell_to_dense(vals, cols, n_cols=N_GENES)
    want = ref.ell_to_dense_ref(vals, cols, N_GENES)
    torch.cuda.synchronize()
    main_err = (got - want).abs().max().item()
    if not torch.equal(got, want):
        fail(f"ell_to_dense is not bitwise its plain version on a path batch (max err {main_err})")

    valid = cols >= 0
    lib_rows = torch.arange(R, device=dev).unsqueeze(1).expand(R, K)[valid]
    lib_cols, lib_vals = cols[valid].long(), vals[valid]
    nnz = int(valid.sum())
    kernel_ms = event_ms(lambda: csr_to_dense.ell_to_dense(vals, cols, n_cols=N_GENES))
    by_rows = {}  # the same rows repeated: does the time follow the bytes or the blocks?
    for n in SWEEP_ROWS:
        v_n = vals.repeat(-(-n // R), 1)[:n].contiguous()
        c_n = cols.repeat(-(-n // R), 1)[:n].contiguous()
        by_rows[n] = event_ms(lambda: csr_to_dense.ell_to_dense(v_n, c_n, n_cols=N_GENES))
    plain_ms = event_ms(lambda: ref.ell_to_dense_ref(vals, cols, N_GENES))
    library_ms = event_ms(lambda: torch.zeros((R, N_GENES), device=dev).index_put_(
        (lib_rows, lib_cols), lib_vals, accumulate=True))
    moved = vals.numel() * 4 + cols.numel() * 4 + R * N_GENES * 4  # each input read, the output written
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, nnz / FP32_FLOP_PER_S * 1e3
    kernel = {"name": "ell_to_dense", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/ell_to_dense.cu",
              "replaces": "src/repro/kernels/csr_to_dense.py:53",
              "shape": [R, K, N_GENES], "nnz": nnz,
              "max_abs_err": max(sweep_err, main_err), "sweep_max_abs_err": sweep_err,
              "path_batch_max_abs_err": main_err,
              # "ms" and "kernel_ms" name one time: readers of the kernels line expect both
              "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
              "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bytes": moved,
              "kernel_ms_by_rows": by_rows}
    emit({"phase": "kernel", **kernel})

    # the same train steps on the card and on the CPU, from the same heads
    gen = torch.Generator().manual_seed(1)
    heads_gpu = probe.init_heads(N_GENES, device=dev, generator=gen)
    heads_cpu = probe.init_heads(N_GENES, device="cpu", generator=torch.Generator().manual_seed(1))
    opt_gpu, opt_cpu = probe.init_adam(heads_gpu), probe.init_adam(heads_cpu)
    step_losses = []
    for b in batches:
        tb = b.to_tensors()
        lc = probe.train_step(heads_cpu, opt_cpu, probe.features(tb["vals"], tb["cols"], n_genes=N_GENES), tb["obs"])
        tg = {"vals": tb["vals"].to(dev), "cols": tb["cols"].to(dev),
              "obs": {k: v.to(dev) for k, v in tb["obs"].items()}}
        lg = probe.train_step(heads_gpu, opt_gpu, probe.features(tg["vals"], tg["cols"], n_genes=N_GENES), tg["obs"])
        step_losses.append((lg.item(), lc.item()))
    for lg, lc in step_losses:
        if not math.isclose(lg, lc, rel_tol=1e-4):
            fail(f"train_step on the card and on the CPU disagree: losses {step_losses}")
    emit({"phase": "step_vs_cpu", "losses_card_cpu": step_losses, "rtol": 1e-4})
    del heads_gpu, heads_cpu, opt_gpu, opt_cpu

    # 5. the main path
    ds = dataset()
    heads = probe.init_heads(N_GENES, device=dev, generator=torch.Generator().manual_seed(0))
    opt = probe.init_adam(heads)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    csr_to_dense.ell_to_dense.launches = 0
    run = probe.train_probe(ds, heads, opt, device=dev)
    launches = csr_to_dense.ell_to_dense.launches
    losses = run["losses"]
    steps = run["steps"]
    if steps < MIN_STEPS:
        fail(f"the epoch gave {steps} steps, fewer than {MIN_STEPS}")
    if launches != steps:
        fail(f"ell_to_dense launched {launches} times in {steps} steps")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss: {losses}")
    first, last = statistics.mean(losses[:20]), statistics.mean(losses[-20:])
    if not last < first:
        fail(f"loss did not fall: first 20 steps {first}, last 20 {last}")
    stream_ms = sorted(run["step_stream_ms"])
    emit({"phase": "main_path", "steps": steps, "batch": BATCH, "fetch_factor": FETCH_FACTOR,
          "block_size": BLOCK, "genes": N_GENES, "cells": len(store), "cut": None,
          "ell_to_dense_launches": launches, "seconds": run["seconds"],
          "samples_per_s": steps * BATCH / run["seconds"],
          "step_ms_mean": run["seconds"] / steps * 1e3,
          "step_stream_ms_median": statistics.median(stream_ms),
          "step_stream_ms_p90": stream_ms[int(0.9 * (len(stream_ms) - 1))],
          "loader_wait_s": run["loader_wait_s"],
          "stream_idle_share": 1 - sum(stream_ms) / 1e3 / run["seconds"],
          "peak_device_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
          "loss_first20": first, "loss_last20": last})

    # 6. a traced window of the next epoch, after the counts were read:
    #    device kernel time by name (the profiler's own cost is in the wall)
    from torch.profiler import ProfilerActivity, profile

    ds.set_epoch(1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = probe.train_probe(ds, heads, opt, device=dev, max_steps=TRACE_STEPS)
    on_card = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_us = sum(e.self_device_time_total for e in on_card)
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:10]
    mine = [e for e in on_card if "ell_to_dense" in e.key]
    if not mine:
        fail("the trace shows no ell_to_dense kernel on the card")
    emit({"phase": "trace", "steps": traced["steps"], "seconds": traced["seconds"],
          "loader_wait_s": traced["loader_wait_s"],
          "device_kernel_ms": kernel_us / 1e3 if on_card else None,
          "device_busy_share": kernel_us / 1e6 / traced["seconds"] if on_card else None,
          "ell_to_dense": {"count": sum(e.count for e in mine),
                           "device_ms": sum(e.self_device_time_total for e in mine) / 1e3,
                           "ms_per_launch": sum(e.self_device_time_total for e in mine) / 1e3
                           / sum(e.count for e in mine)},
          "top_kernels": [[e.key[:80], e.count, e.self_device_time_total / 1e3] for e in top]})

    kernel["launches"] = launches
    emit({"kernels": [{k: kernel[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
        "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
