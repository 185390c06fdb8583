"""End-to-end training driver: scDataset block sampling -> PyTorch train
loop; the port of ``repro.launch.train``.

The paper's loader is the input pipeline: a memory-mapped token corpus is
block-sampled (BlockShuffling b, batched fetching f), the per-rank
round-robin fetch assignment feeds the data-parallel axis, and loader
state rides in every checkpoint so restarts resume mid-epoch bitwise.  On
the card, attention's forward and backward run through the Hopper
flash-attention kernels, the selective scan's (ssm and hybrid families)
through the scan's forward and backward kernels.  On the CPU, with the
smoke config::

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 50 --batch 8 --seq 128 --ckpt-dir build/run1
  PYTHONPATH=src python -m repro_torch.launch.train --arch falcon-mamba-7b \\
      --smoke --device cpu --steps 4

Resume after a crash (same command + --resume) continues bit-exactly.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..configs import get_config, smoke_config
from ..core import LoaderState
from ..data.tokens import generate_token_corpus
from ..models import Model
from ..pipeline import DataPipeline, Pipeline
from ..train.optimizer import AdamWConfig, warmup_cosine
from ..train.step import (
    load_train_state_tree,
    make_train_state,
    make_train_step,
    train_state_tree,
)
from .serve import _sync

__all__ = ["build_loader", "train_loop", "main"]

DEFAULT_CORPUS = Path(__file__).resolve().parents[3] / "build" / "repro_torch_corpus"


def build_loader(
    corpus_dir: str,
    seq_len: int,
    batch: int,
    *,
    block_size: int = 16,
    fetch_factor: int = 8,
    seed: int = 0,
    rank: int = 0,
    world_size: int = 1,
    n_tokens: int = 2_000_000,
    vocab_size: int = 1024,
    prefetch_workers: int = 0,
) -> DataPipeline:
    """The training input pipeline, declared through the Pipeline API.

    ``pipe.spec`` is the full serializable description of the stream; it
    rides in every checkpoint (``extra["data_spec"]``) and its fingerprint
    in the loader state, so a resumed run refuses a drifted data config.
    """
    generate_token_corpus(corpus_dir, n_tokens=n_tokens, vocab_size=vocab_size)
    return (
        Pipeline.from_uri(f"tokens://{corpus_dir}", seq_len=int(seq_len))
        .strategy("block", block_size=block_size)
        .batch(batch, fetch_factor=fetch_factor)
        .shard(rank, world_size)
        .seed(seed)
        .prefetch(workers=prefetch_workers)
        .build()
    )


def train_loop(
    model: Model,
    loader: DataPipeline,
    *,
    steps: int,
    ckpt_dir: str | None = None,
    ckpt_every: int = 20,
    resume: bool = False,
    lr: float = 3e-4,
    log_every: int = 10,
    seed: int = 0,
    crash_after: int | None = None,  # fault-injection hook (tests)
    device="cuda",
    state: Optional[dict] = None,
    timings: Optional[dict] = None,
) -> dict:
    """Train to ``steps`` steps; returns ``final_state``, ``metrics`` (one
    dict of floats per logged step) and ``last_step``.

    ``state`` is an initial train state (e.g. carried over from the JAX
    package by :func:`repro_torch.convert.train_state_from_jax`); without
    it the weights are drawn from a generator seeded ``seed``.  A resumed
    run restores the latest checkpoint over it.  ``timings``, when given,
    receives three lists of host times, one entry per step: ``fetch_s``,
    from asking the loader for a batch to the batch on the device;
    ``step_s``, from there to a synchronise after the update; ``end``, the
    ``time.perf_counter()`` at the end of the step's iteration (after its
    log line and checkpoint).
    """
    device = torch.device(device)
    opt_cfg = AdamWConfig(
        lr=warmup_cosine(lr, warmup=max(1, steps // 20), total=steps),
        weight_decay=0.01,
        moment_dtype="float32",
    )
    step_fn = make_train_step(model, opt_cfg)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if state is None:
        state = make_train_state(model, opt_cfg, generator=torch.Generator().manual_seed(seed),
                                 device=device)

    start_step = 0
    if resume and mgr and mgr.latest_step() is not None:
        tree, manifest = mgr.restore(train_state_tree(state))
        load_train_state_tree(state, tree)
        loader.load_state(LoaderState.from_dict(manifest["loader_state"]))
        start_step = manifest["step"]
        print(f"[train] resumed at step {start_step}, loader {manifest['loader_state']}")

    it = iter(loader)
    metrics_hist = []
    t0 = time.time()
    step = start_step
    if timings is not None:
        for key in ("fetch_s", "step_s", "end"):
            timings.setdefault(key, [])
    while step < steps:
        tf = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            it = iter(loader)
            batch = next(it)
        tb = {k: torch.from_numpy(np.asarray(batch[k])).to(device) for k in ("tokens", "labels")}
        ts = time.perf_counter()
        state, metrics = step_fn(state, tb)
        if timings is not None:
            _sync(device)
            timings["fetch_s"].append(ts - tf)
            timings["step_s"].append(time.perf_counter() - ts)
        step += 1
        if step % log_every == 0 or step == steps:
            m = {k: float(v) for k, v in metrics.items()}
            metrics_hist.append({"step": step, **m})
            tput = tb["tokens"].numel() * log_every / max(1e-9, time.time() - t0)
            print(f"[train] step {step} loss={m['loss']:.4f} "
                  f"ce={m['ce_loss']:.4f} gnorm={m['grad_norm']:.2f} "
                  f"({tput:.0f} tok/s)")
            t0 = time.time()
        if mgr and (step % ckpt_every == 0 or step == steps):
            extra = {"arch": model.cfg.name, "data_spec": loader.spec.to_dict()}
            mgr.save(step, train_state_tree(state), loader_state=loader.state().to_dict(),
                     extra=extra, blocking=True)
        if crash_after is not None and step >= crash_after:
            raise RuntimeError(f"injected crash at step {step}")
        if timings is not None:
            timings["end"].append(time.perf_counter())
    return {"final_state": state, "metrics": metrics_hist, "last_step": step}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--fetch-factor", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--corpus", default=str(DEFAULT_CORPUS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg)
    loader = build_loader(
        args.corpus, args.seq, args.batch,
        block_size=args.block_size, fetch_factor=args.fetch_factor,
        vocab_size=min(cfg.vocab_size, 1024),
    )
    res = train_loop(model, loader, steps=args.steps, ckpt_dir=args.ckpt_dir,
                     resume=args.resume, lr=args.lr, device=args.device)
    print(f"[train] done at step {res['last_step']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
