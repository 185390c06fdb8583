"""Linear probes on cell batches: the paper's Fig. 5 training loop on the card.

The port of the loop in ``benchmarks/bench_fig5_classification.py`` and
``examples/cell_classifier.py``: CSR batches from the loader are densified
on the batch's device with ``log1p`` applied in the same pass (the ELL
kernel's fused epilogue, through :mod:`repro_torch.kernels.ops`), and four
linear heads — cell_line 50, drug 380, moa_broad 4, moa_fine 27 — take one
Adam step on their summed mean cross-entropy.

Adam is written out, not ``torch.optim.Adam``, so that it rounds as the JAX
reference does: ``p - LR * (m / c1) / (sqrt(v / c2) + eps)`` with
``c = 1 - beta ** count`` in float32 at the 1-based count.  The moments and
the parameters are updated in place, which saves three parameter-sized
buffers per step (0.35 GB at 62,710 genes).  The products ``x @ w`` stay
``torch.matmul``; :func:`train_step` computes them and their gradients in
full float32, as the reference does, and leaves the caller's TF32 setting
as it found it (:mod:`repro_torch.precision`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional

import numpy as np
import torch
from torch import nn

from ..data.csr_store import CSRBatch
from ..distributed.dataio import device_prefetch
from ..kernels import ops
from ..precision import full_float32_matmul

__all__ = [
    "TASKS", "LR", "LinearHead", "ProbeHeads", "AdamState", "init_heads",
    "init_adam", "features", "loss_fn", "train_step", "train_probe", "macro_f1",
]

TASKS = {"cell_line": 50, "drug": 380, "moa_broad": 4, "moa_fine": 27}
LR = 1e-2
B1, B2, EPS = 0.9, 0.999, 1e-8


class LinearHead(nn.Module):
    """``x @ w + b`` with the JAX package's layout: ``w`` (n_genes, classes)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class ProbeHeads(nn.Module):
    """One :class:`LinearHead` per task of :data:`TASKS`; ``forward`` gives
    each task's logits."""

    def __init__(self, heads: dict[str, LinearHead]):
        super().__init__()
        if set(heads) != set(TASKS):
            raise ValueError(f"need one head per task {sorted(TASKS)}, got {sorted(heads)}")
        self.heads = nn.ModuleDict({t: heads[t] for t in TASKS})
        self.n_genes = int(self.heads[next(iter(TASKS))].w.shape[0])

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        return {t: h(x) for t, h in self.heads.items()}


def init_heads(
    n_genes: int, *, device="cuda", generator: Optional[torch.Generator] = None
) -> ProbeHeads:
    """Zero heads, as the reference starts; with a (CPU) ``generator``,
    weights drawn from N(0, 1/n_genes) and zero biases."""
    heads = {}
    for t, c in TASKS.items():
        if generator is None:
            w = torch.zeros((n_genes, c))
        else:
            w = torch.randn((n_genes, c), generator=generator) / float(np.sqrt(n_genes))
        heads[t] = LinearHead(w.to(device), torch.zeros((c,), device=device))
    return ProbeHeads(heads)


@dataclasses.dataclass
class AdamState:
    """Adam's moments by parameter name (``heads.<task>.w|b``) and the
    number of steps taken."""

    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]
    count: int = 0


def init_adam(heads: nn.Module) -> AdamState:
    params = dict(heads.named_parameters())
    return AdamState(
        m={n: torch.zeros_like(p) for n, p in params.items()},
        v={n: torch.zeros_like(p) for n, p in params.items()},
    )


def features(vals: torch.Tensor, cols: torch.Tensor, *, n_genes: int) -> torch.Tensor:
    """ELL batch -> ``log1p`` of its dense expression, on the batch's device."""
    return ops.ell_to_dense(vals, cols, n_cols=n_genes, log1p=True)


def loss_fn(heads: ProbeHeads, x: torch.Tensor, ys: dict[str, torch.Tensor]) -> torch.Tensor:
    """The four tasks' mean cross-entropies, summed."""
    logits = heads(x)
    total = 0.0
    for t in TASKS:
        lse = torch.logsumexp(logits[t], dim=-1)
        gold = logits[t].gather(-1, ys[t].long()[:, None])[:, 0]
        total = total + (lse - gold).mean()
    return total


def train_step(
    heads: ProbeHeads, opt: AdamState, x: torch.Tensor, ys: dict[str, torch.Tensor]
) -> torch.Tensor:
    """One Adam step of all heads on features ``x``; returns the loss
    (a 0-dim tensor, not yet read back from the device)."""
    params = dict(heads.named_parameters())
    with full_float32_matmul():
        loss = loss_fn(heads, x, ys)
        grads = torch.autograd.grad(loss, list(params.values()))
    opt.count += 1
    cnt = torch.tensor(float(opt.count), dtype=torch.float32)
    c1 = float(1 - torch.tensor(B1, dtype=torch.float32) ** cnt)
    c2 = float(1 - torch.tensor(B2, dtype=torch.float32) ** cnt)
    with torch.no_grad():
        for (name, p), g in zip(params.items(), grads):
            m = opt.m[name].mul_(B1).add_(g, alpha=1 - B1)
            v = opt.v[name].mul_(B2).addcmul_(g, g, value=1 - B2)
            p.sub_((m / c1).mul_(LR).div_((v / c2).sqrt_().add_(EPS)))
    return loss.detach()


def train_probe(
    batches: Iterable[CSRBatch],
    heads: ProbeHeads,
    opt: AdamState,
    *,
    device="cuda",
    max_steps: Optional[int] = None,
) -> dict:
    """Train the heads on ``batches`` (one epoch of a loader) through the
    two-deep device feed; stop early after ``max_steps``.

    Returns ``losses`` (one float per step, read back once at the end),
    ``steps``, ``seconds`` (wall, ending in a synchronise), ``loader_wait_s``
    (host time blocked on the next batch: fetch, collation, copy issue) and,
    on a card, ``step_stream_ms``: each step's span on the stream, from CUDA
    events before its first kernel and after its last, which includes any
    time the stream waits for the host to launch the next kernel.
    """
    device = torch.device(device)
    on_card = device.type == "cuda"
    losses, marks = [], []
    wait = 0.0
    feed = device_prefetch(batches, device)
    t0 = time.perf_counter()
    while max_steps is None or len(losses) < max_steps:
        tw = time.perf_counter()
        b = next(feed, None)
        wait += time.perf_counter() - tw
        if b is None:
            break
        if on_card:
            marks.append((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)))
            marks[-1][0].record()
        x = features(b["vals"], b["cols"], n_genes=heads.n_genes)
        losses.append(train_step(heads, opt, x, b["obs"]))
        if on_card:
            marks[-1][1].record()
    feed.close()
    out = {"losses": torch.stack(losses).tolist() if losses else []}  # synchronises
    if on_card:
        torch.cuda.synchronize(device)
        out["step_stream_ms"] = [s.elapsed_time(e) for s, e in marks]
    out.update(steps=len(losses), seconds=time.perf_counter() - t0, loader_wait_s=wait)
    return out


def macro_f1(pred: np.ndarray, gold: np.ndarray, n_classes: int) -> float:
    """Macro-F1 over the classes present in ``gold`` or ``pred``."""
    f1s = []
    for c in range(n_classes):
        tp = np.sum((pred == c) & (gold == c))
        fp = np.sum((pred == c) & (gold != c))
        fn = np.sum((pred != c) & (gold == c))
        if tp + fp + fn == 0:
            continue  # class absent from test and predictions
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn, 1)
        f1s.append(0.0 if prec + rec == 0 else 2 * prec * rec / (prec + rec))
    return float(np.mean(f1s)) if f1s else 0.0
