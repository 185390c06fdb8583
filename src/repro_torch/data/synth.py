"""Synthetic Tahoe-100M-like dataset generator.

The port's copy of ``repro.data.synth`` (the CSR shard writer; the h5ad
writers are not ported yet).  The same seed and parameters give the same
shards, byte for byte in every array, as the JAX package's generator.

It reproduces the structure of Tahoe-100M that drives the paper's
experiments: cells stored plate by plate in 14 CSR shards of non-uniform
size; within a plate, cells grouped by condition (cell_line × drug);
plate-dependent covariate shift and class skew; labels cell_line (50), drug
(380), moa_broad (4), moa_fine (27).  Per condition c=(line, drug) on plate
p: ``probs ∝ softmax(line_logits + drug_effect + plate_effect)`` and
``counts ~ Multinomial(total_counts, probs)``.

At Tahoe's 62,710 genes pass a small ``chunk`` (256): each chunk builds a
``chunk × n_genes`` float64 probability array, 4.1 GB at the default 8192.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

from .csr_store import ShardedCSRStore, write_csr_shard

__all__ = ["generate_tahoe_like", "load_tahoe_like", "TAHOE_PLATE_FRACS"]

# Plate size fractions of paper §3.4 (min 4.7%, max 10.4%, H=3.78 bits).
TAHOE_PLATE_FRACS = np.array(
    [0.104, 0.096, 0.089, 0.083, 0.078, 0.074, 0.071, 0.068,
     0.066, 0.063, 0.058, 0.054, 0.049, 0.047]
)
TAHOE_PLATE_FRACS = TAHOE_PLATE_FRACS / TAHOE_PLATE_FRACS.sum()


def generate_tahoe_like(
    root: str,
    *,
    n_cells: int = 200_000,
    n_genes: int = 2048,
    n_plates: int = 14,
    n_cell_lines: int = 50,
    n_drugs: int = 380,
    n_moa_fine: int = 27,
    n_moa_broad: int = 4,
    total_counts: int = 64,
    plate_fracs: Optional[Sequence[float]] = None,
    seed: int = 0,
    chunk: int = 8192,
    force: bool = False,
    line_sig: float = 3.0,
    moa_scale: float = 2.0,
    drug_scale: float = 2.0,
    plate_scale: float = 1.3,
    plate_line_skew: float = 4.5,
) -> list[str]:
    """Write plate shards under ``root``; returns shard paths.

    Idempotent: if a manifest with identical parameters exists, reuse it.
    """
    os.makedirs(root, exist_ok=True)
    manifest_path = os.path.join(root, "manifest.json")
    params = dict(
        n_cells=n_cells, n_genes=n_genes, n_plates=n_plates,
        n_cell_lines=n_cell_lines, n_drugs=n_drugs, n_moa_fine=n_moa_fine,
        n_moa_broad=n_moa_broad, total_counts=total_counts, seed=seed,
        line_sig=line_sig, moa_scale=moa_scale, drug_scale=drug_scale,
        plate_scale=plate_scale, plate_line_skew=plate_line_skew,
    )
    if not force and os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
        if manifest.get("params") == params and all(
            os.path.exists(os.path.join(root, s)) for s in manifest["shards"]
        ):
            return [os.path.join(root, s) for s in manifest["shards"]]

    rng = np.random.default_rng(seed)
    fracs = np.asarray(plate_fracs if plate_fracs is not None else TAHOE_PLATE_FRACS[:n_plates])
    fracs = fracs / fracs.sum()
    plate_sizes = np.floor(fracs * n_cells).astype(np.int64)
    plate_sizes[-1] += n_cells - plate_sizes.sum()

    # cell-line identity: each line expresses a sparse signature set strongly
    line_logits = rng.normal(0.0, 0.6, size=(n_cell_lines, n_genes)).astype(np.float32)
    sig = rng.integers(0, n_genes, size=(n_cell_lines, 24))
    for c in range(n_cell_lines):
        line_logits[c, sig[c]] += line_sig
    # drug -> fine MoA -> broad MoA taxonomy
    drug_moa_fine = rng.integers(0, n_moa_fine, size=n_drugs)
    fine_to_broad = rng.integers(0, n_moa_broad, size=n_moa_fine)
    moa_dirs = rng.normal(0.0, 1.0, size=(n_moa_fine, n_genes)).astype(np.float32)
    moa_mask = rng.random((n_moa_fine, n_genes)) < 0.02
    moa_dirs = np.where(moa_mask, moa_dirs * moa_scale, 0.0).astype(np.float32)
    drug_specific = rng.normal(0.0, 1.0, size=(n_drugs, n_genes)).astype(np.float32)
    drug_mask = rng.random((n_drugs, n_genes)) < 0.01
    drug_specific = np.where(drug_mask, drug_specific * drug_scale, 0.0).astype(np.float32)
    drug_effect = (moa_dirs[drug_moa_fine] + drug_specific).astype(np.float32)
    # plate batch effects (covariate shift) and per-plate skew over lines
    plate_effect = rng.normal(0.0, plate_scale, size=(n_plates, n_genes)).astype(np.float32)
    plate_line_logits = rng.normal(0.0, plate_line_skew, size=(n_plates, n_cell_lines))
    plate_line_probs = np.exp(plate_line_logits)
    plate_line_probs /= plate_line_probs.sum(axis=1, keepdims=True)

    shard_names = []
    for p in range(n_plates):
        name = f"plate_{p:02d}"
        shard_names.append(name)
        n_p = int(plate_sizes[p])
        lines = rng.choice(n_cell_lines, size=n_p, p=plate_line_probs[p])
        drugs = rng.integers(0, n_drugs, size=n_p)
        # sort by condition so contiguous regions share metadata (Tahoe layout)
        order = np.lexsort((drugs, lines))
        lines, drugs = lines[order], drugs[order]

        data_parts, idx_parts, len_parts = [], [], []
        for lo in range(0, n_p, chunk):
            hi = min(lo + chunk, n_p)
            logits = (
                line_logits[lines[lo:hi]]
                + drug_effect[drugs[lo:hi]]
                + plate_effect[p][None, :]
            )
            logits -= logits.max(axis=1, keepdims=True)
            probs = np.exp(logits, dtype=np.float32)
            probs /= probs.sum(axis=1, keepdims=True)
            counts = _batch_multinomial(rng, total_counts, probs)
            rids, cols = np.nonzero(counts)  # row-major: CSR order
            data_parts.append(counts[rids, cols].astype(np.float32))
            idx_parts.append(cols.astype(np.int32))
            len_parts.append(np.bincount(rids, minlength=hi - lo).astype(np.int64))
        indptr = np.zeros(n_p + 1, dtype=np.int64)
        np.cumsum(np.concatenate(len_parts), out=indptr[1:])
        obs = {
            "plate": np.full(n_p, p, dtype=np.int32),
            "cell_line": lines.astype(np.int32),
            "drug": drugs.astype(np.int32),
            "moa_fine": drug_moa_fine[drugs].astype(np.int32),
            "moa_broad": fine_to_broad[drug_moa_fine[drugs]].astype(np.int32),
        }
        write_csr_shard(
            os.path.join(root, name), np.concatenate(data_parts),
            np.concatenate(idx_parts), indptr, n_genes, obs,
            extra_meta={"plate": p},
        )

    with open(manifest_path, "w") as f:
        json.dump({"params": params, "shards": shard_names}, f, indent=1)
    return [os.path.join(root, s) for s in shard_names]


def _batch_multinomial(rng: np.random.Generator, total: int, probs: np.ndarray) -> np.ndarray:
    """Row-wise multinomial draws."""
    probs = probs.astype(np.float64)
    probs = probs / probs.sum(axis=1, keepdims=True)  # guard fp drift
    return rng.multinomial(total, probs).astype(np.int32)


def load_tahoe_like(root: str, iostats=None) -> ShardedCSRStore:
    with open(os.path.join(root, "manifest.json")) as f:
        manifest = json.load(f)
    return ShardedCSRStore([os.path.join(root, s) for s in manifest["shards"]],
                           iostats=iostats)
