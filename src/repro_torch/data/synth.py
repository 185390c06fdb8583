"""Synthetic Tahoe-100M-like dataset generator.

The port's copy of ``repro.data.synth``: the CSR shard generator and the
h5ad writers.  The same seed and parameters give the same shards, byte for
byte in every array, as the JAX package's generator, and the same ``.h5ad``
files, byte for byte, as its writers.

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

from .csr_store import CSRStore, ShardedCSRStore, write_csr_shard

__all__ = [
    "generate_tahoe_like", "load_tahoe_like", "write_h5ad", "csr_shard_to_h5ad",
    "generate_h5ad_like", "generate_sharded_h5ad_like", "export_sharded_h5ad",
    "TAHOE_PLATE_FRACS",
]

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


# ------------------------------------------------------------------- h5ad
def write_h5ad(
    path: str,
    data: np.ndarray,
    indices: np.ndarray,
    indptr: np.ndarray,
    n_var: int,
    obs: Optional[dict] = None,
    extra_x_attrs: Optional[dict] = None,
) -> None:
    """Write an AnnData ``.h5ad`` file from raw CSR arrays through the
    pure-Python writer of :mod:`repro_torch.data.h5shim` (no h5py).

    The layout is h5ad's CSR encoding: ``X/data|indices|indptr`` with
    ``encoding-type='csr_matrix'`` and ``shape`` attributes, one dataset per
    ``obs`` column plus an integer ``_index``, and a ``var`` group whose
    ``_index`` carries ``n_var``.  h5py and anndata open it natively.
    """
    from .h5shim import GroupSpec, write_shim_file

    indptr = np.asarray(indptr, dtype=np.int64)
    n_obs = len(indptr) - 1
    obs = {k: np.asarray(v) for k, v in (obs or {}).items()}
    for k, v in obs.items():
        if len(v) != n_obs:
            raise ValueError(f"obs column {k!r} has {len(v)} rows, X has {n_obs}")
    df_attrs = {"encoding-type": "dataframe", "encoding-version": "0.2.0", "_index": "_index"}
    root = GroupSpec(
        children={
            "X": GroupSpec(
                children={
                    "data": np.asarray(data, dtype=np.float32),
                    "indices": np.asarray(indices, dtype=np.int32),
                    "indptr": indptr,
                },
                attrs={
                    "encoding-type": "csr_matrix",
                    "encoding-version": "0.1.0",
                    "shape": np.array([n_obs, int(n_var)], dtype=np.int64),
                    **(extra_x_attrs or {}),
                },
            ),
            "obs": GroupSpec(children={"_index": np.arange(n_obs, dtype=np.int64), **obs},
                             attrs=df_attrs),
            "var": GroupSpec(children={"_index": np.arange(int(n_var), dtype=np.int64)},
                             attrs=df_attrs),
        },
        attrs={"encoding-type": "anndata", "encoding-version": "0.1.0"},
    )
    write_shim_file(path, root)


def csr_shard_to_h5ad(shard_path: str, h5ad_path: str) -> str:
    """Export one CSR shard (``write_csr_shard``'s layout) to ``.h5ad``: the
    same rows, values and obs columns, so both formats read back bitwise
    equal batches."""
    store = CSRStore(shard_path)
    write_h5ad(h5ad_path, np.asarray(store._data), np.asarray(store._indices), store._indptr,
               store.n_var, obs=store.obs)
    return h5ad_path


def generate_sharded_h5ad_like(
    root: str,
    *,
    n_cells: int = 20_000,
    n_genes: int = 512,
    n_plates: int = 4,
    seed: int = 0,
    **gen_kwargs,
) -> str:
    """A ``sharded-h5ad://`` dataset: Tahoe-like plate shards (generated
    under ``root + ".csr"``) exported as one ``.h5ad`` file each, and a
    ``manifest.json`` listing them.  Returns ``root``.  Reuses the CSR
    shards, and rewrites an ``.h5ad`` file only when its shard is newer."""
    shards = generate_tahoe_like(
        root=root + ".csr", n_cells=n_cells, n_genes=n_genes, n_plates=n_plates,
        plate_fracs=TAHOE_PLATE_FRACS[:n_plates], seed=seed, **gen_kwargs,
    )
    export_sharded_h5ad(shards, root)
    return root


def export_sharded_h5ad(shard_paths: Sequence[str], root: str) -> list[str]:
    """Export CSR shards as one ``<shard>.h5ad`` file each under ``root``
    and write the ``manifest.json`` that lists them (``sharded-h5ad://``'s
    layout).  A file newer than its shard is kept.  Returns the files."""
    os.makedirs(root, exist_ok=True)
    names = []
    for shard in shard_paths:
        name = os.path.basename(shard) + ".h5ad"
        names.append(name)
        out = os.path.join(root, name)
        src_marker = os.path.join(shard, "meta.json")
        if not os.path.exists(out) or os.path.getmtime(out) < os.path.getmtime(src_marker):
            csr_shard_to_h5ad(shard, out)
    with open(os.path.join(root, "manifest.json"), "w") as f:
        json.dump({"shards": names}, f, indent=1)
    return [os.path.join(root, n) for n in names]


def generate_h5ad_like(
    path: str,
    *,
    n_cells: int = 20_000,
    n_genes: int = 512,
    seed: int = 0,
    **gen_kwargs,
) -> str:
    """One Tahoe-like ``.h5ad`` file: a single-plate dataset (generated under
    ``path + ".shards"``) exported to ``path``.  Reuses the shard, and
    rewrites the file only when the shard is newer."""
    root = path + ".shards"
    shards = generate_tahoe_like(root, n_cells=n_cells, n_genes=n_genes, n_plates=1,
                                 plate_fracs=[1.0], seed=seed, **gen_kwargs)
    if not os.path.exists(path) or os.path.getmtime(path) < os.path.getmtime(
        os.path.join(root, "manifest.json")
    ):
        csr_shard_to_h5ad(shards[0], path)
    return path
