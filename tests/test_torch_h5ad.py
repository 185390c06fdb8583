"""The port's h5ad layer (``repro_torch.data.h5shim``, ``repro_torch.data.h5ad``
and the h5ad writers of ``repro_torch.data.synth``) against the JAX
package's, on the CPU, the counterpart of ``tests/test_h5ad_backend.py``.

- The writers emit the reference's bytes for the same inputs.
- Each package reads the other's files bitwise (batches, obs, schema,
  ``n_var``), under the shim and, where h5py imports, under h5py, h5py's own
  files (contiguous, chunked with gzip and shuffle, vlen strings,
  categorical obs) included.
- Bad drivers, missing files, non-CSR encodings, non-HDF5 files and the
  HDF5 features outside the shim are refused as the reference refuses them.
- ``sharded-h5ad://`` through the planner gives the reference's plans,
  batches and counters at ``(io_workers, readahead)`` (1, 0), (4, 0) and
  (2, 1); a 2-plate ``Pipeline`` epoch gives the reference's batch order,
  and the probe's CPU losses over it equal its losses over the CSR twin.

Fixed inputs, made from seeds with numpy; no timing is asserted."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro.core import BlockShuffling as RefBlockShuffling
from repro.core import ScDataset
from repro.data import h5shim as ref_shim
from repro.data import open_collection as ref_open
from repro.data import synth as ref_synth
from repro.data.backend import _sniff_scheme as ref_sniff
from repro.pipeline import Pipeline as RefPipeline
from repro_torch.core import BlockShuffling, ScIterableDataset
from repro_torch.data import h5shim, synth
from repro_torch.data import open_collection as port_open
from repro_torch.data.backend import _sniff_scheme
from repro_torch.data.h5ad import _HAVE_H5PY
from repro_torch.pipeline import Pipeline
from repro_torch.train import probe

DRIVERS = ("shim", "h5py") if _HAVE_H5PY else ("shim",)
needs_h5py = pytest.mark.skipif(not _HAVE_H5PY, reason="h5py not installed")
COUNTERS = ("calls", "runs", "rows", "bytes_read", "cache_hits", "cache_misses",
            "adm_bypassed", "adm_rejected", "prefetched")


def _random_csr(rng, n, g, max_len=9):
    lens = rng.integers(0, max_len, n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    indices = np.concatenate([np.sort(rng.choice(g, int(k), replace=False)) for k in lens]
                             ).astype(np.int32)
    return rng.normal(size=int(indptr[-1])).astype(np.float32), indices, indptr


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def assert_same_batch(a, b):
    """Two CSR batches (either package's) bitwise equal, dtypes included."""
    assert a.n_var == b.n_var
    for f in ("data", "indices", "indptr"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert sorted(a.obs) == sorted(b.obs)
    for k in a.obs:
        assert a.obs[k].dtype == b.obs[k].dtype and np.array_equal(a.obs[k], b.obs[k]), k


def _fetches(n, seed):
    rng = np.random.default_rng(seed)
    return [np.arange(n // 4, n // 2), rng.integers(0, n, 120), np.array([n - 1, 0, 5, 5]),
            np.arange(n)]


def _obs_sets(n):
    rng = np.random.default_rng(11)
    return [
        {},
        {"cell_line": rng.integers(0, 7, n).astype(np.int32),
         "plate": rng.integers(0, 3, n).astype(np.int64)},
        {"depth": rng.normal(size=n).astype(np.float64), "flag": (rng.random(n) > 0.5).astype(np.uint8),
         "name": np.array([f"c{i}" for i in range(n)])},
    ]


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    """The same cells as a reference-written and a port-written ``.h5ad``
    (byte-equal, checked below) and as a CSR shard."""
    rng = np.random.default_rng(42)
    n, g = 400, 64
    data, indices, indptr = _random_csr(rng, n, g)
    obs = {"cell_line": rng.integers(0, 7, n).astype(np.int32),
           "plate": rng.integers(0, 3, n).astype(np.int32)}
    root = tmp_path_factory.mktemp("h5ad_twin")
    paths = {"ref": str(root / "ref.h5ad"), "port": str(root / "port.h5ad"),
             "shard": str(root / "shard")}
    ref_synth.write_h5ad(paths["ref"], data, indices, indptr, g, obs)
    synth.write_h5ad(paths["port"], data, indices, indptr, g, obs)
    ref_synth.write_csr_shard(paths["shard"], data, indices, indptr, g, obs)
    return paths, n, g


@pytest.fixture(scope="module")
def plates(tmp_path_factory):
    """A 2-plate ``sharded-h5ad://`` dataset from each package's generator,
    over Tahoe-like CSR twins."""
    base = tmp_path_factory.mktemp("plates")
    kw = dict(n_cells=1200, n_genes=48, n_plates=2, seed=5, total_counts=48, chunk=256)
    ref_root = ref_synth.generate_sharded_h5ad_like(str(base / "ref"), **kw)
    port_root = synth.generate_sharded_h5ad_like(str(base / "port"), **kw)
    return ref_root, port_root


# ----------------------------------------------------------------- writers
@pytest.mark.parametrize("which", range(3))
def test_write_h5ad_bytes_equal_the_reference(tmp_path, which):
    rng = np.random.default_rng(which)
    n, g = 90 + which, 33
    data, indices, indptr = _random_csr(rng, n, g)
    obs = _obs_sets(n)[which]
    extra = {"note": "port", "scale": np.array([1.5, 2.5])} if which == 2 else None
    a, b = str(tmp_path / "a.h5ad"), str(tmp_path / "b.h5ad")
    ref_synth.write_h5ad(a, data, indices, indptr, g, obs, extra_x_attrs=extra)
    synth.write_h5ad(b, data, indices, indptr, g, obs, extra_x_attrs=extra)
    assert _bytes(a) == _bytes(b)
    synth.write_h5ad(b, data, indices, indptr, g, obs, extra_x_attrs=extra)
    assert _bytes(a) == _bytes(b)  # deterministic: no time stamp
    with pytest.raises(ValueError, match="rows"):
        synth.write_h5ad(b, data, indices, indptr, g, {"short": np.zeros(n - 1)})


def _shim_tree(mod):
    rng = np.random.default_rng(3)
    cats = np.array(["T cell", "B cell", "NK"])
    codes = rng.integers(-1, 3, 50).astype(np.int8)
    return mod.GroupSpec(
        children={
            "wide": mod.GroupSpec(children={f"c{i:03d}": np.full(5, i, np.int64) for i in range(30)}),
            "dt": mod.GroupSpec(children={
                "f32": np.arange(20, dtype=np.float32), "f64": np.arange(20.0) * 0.5,
                "i8": np.arange(20, dtype=np.int8), "u16": np.arange(20, dtype=np.uint16),
                "s": np.array([b"ab", b"cde"]), "m": np.arange(12, dtype=np.int32).reshape(3, 4)}),
            "obs": mod.GroupSpec(children={
                "cell_name": np.array([f"cell{i}" for i in range(50)]),
                "cell_type": mod.GroupSpec(children={"codes": codes, "categories": cats},
                                           attrs={"encoding-type": "categorical"}),
            }),
            "empty": mod.GroupSpec(),
        },
        attrs={"title": "x", "n": 7, "v": np.array([1.0, 2.0], np.float32),
               "i": np.array([1, 2], np.int32)},
    )


def test_write_shim_file_bytes_equal_the_reference(tmp_path):
    a, b = str(tmp_path / "a.h5"), str(tmp_path / "b.h5")
    ref_shim.write_shim_file(a, _shim_tree(ref_shim))
    h5shim.write_shim_file(b, _shim_tree(h5shim))
    assert _bytes(a) == _bytes(b)
    for bad in ({"u": np.array(["x"])}, ):  # unicode attributes are refused alike
        with pytest.raises(NotImplementedError) as ea:
            ref_shim.write_shim_file(a, ref_shim.GroupSpec(attrs=bad))
        with pytest.raises(NotImplementedError) as eb:
            h5shim.write_shim_file(b, h5shim.GroupSpec(attrs=bad))
        assert str(ea.value) == str(eb.value)


def test_generated_h5ad_files_equal_the_reference(plates, tmp_path):
    ref_root, port_root = plates
    with open(os.path.join(ref_root, "manifest.json")) as f, \
            open(os.path.join(port_root, "manifest.json")) as g:
        assert json.load(f) == json.load(g)
    names = json.load(open(os.path.join(ref_root, "manifest.json")))["shards"]
    assert len(names) == 2
    for name in names:
        assert _bytes(os.path.join(ref_root, name)) == _bytes(os.path.join(port_root, name))
    a = ref_synth.generate_h5ad_like(str(tmp_path / "a.h5ad"), n_cells=300, n_genes=24, seed=1,
                                     chunk=128)
    b = synth.generate_h5ad_like(str(tmp_path / "b.h5ad"), n_cells=300, n_genes=24, seed=1,
                                 chunk=128)
    assert _bytes(a) == _bytes(b)
    shard = os.path.join(ref_root + ".csr", os.path.splitext(names[0])[0])
    c = synth.csr_shard_to_h5ad(shard, str(tmp_path / "c.h5ad"))
    assert _bytes(c) == _bytes(os.path.join(ref_root, names[0]))


# ----------------------------------------------------------------- readers
@pytest.mark.parametrize("driver", DRIVERS)
def test_each_package_reads_the_others_files(twin, driver):
    paths, n, g = twin
    assert _bytes(paths["ref"]) == _bytes(paths["port"])
    csr = port_open(f"csr://{paths['shard']}", cache_bytes=0)
    for ours, theirs in (("port", "ref"), ("ref", "port")):
        a = ref_open(f"h5ad://{paths[ours]}?driver={driver}", cache_bytes=0)
        b = port_open(f"h5ad://{paths[theirs]}?driver={driver}", cache_bytes=0)
        assert len(a) == len(b) == n
        assert a.schema == b.schema and b.schema["n_var"] == g and b.schema["driver"] == driver
        assert a.obs_keys() == b.obs_keys() == sorted(csr.obs_keys())
        for k in a.obs_keys():
            x, y = a.obs_column(k), b.obs_column(k)
            assert x.dtype == y.dtype and np.array_equal(x, y)
        for rows in _fetches(n, 0):
            got = b.fetch(rows)
            assert_same_batch(a.fetch(rows), got)
            assert_same_batch(csr.fetch(rows), got)
            assert a.nbytes_of(rows) == b.nbytes_of(rows) == csr.nbytes_of(rows)
        assert a.avg_row_bytes == b.avg_row_bytes
        a.release()
        b.release()


def _h5py_file(path, rng, layout):
    """An h5ad file written by h5py: ``contiguous``, ``chunked`` (gzip and
    shuffle) or ``labels`` (vlen-string and categorical obs)."""
    import h5py

    n, g = 150, 40
    data, indices, indptr = _random_csr(rng, n, g)
    with h5py.File(path, "w") as f:
        X = f.create_group("X")
        if layout == "chunked":
            X.create_dataset("data", data=data, chunks=(50,), compression="gzip", shuffle=True)
            X.create_dataset("indices", data=indices, chunks=(64,), compression="gzip",
                             shuffle=True)
            X.create_dataset("indptr", data=indptr, chunks=(32,), compression="gzip")
        else:
            X.create_dataset("data", data=data)
            X.create_dataset("indices", data=indices)
            X.create_dataset("indptr", data=indptr)
        X.attrs["shape"] = np.array([n, g], dtype=np.int64)
        X.attrs["encoding-type"] = "csr_matrix"
        obs = f.create_group("obs")
        obs.create_dataset("lab", data=rng.integers(0, 4, n).astype(np.int32))
        if layout == "labels":
            obs.create_dataset("sample", data=np.array([f"s{i % 7}" for i in range(n)], dtype=object),
                               dtype=h5py.string_dtype())
            ct = obs.create_group("treatment")
            codes = rng.integers(-1, 3, n).astype(np.int8)
            ct.create_dataset("codes", data=codes)
            ct.create_dataset("categories", data=np.array(["ctrl", "drugA", "drugB"], dtype=object),
                              dtype=h5py.string_dtype())
            ct.attrs["encoding-type"] = "categorical"
    return n


@needs_h5py
@pytest.mark.parametrize("layout", ["contiguous", "chunked", "labels"])
def test_h5py_written_files_read_alike(tmp_path, layout):
    p = str(tmp_path / f"{layout}.h5ad")
    rng = np.random.default_rng(5)
    n = _h5py_file(p, rng, layout)
    cols = {}
    for driver in ("shim", "h5py"):
        a = ref_open(f"h5ad://{p}?driver={driver}", cache_bytes=0)
        b = port_open(f"h5ad://{p}?driver={driver}", cache_bytes=0)
        assert a.schema == b.schema
        for k in a.obs_keys():
            x, y = a.obs_column(k), b.obs_column(k)
            assert x.dtype == y.dtype and np.array_equal(x, y), k
        cols[driver] = {k: b.obs_column(k) for k in b.obs_keys()}
        for rows in _fetches(n, 1):
            assert_same_batch(a.fetch(rows), b.fetch(rows))
        a.release()
        b.release()
    assert sorted(cols["shim"]) == sorted(cols["h5py"])
    for k in cols["shim"]:
        assert np.array_equal(cols["shim"][k], cols["h5py"][k]), k
    if layout == "labels":
        assert cols["shim"]["treatment"].dtype.kind == "U" and "" in set(cols["shim"]["treatment"])


# ---------------------------------------------------------------- refusals
def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the refusal itself is compared
        return type(e).__name__, str(e)
    return None


def _refusal_cases(tmp_path):
    noise = tmp_path / "noise.bin"
    noise.write_bytes(b"not an hdf5 file at all")
    dense = str(tmp_path / "dense.h5ad")
    ref_shim.write_shim_file(dense, ref_shim.GroupSpec(children={
        "X": ref_shim.GroupSpec(children={"data": np.zeros(4, np.float32),
                                          "indices": np.zeros(4, np.int32),
                                          "indptr": np.array([0, 2, 4], np.int64)},
                                attrs={"encoding-type": "array",
                                       "shape": np.array([2, 8], np.int64)})}))
    no_nvar = str(tmp_path / "no_nvar.h5ad")
    ref_shim.write_shim_file(no_nvar, ref_shim.GroupSpec(children={
        "X": ref_shim.GroupSpec(children={"data": np.zeros(2, np.float32),
                                          "indices": np.zeros(2, np.int32),
                                          "indptr": np.array([0, 2], np.int64)})}))
    twin_dir = tmp_path / "twins"
    twin_dir.mkdir()
    ref_synth.write_h5ad(str(twin_dir / "a.h5ad"), np.zeros(1, np.float32), np.zeros(1, np.int32),
                         np.array([0, 1]), 8)
    ref_synth.write_h5ad(str(twin_dir / "b.h5ad"), np.zeros(1, np.float32), np.zeros(1, np.int32),
                         np.array([0, 1]), 9)
    return {
        "bad_driver": f"h5ad://{dense}?driver=zarr",
        "missing": "h5ad:///nonexistent/never.h5ad",
        "missing_shard": f"sharded-h5ad://{tmp_path}/nope.h5ad,{tmp_path}/nope2.h5ad",
        "non_csr": f"h5ad://{dense}?driver=shim",
        "no_n_var": f"h5ad://{no_nvar}?driver=shim",
        "n_var_disagree": f"sharded-h5ad://{twin_dir / 'a.h5ad'},{twin_dir / 'b.h5ad'}",
        "non_hdf5_sniff": str(noise),
        "non_hdf5_forced": f"h5ad://{noise}?driver=shim",
        "unknown_opt": f"h5ad://{dense}?bogus=1",
    }


@pytest.mark.parametrize("case", ["bad_driver", "missing", "missing_shard", "non_csr", "no_n_var",
                                  "n_var_disagree", "non_hdf5_sniff", "non_hdf5_forced",
                                  "unknown_opt"])
def test_refusals_equal_the_reference(tmp_path, case):
    uri = _refusal_cases(tmp_path)[case]
    want = _raised(lambda: ref_open(uri))
    assert want is not None
    assert _raised(lambda: port_open(uri)) == want


def test_shim_refuses_what_it_does_not_read_as_the_reference(tmp_path):
    """The HDF5 corners outside the shim raise the reference's errors."""
    cases = []
    p = tmp_path / "zeros.h5"
    p.write_bytes(b"\x00" * 200)
    cases.append(lambda m: m.ShimFile(str(p)))
    if _HAVE_H5PY:
        import h5py

        latest, track, odd = (str(tmp_path / f) for f in ("latest.h5", "track.h5", "odd.h5"))
        with h5py.File(latest, "w", libver="latest") as f:
            f.create_dataset("a", data=np.arange(4))
        with h5py.File(track, "w", track_order=True) as f:
            f.create_group("obs").create_dataset("a", data=np.arange(4))
        with h5py.File(odd, "w") as f:
            f.create_dataset("c", data=np.zeros(3, dtype=[("a", "i4"), ("b", "f4")]))
            f.create_dataset("nd", data=np.zeros((8, 4), "f4"), chunks=(2, 4))
            f.create_dataset("vl2", data=np.array([["a", "b"]], dtype=object),
                             dtype=h5py.string_dtype())
        cases += [lambda m: m.ShimFile(latest),
                  lambda m: m.ShimFile(track).keys("obs"),
                  lambda m: m.ShimFile(odd).dataset("c"),
                  lambda m: m.ShimFile(odd).dataset("nd")[0:2],
                  lambda m: m.ShimFile(odd).dataset("vl2")[0:1],
                  lambda m: m.ShimFile(odd).dataset("missing")]
    for case in cases:
        want = _raised(lambda: case(ref_shim))
        assert want is not None
        assert _raised(lambda: case(h5shim)) == want


def test_sniffing_equals_the_reference(twin, plates, tmp_path):
    paths, n, _ = twin
    plain = str(tmp_path / "cells.bin")
    shutil.copyfile(paths["port"], plain)
    for path in (paths["port"], plain, plates[1], paths["shard"]):
        assert _sniff_scheme(path) == ref_sniff(path)
    assert _sniff_scheme(plain) == "h5ad" and _sniff_scheme(plates[1]) == "sharded-h5ad"
    assert len(port_open(plain)) == len(port_open(paths["port"])) == n
    assert port_open(plates[1]).schema == ref_open(plates[0]).schema
    manifest = os.path.join(plates[1], "manifest.json")
    assert port_open(f"sharded-h5ad://{manifest}").schema == ref_open(plates[0]).schema


# ----------------------------------------------------------------- planner
@pytest.mark.parametrize("io_workers,readahead", [(1, 0), (4, 0), (2, 1)])
def test_planned_sharded_h5ad_equals_the_reference(plates, io_workers, readahead):
    ref_root, port_root = plates
    kw = dict(cache_bytes=1 << 20, block_rows=32, max_extent_rows=64, io_workers=io_workers,
              readahead=readahead)
    a = ref_open(f"sharded-h5ad://{ref_root}?driver=shim", **kw)
    b = port_open(f"sharded-h5ad://{port_root}?driver=shim", **kw)
    assert a.schema == b.schema and a.schema["n_shards"] == 2
    ra = ScDataset(a, RefBlockShuffling(8), batch_size=32, fetch_factor=4, seed=3)
    rb = ScIterableDataset(b, BlockShuffling(8), batch_size=32, fetch_factor=4, seed=3)
    order = rb._epoch_order(0)
    for gid in range(rb._global_fetch_count()):
        rows = np.sort(order[gid * rb.fetch_size:(gid + 1) * rb.fetch_size])
        assert np.array_equal(a.plan(rows), b.plan(rows)), gid
    want, got = list(ra), list(rb)
    assert len(want) == len(got) > 0
    for x, y in zip(want, got):
        assert_same_batch(x, y)
    a.close()
    b.close()
    sa, sb = a.iostats.snapshot(), b.iostats.snapshot()
    assert {k: sa[k] for k in COUNTERS} == {k: sb[k] for k in COUNTERS}
    assert sb["prefetched"] > 0 if readahead else sb["prefetched"] == 0
    a.release()
    b.release()


# ------------------------------------------------------------------- slice
def _pipe(mod, root, **kw):
    return (mod.from_uri(f"sharded-h5ad://{root}", driver="shim", block_rows=8, **kw)
            .strategy("block", block_size=8).batch(32, fetch_factor=4).seed(3).build())


def test_pipeline_epoch_and_probe_losses(plates):
    """A 2-plate ``sharded-h5ad://`` epoch: the reference's batch order,
    bitwise; the probe's CPU losses equal its losses over the CSR twin."""
    ref_root, port_root = plates
    ref_pipe, pipe = _pipe(RefPipeline, ref_root), _pipe(Pipeline, port_root)
    assert pipe.spec.to_dict() == {**ref_pipe.spec.to_dict(), "uri": pipe.spec.uri}
    want, got = list(ref_pipe), list(pipe)
    assert len(want) == len(got) == len(pipe) > 0
    for x, y in zip(want, got):
        assert_same_batch(x, y)
    csr = (Pipeline.from_uri(f"sharded-csr://{port_root}.csr", block_rows=8)
           .strategy("block", block_size=8).batch(32, fetch_factor=4).seed(3).build())
    pipe.set_epoch(0)
    losses = []
    for loader in (pipe, csr):
        heads = probe.init_heads(48, device="cpu", generator=torch.Generator().manual_seed(0))
        run = probe.train_probe(loader, heads, probe.init_adam(heads), device="cpu")
        losses.append(run["losses"])
    assert len(losses[0]) == len(got) and losses[0] == losses[1]
    assert all(np.isfinite(losses[0]))
    for p in (ref_pipe, pipe, csr):
        p.close()
