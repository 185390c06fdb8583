"""The port's loader against the JAX package's, on the CPU: sampling orders,
generated shards, batches, worker and rank splits, resumption and
``LoaderState`` JSON must all be bitwise equal."""
import json
import os
import zipfile

import numpy as np
import pytest
import torch
from torch.utils.data import DataLoader

from repro.core import sampling as ref_sampling
from repro.core.dataset import ScDataset
from repro.data import synth as ref_synth
from repro.data.csr_store import CSRStore as RefCSRStore
from repro_torch.core import sampling
from repro_torch.core.dataset import LoaderState, ScIterableDataset
from repro_torch.data import synth
from repro_torch.data.csr_store import CSRStore
from repro_torch.distributed.dataio import device_prefetch

GEN = dict(n_cells=1500, n_genes=64, n_plates=4, total_counts=64, seed=3, chunk=128)
SHARD_FILES = ("data.npy", "indices.npy", "indptr.npy", "meta.json")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("tahoe")
    ref_root, port_root = str(base / "repro"), str(base / "port")
    ref_synth.generate_tahoe_like(ref_root, **GEN)
    synth.generate_tahoe_like(port_root, **GEN)
    return ref_root, port_root


@pytest.fixture(scope="module")
def stores(roots):
    return ref_synth.load_tahoe_like(roots[0]), synth.load_tahoe_like(roots[1])


# ----------------------------------------------------------------- sampling
def _strategy_pair(name, n):
    rng = np.random.default_rng(n)
    weights, labels = rng.random(n), rng.integers(0, 5, n)
    make = {
        "streaming": lambda m: m.Streaming(),
        "shuffle_buffer": lambda m: m.Streaming(shuffle_buffer=7),
        "block16": lambda m: m.BlockShuffling(16),
        "block5": lambda m: m.BlockShuffling(5),
        "random": lambda m: m.BlockShuffling(1),
        "weighted": lambda m: m.BlockWeightedSampling(4, weights=weights),
        "class_balanced": lambda m: m.ClassBalancedSampling(3, labels=labels),
    }[name]
    return make(ref_sampling), make(sampling)


@pytest.mark.parametrize("n", [1, 37, 1000])
@pytest.mark.parametrize("name", [
    "streaming", "shuffle_buffer", "block16", "block5", "random", "weighted",
    "class_balanced",
])
def test_sampling_orders_bitwise(name, n):
    ref, port = _strategy_pair(name, n)
    for seed in (0, 7):
        for epoch in (0, 3):
            want = ref.epoch_indices(n, seed, epoch)
            got = port.epoch_indices(n, seed, epoch)
            assert got.dtype == want.dtype and np.array_equal(got, want)
    assert port.epoch_len(n) == ref.epoch_len(n)


# ----------------------------------------------------------------- shards
def test_generated_shards_byte_identical(roots):
    ref_root, port_root = roots
    for name in ("manifest.json",):
        with open(os.path.join(ref_root, name), "rb") as a, open(os.path.join(port_root, name), "rb") as b:
            assert a.read() == b.read()
    shards = sorted(d for d in os.listdir(ref_root) if d.startswith("plate_"))
    assert shards == sorted(d for d in os.listdir(port_root) if d.startswith("plate_"))
    assert len(shards) == GEN["n_plates"]
    for s in shards:
        for f in SHARD_FILES:
            with open(os.path.join(ref_root, s, f), "rb") as a, open(os.path.join(port_root, s, f), "rb") as b:
                assert a.read() == b.read(), (s, f)
        # obs.npz is a zip whose member headers carry the write time: its
        # members' bytes are what must agree
        with zipfile.ZipFile(os.path.join(ref_root, s, "obs.npz")) as a, \
                zipfile.ZipFile(os.path.join(port_root, s, "obs.npz")) as b:
            assert a.namelist() == b.namelist()
            for member in a.namelist():
                assert a.read(member) == b.read(member), (s, member)


def test_store_reads_and_counters_match(roots):
    ref = RefCSRStore(os.path.join(roots[0], "plate_00"))
    port = CSRStore(os.path.join(roots[1], "plate_00"))
    rows = np.array([5, 3, 4, 90, 91, 3, 17])  # unsorted, repeated, three runs
    a, b = ref[rows], port[rows]
    _assert_batch_equal(a, b)
    want = ref.iostats.snapshot()
    assert port.iostats.snapshot().keys() <= want.keys()
    for k in ("calls", "runs", "rows", "bytes_read"):
        assert port.iostats.snapshot()[k] == want[k], k


# ----------------------------------------------------------------- batches
def _assert_batch_equal(a, b):
    for f in ("data", "indices", "indptr"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.n_var == b.n_var
    assert a.obs.keys() == b.obs.keys()
    for k in a.obs:
        assert a.obs[k].dtype == b.obs[k].dtype and np.array_equal(a.obs[k], b.obs[k]), k


def _batch_key(b) -> bytes:
    return b"|".join(
        [b.data.tobytes(), b.indices.tobytes(), b.indptr.tobytes()]
        + [b.obs[k].tobytes() for k in sorted(b.obs)]
    )


LOADER = dict(batch_size=32, fetch_factor=4, seed=11)


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("rank,world", [(0, 1), (0, 2), (1, 2), (2, 3)])
def test_batches_bitwise_across_ranks(stores, rank, world, drop_last):
    ref = ScDataset(stores[0], ref_sampling.BlockShuffling(16), rank=rank,
                    world_size=world, drop_last=drop_last, **LOADER)
    port = ScIterableDataset(stores[1], sampling.BlockShuffling(16), rank=rank,
                             world_size=world, drop_last=drop_last, **LOADER)
    assert len(port) == len(ref)
    want, got = list(ref.epochs(2)), list(port.epochs(2))
    assert len(got) == len(want) > 0
    for a, b in zip(want, got):
        _assert_batch_equal(a, b)
    assert json.dumps(port.state().to_dict()) == json.dumps(ref.state().to_dict())


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2)])
def test_dataloader_workers_union_is_the_stream(stores, rank, world):
    ref = ScDataset(stores[0], ref_sampling.BlockShuffling(16), rank=rank,
                    world_size=world, **LOADER)
    port = ScIterableDataset(stores[1], sampling.BlockShuffling(16), rank=rank,
                             world_size=world, **LOADER)
    loader = DataLoader(port, batch_size=None, num_workers=2,
                        multiprocessing_context="spawn")
    got = [_batch_key(b) for b in loader]
    want = [_batch_key(b) for b in ref]
    assert len(got) == len(want) == len(port)
    assert sorted(got) == sorted(want)


def test_mid_epoch_resume_continues_the_stream(stores):
    ref = ScDataset(stores[0], ref_sampling.BlockShuffling(16), **LOADER)
    port = ScIterableDataset(stores[1], sampling.BlockShuffling(16), **LOADER)
    ref_it, port_it = iter(ref), iter(port)
    for _ in range(6):  # stops inside the second fetch
        _assert_batch_equal(next(ref_it), next(port_it))
    blob = json.dumps(port.state().to_dict())
    assert blob == json.dumps(ref.state().to_dict())
    assert port.state().batch_cursor == 2

    resumed = ScIterableDataset(stores[1], sampling.BlockShuffling(16), **LOADER)
    resumed.load_state(LoaderState.from_dict(json.loads(blob)))
    rest = list(resumed)
    want = list(ref_it)
    assert len(rest) == len(want) > 0
    for a, b in zip(want, rest):
        _assert_batch_equal(a, b)
    assert json.dumps(resumed.state().to_dict()) == json.dumps(ref.state().to_dict())


def test_resume_under_workers_and_another_world(stores):
    """A v2 state minted by rank 0 of 1 resumes, split over two workers of
    a loader configured as rank 1 of 3, to exactly the remaining stream."""
    port = ScIterableDataset(stores[1], sampling.BlockShuffling(16), **LOADER)
    it = iter(port)
    for _ in range(5):
        next(it)
    state = port.state()
    want = [_batch_key(b) for b in it]
    other = ScIterableDataset(stores[1], sampling.BlockShuffling(16), rank=1,
                              world_size=3, **LOADER)
    other.load_state(LoaderState.from_dict(json.loads(json.dumps(state.to_dict()))))
    loader = DataLoader(other, batch_size=None, num_workers=2,
                        multiprocessing_context="spawn")
    assert sorted(_batch_key(b) for b in loader) == sorted(want)


def test_loader_state_json_roundtrip_matches_reference():
    from repro.core.dataset import LoaderState as RefLoaderState

    fields = dict(seed=3, epoch=2, fetch_cursor=4, batch_cursor=1, world_size=2,
                  global_cursor=9, remaining=((9, 1), (11, 0)))
    a, b = RefLoaderState(**fields), LoaderState(**fields)
    assert json.dumps(a.to_dict()) == json.dumps(b.to_dict())
    back = LoaderState.from_dict(json.loads(json.dumps(b.to_dict())))
    assert back == b
    assert json.dumps(RefLoaderState(1, 0, 0).to_dict()) == json.dumps(LoaderState(1, 0, 0).to_dict())


def test_unported_features_raise(stores):
    # the monitor and autotune are ported: they refuse what the reference
    # refuses (tests/test_torch_diversity.py, tests/test_torch_autotune.py)
    for cls, store in ((ScDataset, stores[0]), (ScIterableDataset, stores[1])):
        with pytest.raises(ValueError, match="diversity_obs"):
            cls(np.arange(10), diversity_obs="plate")
        with pytest.raises(TypeError, match="planned collection"):
            cls(store).autotune()
    ds = ScIterableDataset(stores[1])
    # repartition is ported (tests/test_torch_elastic.py): it refuses what
    # the reference refuses
    with pytest.raises(ValueError, match="out of range"):
        ds.repartition(2, 2)
    with pytest.raises(ValueError, match="outside"):
        ds.repartition(0, 2, plan=[(10**6, 0)])
    ds.repartition(1, 2)
    assert (ds.rank, ds.world_size, ds._fetch_plan) == (1, 2, None)
    with pytest.raises(ValueError):
        ds.load_state(LoaderState(seed=99, epoch=0, fetch_cursor=0))


def test_multi_indexable_and_hooks_match_reference():
    """An in-memory multi-modal collection through the default callbacks
    and a batch transform gives the reference's batches."""
    from repro.core import MultiIndexable as RefMultiIndexable
    from repro_torch.core import MultiIndexable

    rng = np.random.default_rng(9)
    fields = {"x": rng.normal(size=(301, 5)).astype(np.float32),
              "label": rng.integers(0, 4, 301), "id": list(range(301))}
    kw = dict(batch_size=16, fetch_factor=3, seed=5, drop_last=False)
    ref = ScDataset(RefMultiIndexable(fields), ref_sampling.BlockShuffling(4),
                    batch_transform=lambda b: b.map(lambda k, v: v), **kw)
    port = ScIterableDataset(MultiIndexable(fields), sampling.BlockShuffling(4),
                             batch_transform=lambda b: b.map(lambda k, v: v), **kw)
    want, got = list(ref), list(port)
    assert len(got) == len(want) == len(port) > 0
    for a, b in zip(want, got):
        assert sorted(a.keys()) == sorted(b.keys())
        assert np.array_equal(a["x"], b["x"]) and np.array_equal(a["label"], b["label"])
        assert a["id"] == b["id"]  # a plain list: gathered row by row
    with pytest.raises(ValueError):
        MultiIndexable(x=np.zeros(3), y=np.zeros(4))


# ----------------------------------------------------------------- collation
def test_collation_and_cpu_feed(stores):
    port = ScIterableDataset(stores[1], sampling.BlockShuffling(16), **LOADER)
    batches = list(port)[:5]
    fed = list(device_prefetch(batches, "cpu"))
    assert len(fed) == len(batches)
    for b, t in zip(batches, fed):
        vals, cols = b.to_ell()
        assert t["vals"].dtype == torch.float32 and t["cols"].dtype == torch.int32
        assert np.array_equal(t["vals"].numpy(), vals)
        assert np.array_equal(t["cols"].numpy(), cols)
        assert t["vals"].shape == (len(b), int(np.diff(b.indptr).max()))
        for k, v in b.obs.items():
            assert np.array_equal(t["obs"][k].numpy(), v)
