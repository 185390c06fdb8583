"""The Fig. 4 twin (``repro_torch.train.fig4``) against the JAX package's
benchmark (``benchmarks/bench_fig4_entropy.py``) on a small store: the same
cells give the same mean and standard deviation of batch plate entropy, both
sides checking their live ``div_*`` counters against the offline
measurement; the grid's rows, bounds and ``in_bounds`` as the benchmark
computes them; the command line at a tiny size."""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from repro.core.theory import distribution_entropy as ref_distribution_entropy
from repro.core.theory import entropy_bounds as ref_entropy_bounds
from repro_torch.data import generate_tahoe_like
from repro_torch.train import fig4

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)  # the benchmark imports benchmarks.common
_spec = importlib.util.spec_from_file_location(
    "bench_fig4_entropy", os.path.join(REPO, "benchmarks", "bench_fig4_entropy.py"))
bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fig4"))
    generate_tahoe_like(root, n_cells=6000, n_genes=32, seed=0)
    return root


@pytest.mark.parametrize("b, f", [(1, 1), (16, 1), (16, 16), (64, 4), (1024, 1)])
def test_measure_entropy_equals_the_benchmarks(store, monkeypatch, b, f):
    monkeypatch.setattr(bench, "BENCH_DATA_DIR", store)
    assert fig4.measure_entropy(store, b, f) == bench.measure_entropy(b, f)


def test_cells_and_bounds_follow_the_benchmark(store):
    p = fig4.plate_distribution(store)
    from repro.data import load_tahoe_like

    sizes = np.array([len(s) for s in load_tahoe_like(store).shards], dtype=np.float64)
    np.testing.assert_array_equal(p, sizes / sizes.sum())
    lines = []
    out = fig4.run(store, grid_b=(1, 16), grid_f=(1, 16), log=lines.append)
    assert out["Hp"] == ref_distribution_entropy(p)
    assert list(out["grid"]) == ["b1_f1", "b1_f16", "b16_f1", "b16_f16"]
    for c in out["grid"].values():
        lo, hi = ref_entropy_bounds(p, fig4.M, c["b"])
        assert c["bounds"] == [lo, hi]
        slack = 3 * max(c["std"], 0.05)
        assert c["in_bounds"] == (lo - slack <= c["H"] <= hi + slack)
    assert (out["random"]["b"], out["random"]["f"]) == (1, 4)
    assert out["paper"]["b16_f1"]["paper"] == (1.76, 0.33) and "b16_f256" not in out["paper"]
    assert len(lines) == 1 + 4 + 1 + 1  # H(p), the cells, random, b16_f1


def test_the_command_line_at_a_tiny_size(store, capsys):
    assert fig4.main(["--data-dir", store, "--cells", "6000", "--genes", "32", "--b", "16",
                      "--f", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["fig4"]
    assert out["cells"] == 6000 and list(out["grid"]) == ["b16_f1"]
    assert out["live_counters"].startswith("div_*")
