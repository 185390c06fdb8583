"""The port stands alone: it imports with JAX and the JAX package blocked,
none of its files (nor ``chip_smoke.py``) names either, and ``chip_smoke.py``
refuses to run without a card."""
import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
BLOCKED = ("jax", "jaxlib", "repro")


def _run(args, cwd, **env):
    full = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), **env)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=full, capture_output=True,
                          text=True, timeout=120)


def test_port_imports_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        f"for m in {BLOCKED!r}: sys.modules[m] = None\n"
        "import importlib, pkgutil, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(' '.join(sorted(names)))\n"
    )
    res = _run(["-c", code], cwd=REPO)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert {
        "repro_torch.core.dataset", "repro_torch.core.sampling", "repro_torch.core.callbacks",
        "repro_torch.data.csr_store", "repro_torch.data.synth", "repro_torch.data.iostats",
        "repro_torch.data.readplan", "repro_torch.kernels.ops", "repro_torch.kernels.ref",
        "repro_torch.kernels.csr_to_dense", "repro_torch.kernels._build",
        "repro_torch.distributed.dataio", "repro_torch.train.probe", "repro_torch.convert",
        "repro_torch.kernels.flash_attention", "repro_torch.models", "repro_torch.models.config",
        "repro_torch.models.layers", "repro_torch.models.transformer", "repro_torch.models.api",
        "repro_torch.configs", "repro_torch.configs.smollm_360m", "repro_torch.train.step",
        "repro_torch.serve.scheduler", "repro_torch.launch.serve",
        "repro_torch.kernels.flash_attention_bwd", "repro_torch.train.loss",
        "repro_torch.train.optimizer", "repro_torch.data.tokens", "repro_torch.pipeline",
        "repro_torch.pipeline.spec", "repro_torch.pipeline.builder", "repro_torch.checkpoint",
        "repro_torch.checkpoint.manager", "repro_torch.distributed.fault",
        "repro_torch.launch.train", "repro_torch.kernels.ssm_scan", "repro_torch.models.ssm",
        "repro_torch.configs.falcon_mamba_7b", "repro_torch.core.theory",
        "repro_torch.train.fig5", "repro_torch.precision", "repro_torch.data.backend",
        "repro_torch.data.chunked_store", "repro_torch.data.h5shim", "repro_torch.data.h5ad",
        "repro_torch.core.prefetch", "repro_torch.core.autotune", "repro_torch.data.cloud",
        "repro_torch.data.faults", "repro_torch.train.fig4",
        "repro_torch.distributed.compression", "repro_torch.distributed.elastic",
        "repro_torch.distributed.elastic.pool", "repro_torch.distributed.elastic.repartition",
        "repro_torch.distributed.elastic.supervisor", "repro_torch.distributed.elastic.fabric",
        "repro_torch.serve.data", "repro_torch.serve.data.protocol",
        "repro_torch.serve.data.server", "repro_torch.serve.data.client",
        "repro_torch.models.moe", "repro_torch.models.flags", "repro_torch.configs.gemma_7b",
        "repro_torch.configs.phi3_medium_14b", "repro_torch.configs.h2o_danube_3_4b",
        "repro_torch.configs.mixtral_8x7b", "repro_torch.configs.phi3_5_moe",
        "repro_torch.distributed.sharding", "repro_torch.distributed.context",
        "repro_torch.distributed.pipeline",
    } <= names


def _port_files():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_port_file_imports_jax_or_repro():
    offenders = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            offenders += [(path, m) for m in mods if m.split(".")[0] in BLOCKED]
    assert offenders == []


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("on a machine with a card chip_smoke.py runs for real")
    res = _run(["chip_smoke.py"], cwd=REPO)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    res = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
