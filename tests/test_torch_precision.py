"""Float32 products in full float32, and the caller's TF32 setting left as
the caller set it (``repro_torch.precision``), on the CPU.

PyTorch's CPU build keeps the CUDA flag ``torch.backends.cuda.matmul.
allow_tf32`` too, so the tests set it as a caller would and read it at
every matrix product (through a dispatch mode that sees the backward's
products as well) and after the call, also when the call raises.  Sizes
are the smoke configs'; the file takes about 3 s on one CPU core.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import smoke_config
from repro_torch.models import Model
from repro_torch.precision import full_float32_matmul
from repro_torch.train import probe

FLAG = torch.backends.cuda.matmul
PRODUCTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.baddbmm.default}


class _Products(TorchDispatchMode):
    """Records (dtype, allow_tf32) at each matrix product, forward and backward."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in PRODUCTS:
            self.seen.append((args[0].dtype, FLAG.allow_tf32))
        return func(*args, **(kwargs or {}))


@pytest.fixture
def caller_flag():
    """Restores the process's setting after the test, whatever it did."""
    legacy, new = FLAG.allow_tf32, FLAG.fp32_precision
    yield
    FLAG.allow_tf32 = legacy
    FLAG.fp32_precision = new
    assert FLAG.allow_tf32 == legacy


@pytest.mark.parametrize("caller", [True, False])
def test_block_turns_tf32_off_and_restores_it(caller_flag, caller):
    FLAG.allow_tf32 = caller
    with full_float32_matmul():
        assert FLAG.allow_tf32 is False
    assert FLAG.allow_tf32 is caller
    with pytest.raises(KeyError):
        with full_float32_matmul():
            raise KeyError("inside")
    assert FLAG.allow_tf32 is caller


def test_block_keeps_a_caller_who_set_fp32_precision(caller_flag):
    """Once ``fp32_precision`` disagrees with ``allow_tf32``, PyTorch raises on
    reading the latter: the block then sets and restores the former."""
    FLAG.allow_tf32 = False
    FLAG.fp32_precision = "tf32"
    with pytest.raises(RuntimeError):
        FLAG.allow_tf32
    with full_float32_matmul():
        assert FLAG.fp32_precision == "ieee"
    assert FLAG.fp32_precision == "tf32"


def _heads_and_batch(seed=0, genes=32, rows=16):
    rng = np.random.default_rng(seed)
    heads = probe.init_heads(genes, device="cpu", generator=torch.Generator().manual_seed(seed))
    x = torch.tensor(np.log1p(rng.poisson(1.0, (rows, genes))).astype(np.float32))
    ys = {t: torch.tensor(rng.integers(0, c, rows).astype(np.int32)) for t, c in probe.TASKS.items()}
    return heads, probe.init_adam(heads), x, ys


@pytest.mark.parametrize("caller", [True, False])
def test_probe_step_multiplies_in_full_float32_and_restores_the_flag(caller_flag, caller):
    heads, opt, x, ys = _heads_and_batch()
    FLAG.allow_tf32 = caller
    with _Products() as spy:
        probe.train_step(heads, opt, x, ys)
    # the forward's x @ w and the backward's products for w
    assert len(spy.seen) >= 2 * len(probe.TASKS)
    assert spy.seen == [(torch.float32, False)] * len(spy.seen)
    assert FLAG.allow_tf32 is caller


@pytest.mark.parametrize("caller", [True, False])
def test_probe_step_restores_the_flag_when_it_raises(caller_flag, caller):
    heads, opt, x, ys = _heads_and_batch()
    ys["drug"] = ys["drug"] + 1000  # a class past the head's: gather raises in the loss
    FLAG.allow_tf32 = caller
    with pytest.raises((IndexError, RuntimeError)):
        probe.train_step(heads, opt, x, ys)
    assert FLAG.allow_tf32 is caller


def _mamba(dtype: str):
    cfg = dataclasses.replace(smoke_config("falcon-mamba-7b"), param_dtype=dtype,
                              compute_dtype=dtype)
    model = Model(cfg)
    lm = model.init(generator=torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(1))
    return model, lm, tokens, model.init_cache(2, 16, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("caller", [True, False])
def test_ssm_prefill_multiplies_float32_in_full_float32_and_restores_the_flag(
        caller_flag, caller, dtype):
    """In bf16 only the dt product (``w_dt`` in float32) is float32."""
    model, lm, tokens, cache = _mamba(dtype)
    FLAG.allow_tf32 = caller
    with _Products() as spy:
        model.prefill(lm, {"tokens": tokens}, cache)
        model.decode(lm, tokens[:, -1], cache, 12)
    float32 = [flag for dt, flag in spy.seen if dt == torch.float32]
    assert float32 and not any(float32)
    assert FLAG.allow_tf32 is caller


@pytest.mark.parametrize("caller", [True, False])
def test_ssm_prefill_restores_the_flag_when_it_raises(caller_flag, caller, monkeypatch):
    model, lm, tokens, cache = _mamba("float32")

    def fails(*args, **kwargs):
        assert FLAG.allow_tf32 is False
        raise RuntimeError("a product failed")

    monkeypatch.setattr(torch, "einsum", fails)
    FLAG.allow_tf32 = caller
    with pytest.raises(RuntimeError, match="a product failed"):
        model.prefill(lm, {"tokens": tokens}, cache)
    assert FLAG.allow_tf32 is caller
