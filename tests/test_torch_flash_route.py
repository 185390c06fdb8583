"""Which flash-attention kernel takes which inputs, on the CPU: the route
rule of ``repro_torch.kernels.flash_attention`` is a pure function of type,
shape, strides and base addresses, so it needs no card.  Also what
``chip_smoke.py``'s mutation checks and build phase read from the sources
and from ``ptxas``.  The kernels themselves run in ``test_torch_cuda.py``."""
import os
import sys

import pytest
import torch

from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as fa

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the repo's card script: its constants only)

SMOLLM_HEADS, SMOLLM_KV_HEADS = 15, 5


def _bshd_views(B, S, H, Hkv, D, dtype=torch.bfloat16, device="cpu"):
    """q, k, v as the model passes them: (B, S, H, D) projections viewed as
    (B, H, S, D)."""
    def view(heads):
        return torch.empty((B, S, heads, D), dtype=dtype, device=device).transpose(1, 2)
    return view(H), view(Hkv), view(Hkv)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("D", fa.HOPPER_HEAD_DIMS)
@pytest.mark.parametrize("B,S", [(8, 512), (4, 2048)], ids=["serving", "training"])
def test_path_views_take_the_hopper_kernel(B, S, D, device):
    q, k, v = _bshd_views(B, S, SMOLLM_HEADS, SMOLLM_KV_HEADS, D, device=device)
    assert fa.route(q, k, v) == "hopper"
    # contiguous (B, H, S, D), the JAX kernel's own layout, too
    assert fa.route(*(t.contiguous() for t in (q, k, v))) == "hopper"


def _misaligned_row_stride():
    """D 64 inside rows of 68 values: a 136-byte row stride."""
    x = torch.empty((1, 3, 40, 68), dtype=torch.bfloat16)[..., :64]
    return x, x[:, :1], x[:, :1]


def _misaligned_base():
    """D 64 starting 4 values (8 bytes) into its buffer."""
    x = torch.empty((1 * 3 * 40 * 64 + 4,), dtype=torch.bfloat16)[4:].view(1, 3, 40, 64)
    return x, x[:, :1], x[:, :1]


def _d256_row_stride():
    """gemma-7b's head_dim inside rows of 260 values: a 520-byte row stride,
    which TMA refuses."""
    x = torch.empty((1, 4, 64, 260), dtype=torch.bfloat16)[..., :256]
    return x, x[:, :2], x[:, 2:]


@pytest.mark.parametrize("make,want", [
    (lambda: _bshd_views(2, 37, 3, 1, 20), "bf16"),  # the smoke config's head_dim
    (lambda: _bshd_views(1, 64, 2, 2, 16), "bf16"),  # the sweeps'
    (lambda: _bshd_views(2, 64, 4, 2, 32), "bf16"),
    (lambda: _bshd_views(2, 64, 4, 2, 96), "bf16"),  # under 128, not a TMA panel width
    (lambda: _bshd_views(4, 512, 16, 16, 256), "hopper"),  # gemma-7b's head_dim
    (_d256_row_stride, "bf16"),  # 256 at strides TMA refuses
    (lambda: _bshd_views(1, 64, 4, 2, 160), "bf16"),  # padded to 256
    (lambda: _bshd_views(1, 64, 4, 2, 200), "bf16"),
    (lambda: _bshd_views(1, 40, 32, 8, 120, dtype=torch.float32), "f32"),
    (lambda: _bshd_views(8, 512, 15, 5, 64, dtype=torch.float32), "f32"),
    (lambda: _bshd_views(1, 40, 2, 2, 128, dtype=torch.float32), "f32"),
    (_misaligned_row_stride, "bf16"),
    (_misaligned_base, "bf16"),
], ids=["d20", "d16", "d32", "d96", "d256", "d256-row-stride-520B", "d160", "d200", "f32-d120",
        "f32-d64", "f32-d128", "row-stride-136B", "base-8B"])
def test_other_inputs_keep_their_kernels(make, want):
    assert fa.route(*make()) == want


def test_length_one_axes_do_not_count_their_strides():
    """An axis of length 1 is never stepped along, so its stride (here an
    odd one) does not keep the input from TMA."""
    q = torch.empty((1, 2, 50, 64), dtype=torch.bfloat16).as_strided((1, 2, 50, 64),
                                                                     (3, 50 * 64, 64, 1))
    k = torch.empty((1, 1, 50, 64), dtype=torch.bfloat16).as_strided((1, 1, 50, 64),
                                                                     (5, 7, 64, 1))
    assert fa.route(q, k, k) == "hopper"
    q_odd_rows = torch.empty((2 * 50 * 68,), dtype=torch.bfloat16).as_strided(
        (1, 2, 50, 64), (0, 50 * 68, 68, 1))  # 136-byte rows
    assert fa.route(q_odd_rows, k, k) == "bf16"


@pytest.mark.parametrize("case,err", [
    ("float16", TypeError), ("mixed_types", TypeError), ("head_dim_257", ValueError),
    ("head_dim_384", ValueError), ("last_axis_strided", ValueError), ("heads_not_grouped", ValueError),
    ("window_zero", ValueError),
])
def test_route_raises_where_the_kernels_do(case, err):
    q, k, v = _bshd_views(1, 16, 4, 2, 64)
    window = 0 if case == "window_zero" else None
    if case == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed_types":
        k = k.float()
    elif case == "head_dim_257":  # one past the widest kernel, gemma-7b's 256
        q, k, v = _bshd_views(1, 16, 4, 2, 257)
    elif case == "head_dim_384":
        q, k, v = _bshd_views(1, 16, 4, 2, 384)
    elif case == "last_axis_strided":
        q, k, v = (t[..., ::2] for t in _bshd_views(1, 16, 4, 2, 128))
    elif case == "heads_not_grouped":
        q = _bshd_views(1, 16, 3, 2, 64)[0]
    with pytest.raises(err):
        fa.route(q, k, v, window)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    torch.manual_seed(0)
    q = torch.randn((1, 15, 70, 64), dtype=torch.bfloat16)
    k, v = (torch.randn((1, 5, 70, 64), dtype=torch.bfloat16) for _ in range(2))
    counts = (fa.hopper_launches, fa.flash_attention.launches, fa.flash_attention_fwd_lse.launches)
    out = ops.flash_attention(q, k, v, causal=True)
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
    assert (fa.hopper_launches, fa.flash_attention.launches,
            fa.flash_attention_fwd_lse.launches) == counts
    with pytest.raises(ValueError):  # the kernel's wrapper takes CUDA tensors only
        fa.flash_attention(q, k, v)
    assert fa.hopper_launches == counts[0]


def test_the_served_configs_take_their_kernels():
    """Every registered attention config's prefill views: the Hopper kernel
    at head_dim 64, 120, 128 and gemma-7b's 256 (whisper-large-v3's
    encoder over 8 x 1,500 frames, internvl2-26b's 256 patches and 4,352
    tokens among them); in float32 (the card-against-CPU checks) the f32
    kernel."""
    from repro_torch.configs import ARCHS, get_config

    for arch in ARCHS:
        cfg = get_config(arch)
        if cfg.num_heads == 0:
            continue
        B, S = (8, cfg.cross_len) if cfg.family == "encdec" else (4, 4608)
        views = _bshd_views(B, S, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                            device="meta")
        assert fa.route(*views, cfg.sliding_window) == "hopper", arch
        f32 = _bshd_views(1, 64, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                          dtype=torch.float32, device="meta")
        assert fa.route(*f32, cfg.sliding_window) == "f32", arch


def test_the_forward_takes_head_dims_up_to_256():
    for D in (1, 20, 120, 129, 200, 256):
        assert fa.route(*_bshd_views(1, 16, 4, 2, D, device="meta")) in ("hopper", "bf16")
    with pytest.raises(ValueError, match="1..256"):
        fa.route(*_bshd_views(1, 16, 4, 2, 257, device="meta"))


@pytest.mark.parametrize("source,name,edit", [
    *(("flash_attention", n, e) for n, e in chip_smoke.FLASH_MUTANTS.items()),
    *(("flash_attention", n, e) for n, e in chip_smoke.WIDE_MUTANTS.items()),
    *(("ssm_scan", n, e) for n, e in chip_smoke.SSM_MUTANTS.items()),
    *(("flash_attention_bwd", n, e) for n, e in chip_smoke.BWD_MUTANTS.items()),
    *(("flash_attention_bwd", n, e) for n, e in chip_smoke.BWD256_MUTANTS.items()),
    *(("ell_to_dense", n, e) for n, e in chip_smoke.ELL_MUTANTS.items()),
])
def test_each_mutant_edits_one_line_of_its_source(source, name, edit):
    """chip_smoke.py's mutation checks edit a line that occurs exactly once
    in the shipped source (the script fails on the card otherwise)."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    assert text.count(edit[0]) == 1, name
    assert edit[1] not in text, name


def test_ptxas_report_reads_registers_and_spills(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function '_ZN7fwd_hopper16flash_fwd_hopperILi64EEEv' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN7fwd_hopper16flash_fwd_hopperILi64EEEv",
        "    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_Z14flash_fwd_bf16ILi32EEv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z14flash_fwd_bf16ILi32EEv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 96 registers, 384 bytes cmem[0]",
    ])
    _build._target("flash_attention").with_suffix(".log").write_text(log)
    assert _build.ptxas_report("flash_attention") == {
        "_ZN7fwd_hopper16flash_fwd_hopperILi64EEEv":
            {"registers": 168, "stack_frame_bytes": 8, "spill_store_bytes": 8, "spill_load_bytes": 12},
        "_Z14flash_fwd_bf16ILi32EEv": {"registers": 96, "stack_frame_bytes": 0, "spill_store_bytes": 0,
                                      "spill_load_bytes": 0},
    }


def test_ptxas_report_reads_static_shared_memory(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125ell_to_dense_tiled_kernelILb1EEEvPKfPKiPfllll' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_125ell_to_dense_tiled_kernelILb1EEEvPKfPKiPfllll",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers, 32784 bytes smem",
    ])
    _build._target("ell_to_dense").with_suffix(".log").write_text(log)
    assert _build.ptxas_report("ell_to_dense") == {
        "_ZN12_GLOBAL__N_125ell_to_dense_tiled_kernelILb1EEEvPKfPKiPfllll":
            {"registers": 40, "stack_frame_bytes": 0, "spill_store_bytes": 0, "spill_load_bytes": 0,
             "smem_bytes": 32784},
    }
