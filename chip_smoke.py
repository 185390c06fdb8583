#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card, check them, and time
their kernels against their plain versions.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card and the CUDA toolkit (``nvcc``); imports
nothing of JAX or of the JAX package.  Phases, each printing one JSON line:

1. device: the card's name, count and power limit;
2. build: every ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a``, all started together; the registers and spill bytes of the
   Hopper flash-attention kernels (``flash_fwd_hopper``,
   ``flash_bwd_dq_hopper`` and ``flash_bwd_dkv_hopper``, head_dim 64 and
   128) from ``ptxas -v``;

The cell-training path (slice 1):

3. data: a Tahoe-like dataset at Tahoe-100M's width, 62,710 genes (14
   plates, 32,768 cells = two fetches of 64 x 256, 2,048 counts per cell,
   seed 0), generated under ``build/chip_smoke_data`` in the checkout or
   reused when its manifest matches;
4. kernel: ``ell_to_dense`` on the card against its plain PyTorch version:
   the JAX package's sweep with duplicate columns (atol 1e-6, the order in
   which duplicates add up differs) and a real batch of the path (bitwise:
   canonical CSR has no duplicates, so every output is one value or 0),
   with CUDA-event times of the kernel (also at 132 and 264 rows), the
   plain version and one PyTorch call of the same function, each over
   back-to-back calls queued behind a sleep kernel so that the host's
   time per call is hidden; one train step on the card against the same
   step on the CPU (loss within rtol 1e-4: float32 products summed in
   another order);
5. main path: ``BlockShuffling(16)``, batch 64, ``fetch_factor=256``, the
   two-deep device feed and one epoch of ``train_step`` (512 steps, two
   fetches of 16,384 random 16-cell blocks) through
   ``train_probe``, with the kernel's launch count set to 0 just before and
   read just after;
6. trace: 64 steps of the next epoch under ``torch.profiler``, for the
   device's kernel time by name and ``ell_to_dense``'s own.

LM serving (slice 2), smollm-360m at its full width and depth (32 layers,
d_model 960, 15 query heads over 5 kv heads of 64, vocab 49,152):

7. flash_kernel: ``flash_attention`` on the card against its plain
   version: the JAX package's sweep (four shapes x causal / window 48 /
   non-causal) in bf16 (atol 3e-2: outputs are means of N(0, 1) values,
   under 4 in magnitude, where a bf16 ulp is 2**-6 and the P.V sums round
   in another order) and float32 (atol 3e-5, TF32 off: summation order), the ``q_offset=200`` decode tile, and
   the prefill's shape, q (8, 15, 512, 64) and k/v (8, 5, 512, 64) bf16 as
   the strided (B, S, H, D) views the model passes, which must take the
   Hopper kernel (``hopper_launches`` + 1); event times of the kernel, of
   the ``mma.sync`` kernel it replaced on that route (launched by
   ``previous_kernel``, held to the same atol), of the plain version and of
   ``scaled_dot_product_attention`` there; the host's microseconds per
   call of the wrapper and of ``previous_kernel`` (the wrapper's host work
   before the Hopper route);
8. lm_vs_cpu: float32 weights drawn once from a seeded generator and
   copied to the card; a 64-token prefill and 8 decode steps on the card
   and on the CPU: logits within rtol 1e-3 / atol 1e-3 (float32 sums in
   another order over 32 layers), greedy tokens equal except across ties;
9. serve (the main path): ``serve_batch`` in bf16, batch 8, 512-token
   prompts, 64 generated tokens, with the kernel's launch counts set to 0
   just before and read just after (32 per prefill, all 32 through the
   Hopper kernel); time to first token,
   decode ms per step, tokens/s, peak memory; then one prefill under
   ``torch.profiler`` for the kernel's own device time per launch;
10. batching: ``SlotBatcher`` in float32, 16 requests over 4 slots (prompts
   of 64-512 tokens, 16-64 new tokens, numpy seed 0, max_len 1024); every
   request's tokens equal a standalone batch-1 serve of its prompt except
   across ties.

LM training (slice 3), smollm-360m at its full width:

11. train_kernels: the forward with lse, dq and dk/dv kernels on the card
   against their plain versions: the JAX package's backward sweep
   (tests/test_kernels_bwd.py: GQA, MQA, uneven tiles x causal / window 32 /
   non-causal) in float32 (atol = rtol = 2e-4, the JAX package's own
   tolerance; TF32 off) and bf16 (|err| <= 3e-2 + 2e-2 |want|: P and dS are
   rounded to bf16 as operands, outputs to bf16), and the training shape,
   q (4, 15, 2048, 64) and k/v (4, 5, 2048, 64) bf16 causal as the strided
   (B, S, H, D) views the model passes, each tensor there within
   0.1 rms(want) + 2**-6 |want| (its values are too small for the sweep's
   atol; rms(want) is printed beside each error), all three there through
   the Hopper kernels; the mutation checks: three edited copies of
   ``csrc/flash_attention.cu`` (one drops the rescale of O by alpha, one
   skips each block's last KV tile, one lets the causal mask of a diagonal
   tile see one key too many) and three of ``csrc/flash_attention_bwd.cu``
   (dk/dv without the delta of dS, dk/dv skipping each item's first query
   tile, dq's diagonal tile seeing one key too many), built under
   ``build/`` and run on the training shape's inputs, must each fail that
   rule (or lse's 1e-4) at least FLASH_MUTANT_MIN times over; the
   ``mma.sync`` kernels the Hopper routes replaced (``previous_kernel``,
   ``previous_bwd``), held to the same rule; event times of each kernel,
   of those ``mma.sync`` kernels, of the plain versions, of
   ``scaled_dot_product_attention``'s forward, and of its backward alone
   (``autograd.grad`` over one saved forward; the names of its kernels
   from the profiler, taken in ``main`` before any of the port's kernels
   runs); the host's microseconds per call of each wrapper
   and of its ``mma.sync`` counterpart, the two taking turns;
12. train_vs_cpu: one train step at full width in float32 with 2 layers on
   the card and on the CPU from the same weights and batch: loss within
   rtol 1e-5, grad norm within rtol 1e-4 (float32 sums in another order),
   and the updated parameters: at least 99.9% of each tensor within 1e-6,
   every element within 2 lr + 1e-6 (Adam's first step moves each weight
   by lr times the sign of its gradient, which float32 noise flips where a
   gradient is within noise of zero);
13. train (the main path): ``build_loader`` over a 2,000,000-token corpus
   under ``build/`` (vocabulary 1,024, as ``main`` sizes it), batch 4 x
   2,048 tokens (SmolLM's context length), ``train_loop`` in bf16 with
   ``remat="full"`` at 32 layers for 5 warm-up and 25 timed steps, the
   kernels' launch counts set to 0 just before and read just after
   (64 / 32 / 32 per step required, all through the Hopper kernels:
   ``flash_attention.hopper_launches`` and the ``hopper_launches`` of
   ``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv``); step time, tokens/s over the median
   step and over the timed steps' wall (loader included), the loader's
   share of that wall, loss, peak
   memory; then one step under ``torch.profiler`` for each kernel's device
   time per launch and their share of the step's device time;
14. resume: at full width with 4 layers, 6 steps with a checkpoint every 3
   and a crash injected after step 4, restarted by ``run_with_restarts``
   from step 3: the final parameters and moments equal an uninterrupted
   run's bitwise.

Mamba serving (slice 4), falcon-mamba-7b at its full width (d_model
4,096, d_inner 8,192, d_state 16, d_conv 4, vocab 65,024):

15. ssm_kernel: ``ssm_scan`` on the card against its plain version: a
   sweep (S = 1, 37, 300; N = 4, 16 and 5; h0 present or absent; float32 and
   bf16; x, B and C as the strided views the model passes) and the
   prefill's shape, x (8, 1024, 8192) bf16 with N = 16, each tensor
   within the rule SSM_RULE scaled to rms(want) (max error, rms(want) and
   error over the rule printed for y and h_final); the mutation check:
   three edited copies of ``csrc/ssm_scan.cu`` (one drops D x, one resets
   h at each chunk boundary, one skips the last step), built under
   ``build/`` and run on the same inputs, must each fail the rule at least
   SSM_MUTANT_MIN times over; event times of the kernel and the plain
   version, and the bound with its parts (bytes; exponentials on the
   special-function units; the FMA pipe);
16. ssm_vs_cpu: 2 layers at full width in float32 on the card and on the
   CPU from the same weights: a 300-token prefill (not a multiple of the
   reference's 256-step chunk) at batch 2 and 8 decode steps: logits
   within rtol / atol 1e-3, greedy tokens equal except across ties, the
   convolution and scan states within SSM_STATE_ATOL / SSM_STATE_RTOL;
17. ssm_serve (the main path): ``serve_batch`` at full width and depth (64
   layers, 7.27 B parameters drawn on the card from a seed) in bf16, batch
   8, 1,024-token prompts, 32 new tokens, after a warm-up at the same
   shapes, with ``ssm_scan``'s launch count set to 0 just before and read
   just after (64 in the prefill, none in the 31 decode steps); time to
   first token, decode ms per step, tokens/s, peak memory; then one
   prefill and one decode step under ``torch.profiler``;
18. ssm_batching: ``SlotBatcher`` over SSM caches at full width with 4
   layers in float32, 10 requests of 16-512 prompt tokens over 4 slots;
   every request equals its standalone serve except across ties.

Then the kernels line (one entry per kernel), the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.  Any failure
exits non-zero before it.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

N_GENES = 62_710  # Tahoe-100M's gene count: the probe's full width
DATA = dict(n_cells=32_768, n_genes=N_GENES, n_plates=14, total_counts=2048, chunk=256, seed=0)
BATCH, FETCH_FACTOR, BLOCK = 64, 256, 16
MIN_STEPS = 200
# the JAX package's ELL sweep (tests/test_kernels.py): (rows, K, n_cols)
SWEEP = [(16, 8, 64), (33, 5, 100), (8, 16, 512), (1, 1, 8)]
SWEEP_ATOL = 1e-6
TIMED_CALLS, TIMED_GROUPS = 100, 5
SLEEP_CYCLES = 50_000_000  # ~30 ms of sleep kernel: time to queue TIMED_CALLS calls
SWEEP_ROWS = (64, 132, 264)  # one row per block: the path's batch, one and two per SM
TRACE_STEPS = 64
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
# LM serving
ARCH = "smollm-360m"
FA_SWEEP = [(1, 2, 2, 64, 64, 16), (2, 4, 2, 128, 128, 32), (1, 8, 1, 96, 160, 64),
            (2, 2, 1, 64, 128, 32)]  # the JAX package's (B, H, Hkv, S, T, D)
FA_MASKS = [(True, None), (True, 48), (False, None)]
FA_ATOL = {"float32": 3e-5, "bfloat16": 3e-2}
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 512, 64
CPU_PROMPT, CPU_DECODE, CPU_RTOL, CPU_ATOL = 64, 8, 1e-3, 1e-3
# greedy tokens may differ only where two logits of a step lie this close:
# float32 sums in another order (batch of 4 vs 1, card vs CPU)
TIE_F32 = 1e-3
BATCH_SLOTS, BATCH_REQUESTS, BATCH_MAX_LEN = 4, 16, 1024
BATCH_PROMPT_LENS, BATCH_NEW = (64, 512), (16, 64)  # inclusive ranges drawn from
FULL_WIDTH = (32, 960, 15, 5, 64)  # layers, d_model, heads, kv heads, head_dim
# the mutation check of the Hopper forward: edited copies of
# csrc/flash_attention.cu, built under build/; each must fail the training
# shape's rule FLASH_MUTANT_MIN times over
FLASH_MUTANTS = {
    "drops_alpha_rescale": ("o[i2] *= alpha[(i2 / 2) % 2];", "(void)alpha;"),
    "skips_last_kv_tile": ("(k_end - wk.kt0 + kBlockN - 1) / kBlockN", "(k_end - wk.kt0 - 1) / kBlockN"),
    "diagonal_off_by_one": ("p.causal ? clamp_col<kBlockN>(d) : kBlockN",
                            "p.causal ? clamp_col<kBlockN>(d + 1) : kBlockN"),
}
FLASH_MUTANT_MIN = 3.0
# the mutation check of the Hopper backward: edited copies of
# csrc/flash_attention_bwd.cu, built under build/; each must fail the training
# shape's rule (on dq, dk or dv) FLASH_MUTANT_MIN times over.  The dk/dv one
# skips each item's first query tile, the one on the causal diagonal: under
# the causal mask a key's largest probabilities come from the queries just
# after it, while its last query tile adds about 1/2,048 of a softmax row each.
BWD_MUTANTS = {
    "dkv_drops_delta": ("dp[i] = pr * (dp[i] - (x % 2 ? dl.y : dl.x));", "dp[i] = pr * dp[i];"),
    "dkv_skips_first_query_tile": ("wk.qt0 = static_cast<int>(lo / kTileQ) * kTileQ;",
                                   "wk.qt0 = static_cast<int>(lo / kTileQ) * kTileQ + kTileQ;"),
    "dq_diagonal_off_by_one": ("p.causal ? hopper::clamp_col<kN>(d) : kN",
                               "p.causal ? hopper::clamp_col<kN>(d + 1) : kN"),
}
# LM training
BWD_SWEEP = [(1, 2, 2, 64, 64, 16), (2, 4, 2, 64, 64, 32), (1, 2, 1, 96, 96, 16)]
BWD_MASKS = [(True, None), (True, 32), (False, None)]
BWD_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (3e-2, 2e-2)}  # (atol, rtol)
# At the training shape the values are small (dq, dk and dv of a 2,048-key
# softmax: rms about 0.1), so BWD_TOL's atol would be as large as what it
# checks.  There each tensor is held to |got - want| <= TRAIN_TOL_RMS *
# rms(want) + TRAIN_TOL_REL * |want|: the relative term is two bf16 ulps of
# the value (both sides round their float32 result to bf16, one ulp being at
# most 2**-7 of it), the rms term takes the kernels' rounding of P and dS to
# bf16 as operands, whose errors are spread over the tensor.
TRAIN_TOL_RMS, TRAIN_TOL_REL = 0.1, 2**-6
TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARMUP, TRAIN_STEPS = 4, 2048, 5, 25
TRAIN_CORPUS_TOKENS = 2_000_000
CPU_STEP_LAYERS, CPU_STEP_BATCH, CPU_STEP_SEQ, CPU_STEP_LR = 2, 2, 128, 3e-4
CPU_LOSS_RTOL, CPU_GNORM_RTOL, CPU_PARAM_TOL, CPU_PARAM_SHARE = 1e-5, 1e-4, 1e-6, 0.999
RESUME_LAYERS, RESUME_STEPS, RESUME_EVERY, RESUME_CRASH = 4, 6, 3, 4
# Mamba serving
SSM_ARCH = "falcon-mamba-7b"
SSM_FULL = (64, 4096, 8192, 16, 4)  # layers, d_model, d_inner, d_state, d_conv
# (B, S, D, N): S = 1, S under one 16-step chunk and past several; N = 4
# (the smoke config) and 16, the kernel's only state sizes; D not a multiple
# of the kernel's 128 channels
SSM_SWEEP = [(2, 1, 64, 4), (2, 37, 200, 4), (1, 300, 160, 16), (2, 37, 96, 16),
             (1, 1, 128, 16), (2, 300, 256, 4)]
SSM_PATH = (8, 1024, 8192, 16)  # the prefill's scan: batch 8, 1,024-token prompts
# The scan's rule, written before the first run: |got - want| <= a rms(want)
# + r |want|, per tensor; (a, r) by the type of what is compared.  float32
# (y and h_final, and h_final in bf16, which stays float32): a recurrence of
# up to 1,024 steps that rounds the state once per step (2**-24) and takes
# its exponentials on the special-function unit (about 2**-22); the errors
# add along the decay's memory, up to about 1,000 steps: about 2**-14 of the
# scale, and four times that.  bf16 y: each side rounds its float32 y once;
# where float32 noise moves a value across a rounding boundary the two
# differ by one bf16 ulp, at most 2**-7 of the value, which is half of r;
# a covers values near zero.  So the shipped kernel's error sits under half
# the rule, and a mutant must fail it SSM_MUTANT_MIN times over.
SSM_RULE = {"float32": (2**-12, 2**-12), "bfloat16": (2**-8, 2**-6)}
SSM_MUTANT_MIN = 3.0
# the mutation check: edited copies of csrc/ssm_scan.cu, built under build/
SSM_MUTANTS = {
    "drops_D_x": ("const float yv = acc + Dd * xs[t];", "const float yv = acc;"),
    "resets_h_at_chunk": ("    if (!active) continue;\n",
                          "    if (t0 > 0) {\n#pragma unroll\n"
                          "      for (int n = 0; n < kN; ++n) h[n] = 0.f;\n    }\n"
                          "    if (!active) continue;\n"),
    "skips_last_step": ("const int64_t left = p.S - t0;", "const int64_t left = p.S - 1 - t0;"),
}
SFU_EXP2_PER_CLOCK_PER_SM = 16  # CUDA C++ Programming Guide, compute capability 9.0
SSM_SERVE_BATCH, SSM_SERVE_PROMPT, SSM_SERVE_GEN = 8, 1024, 32
SSM_CPU_LAYERS, SSM_CPU_BATCH, SSM_CPU_PROMPT, SSM_CPU_DECODE = 2, 2, 300, 8
# the card's float32 state against the CPU's: 300 recurrence steps and two
# layers of float32 sums in another order
SSM_STATE_ATOL, SSM_STATE_RTOL = 1e-4, 1e-3
SSM_BATCH_LAYERS, SSM_BATCH_REQUESTS, SSM_BATCH_MAX_LEN = 4, 10, 1024
SSM_BATCH_PROMPT_LENS, SSM_BATCH_NEW = (16, 512), (8, 32)  # inclusive ranges drawn from


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def event_ms(fn, calls: int = TIMED_CALLS, groups: int = TIMED_GROUPS) -> float:
    """Device ms per call of ``fn``: one CUDA-event pair around ``calls``
    back-to-back calls, divided by their number; the median of ``groups``
    such groups.  A sleep kernel ahead of each group holds the stream
    while the host queues the calls, so the host's time per call does not
    count unless ``fn`` itself waits for the device."""
    import torch

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(groups):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / calls)
    return statistics.median(per_call)


def host_us(fns: dict, calls: int = TIMED_CALLS, groups: int = 2 * TIMED_GROUPS + 1) -> dict:
    """Host microseconds per call of each function of ``fns``: the wall
    time to issue ``calls`` calls while a sleep kernel holds the stream (so
    that no call waits for the device), divided by their number; the
    median of ``groups`` such groups, the functions taking turns group by
    group so that a drift of the host's speed falls on each alike."""
    import torch

    per_call = {name: [] for name in fns}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for _ in range(groups):
        for name, fn in fns.items():
            torch.cuda._sleep(SLEEP_CYCLES)
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            per_call[name].append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
    return {name: statistics.median(t) for name, t in per_call.items()}


def previous_kernel(q, k, v, with_lse: bool):
    """Causal attention through the ``mma.sync`` kernel (``flash_fwd_bf16``)
    that the Hopper route replaced, launched from the package's library with
    the host work its wrapper did before that route: the checks, the
    outputs and the C call.  For its device and host times beside the
    Hopper kernel's; counts nothing.  Returns ``(out, lse or None)``."""
    import ctypes

    import torch

    from repro_torch.kernels import flash_attention as fa

    fa.check_layout(q, k, v, None)
    fa.check_device(q, k, v)
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    out = fa.empty_like_rows(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if with_lse else None
    dims = (ctypes.c_int64 * 6)(B, H, Hkv, S, T, D)
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = fa._library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), 1, dims, strides, 1, 0, 0, 0,
            1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
    fa.raise_on_error(lib, err, "flash_fwd_bf16")
    return out, lse


def previous_bwd(q, k, v, dout, lse, delta, dkv: bool) -> tuple:
    """dq, or (dk, dv), through the ``mma.sync`` kernels (``dq_bf16``,
    ``dkv_bf16``) that the Hopper route replaced, launched from the
    package's library with the host work their wrapper did before that
    route: the checks, the outputs and the C call under a device guard with
    the current ``Stream`` object.  For their device and host times beside
    the Hopper kernels'; counts nothing.  Returns the outputs."""
    import ctypes

    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    fa.check_layout(q, k, v, None)
    fa.check_device(q, k, v)
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError("dout does not fit q")
    if dout.stride(3) != 1:
        raise ValueError("dout needs a contiguous last axis")
    for t in (lse, delta):
        if t.shape != (B, H, S) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError("lse and delta must be (B, H, S) float32 on q's device")
        if not t.is_contiguous():
            raise ValueError("lse and delta must be contiguous")
    outs = (fa.empty_like_rows(k), fa.empty_like_rows(v)) if dkv else (fa.empty_like_rows(q),)
    tensors = (q, k, v, dout, *outs)
    strides = (ctypes.c_int64 * (3 * len(tensors)))(*(s for t in tensors for s in t.stride()[:3]))
    lib = fab._library()
    fn = lib.flash_attention_bwd_dkv if dkv else lib.flash_attention_bwd_dq
    with torch.cuda.device(q.device):
        err = fn(*(t.data_ptr() for t in (q, k, v, dout, lse, delta, *outs)), 1,
                 (ctypes.c_int64 * 6)(B, H, Hkv, S, T, D), strides, 1, 0, 0, 1.0 / math.sqrt(D),
                 torch.cuda.current_stream().cuda_stream)
    fa.raise_on_error(lib, err, "dkv_bf16" if dkv else "dq_bf16")
    return outs


def sdpa_backward_kernels(dev, shape) -> list:
    """The names of the kernels that ``scaled_dot_product_attention``'s
    backward launches at the training shape ``(B, S, H, Hkv, D)``, bf16,
    causal, from one profiled ``autograd.grad`` over a saved forward.
    Called before any of the port's kernels runs: once they have, the
    profiler lists only some of cuDNN's kernels."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    B, S, H, Hkv, D = shape
    q = torch.randn((B, S, H, D), device=dev, dtype=torch.bfloat16).transpose(1, 2)
    k, v = (torch.randn((B, S, Hkv, D), device=dev, dtype=torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    dout = torch.randn((B, H, S, D), device=dev, dtype=torch.bfloat16)
    qg, kg, vg = (t.requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
    torch.autograd.grad(o, (qg, kg, vg), dout, retain_graph=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(o, (qg, kg, vg), dout)
        torch.cuda.synchronize()
    return sorted({e.key[:120] for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script measures the card and has no CPU mode")
    from repro_torch.core import BlockShuffling, ScIterableDataset
    from repro_torch.data import generate_tahoe_like, load_tahoe_like
    from repro_torch.kernels import _build, csr_to_dense, ref
    from repro_torch.train import probe

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    # Float32 products in full float32 for the whole script, not TF32: the
    # phases that hold the card against the CPU in float32 (step_vs_cpu,
    # lm_vs_cpu, batching, train_vs_cpu, ssm_vs_cpu, ssm_batching) and the
    # scan's float32 dt product in every Mamba phase depend on it.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    max_sm_mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "max_sm_clock_mhz": float(max_sm_mhz), "torch": torch.__version__,
          "cuda": torch.version.cuda, "capability": list(torch.cuda.get_device_capability(0))})

    # 2. build
    t0 = time.perf_counter()
    built = _build.build()
    seconds = time.perf_counter() - t0
    hopper = {k: v for k, v in _build.ptxas_report("flash_attention").items() if "flash_fwd_hopper" in k}
    if len(hopper) != 2:
        fail(f"ptxas reports {len(hopper)} flash_fwd_hopper kernels, not 2 (head_dim 64 and 128)")
    bwd_hopper = {k: v for k, v in _build.ptxas_report("flash_attention_bwd").items()
                  if "flash_bwd_dq_hopper" in k or "flash_bwd_dkv_hopper" in k}
    if len(bwd_hopper) != 4:
        fail(f"ptxas reports {len(bwd_hopper)} Hopper backward kernels, not 4 (dq and dk/dv at "
             f"head_dim 64 and 128)")
    emit({"phase": "build", "seconds": seconds, "built": built, "flash_fwd_hopper_ptxas": hopper,
          "flash_bwd_hopper_ptxas": bwd_hopper})

    # before any of the port's kernels runs (see sdpa_backward_kernels)
    sdpa_bwd_kernels = sdpa_backward_kernels(dev, (TRAIN_BATCH, TRAIN_SEQ, *FULL_WIDTH[2:]))
    lm_kernel = lm_phases(dev, float(max_sm_mhz) * 1e6)
    torch.cuda.empty_cache()
    train_kernels = train_phases(dev, float(max_sm_mhz) * 1e6, sdpa_bwd_kernels)
    torch.cuda.empty_cache()
    ssm_kernel = ssm_phases(dev, float(max_sm_mhz) * 1e6)
    torch.cuda.empty_cache()

    # 3. data
    root = os.path.join(HERE, "build", "chip_smoke_data")
    t0 = time.perf_counter()
    generate_tahoe_like(root, **DATA)
    store = load_tahoe_like(root)
    emit({"phase": "data", "seconds": time.perf_counter() - t0, "cells": len(store),
          "genes": store.n_var, "plates": len(store.shards),
          "fetches_per_epoch": math.ceil(len(store) / (BATCH * FETCH_FACTOR))})

    def dataset():
        return ScIterableDataset(store, BlockShuffling(BLOCK), batch_size=BATCH,
                                 fetch_factor=FETCH_FACTOR, seed=0)

    # 4. the kernel against its plain version
    rng = np.random.default_rng(0)
    cases = [(rng.normal(0, 1, (R, K)), rng.integers(-1, G, (R, K)), G) for R, K, G in SWEEP]
    cases.append(([[1.0, 2.0, 3.0]], [[4, 4, -1]], 8))  # explicit duplicates
    sweep_err = 0.0
    for v, c, G in cases:
        vals = torch.tensor(np.asarray(v, np.float32), device=dev)
        cols = torch.tensor(np.asarray(c, np.int32), device=dev)
        got = csr_to_dense.ell_to_dense(vals, cols, n_cols=G)
        sweep_err = max(sweep_err, (got - ref.ell_to_dense_ref(vals, cols, G)).abs().max().item())
    if not sweep_err <= SWEEP_ATOL:
        fail(f"ell_to_dense disagrees with its plain version on the sweep: {sweep_err} > {SWEEP_ATOL}")

    batches = dataset().fetch(0, 0)[:3]
    t = batches[0].to_tensors()
    vals, cols = t["vals"].to(dev), t["cols"].to(dev)
    R, K = vals.shape
    got = csr_to_dense.ell_to_dense(vals, cols, n_cols=N_GENES)
    want = ref.ell_to_dense_ref(vals, cols, N_GENES)
    torch.cuda.synchronize()
    main_err = (got - want).abs().max().item()
    if not torch.equal(got, want):
        fail(f"ell_to_dense is not bitwise its plain version on a path batch (max err {main_err})")

    valid = cols >= 0
    lib_rows = torch.arange(R, device=dev).unsqueeze(1).expand(R, K)[valid]
    lib_cols, lib_vals = cols[valid].long(), vals[valid]
    nnz = int(valid.sum())
    kernel_ms = event_ms(lambda: csr_to_dense.ell_to_dense(vals, cols, n_cols=N_GENES))
    by_rows = {}  # the same rows repeated: does the time follow the bytes or the blocks?
    for n in SWEEP_ROWS:
        v_n = vals.repeat(-(-n // R), 1)[:n].contiguous()
        c_n = cols.repeat(-(-n // R), 1)[:n].contiguous()
        by_rows[n] = event_ms(lambda: csr_to_dense.ell_to_dense(v_n, c_n, n_cols=N_GENES))
    plain_ms = event_ms(lambda: ref.ell_to_dense_ref(vals, cols, N_GENES))
    library_ms = event_ms(lambda: torch.zeros((R, N_GENES), device=dev).index_put_(
        (lib_rows, lib_cols), lib_vals, accumulate=True))
    moved = vals.numel() * 4 + cols.numel() * 4 + R * N_GENES * 4  # each input read, the output written
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, nnz / FP32_FLOP_PER_S * 1e3
    kernel = {"name": "ell_to_dense", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/ell_to_dense.cu",
              "replaces": "src/repro/kernels/csr_to_dense.py:53",
              "shape": [R, K, N_GENES], "nnz": nnz,
              "max_abs_err": max(sweep_err, main_err), "sweep_max_abs_err": sweep_err,
              "path_batch_max_abs_err": main_err,
              # "ms" and "kernel_ms" name one time: readers of the kernels line expect both
              "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
              "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bytes": moved,
              "kernel_ms_by_rows": by_rows}
    emit({"phase": "kernel", **kernel})

    # the same train steps on the card and on the CPU, from the same heads
    gen = torch.Generator().manual_seed(1)
    heads_gpu = probe.init_heads(N_GENES, device=dev, generator=gen)
    heads_cpu = probe.init_heads(N_GENES, device="cpu", generator=torch.Generator().manual_seed(1))
    opt_gpu, opt_cpu = probe.init_adam(heads_gpu), probe.init_adam(heads_cpu)
    step_losses = []
    for b in batches:
        tb = b.to_tensors()
        lc = probe.train_step(heads_cpu, opt_cpu, probe.features(tb["vals"], tb["cols"], n_genes=N_GENES), tb["obs"])
        tg = {"vals": tb["vals"].to(dev), "cols": tb["cols"].to(dev),
              "obs": {k: v.to(dev) for k, v in tb["obs"].items()}}
        lg = probe.train_step(heads_gpu, opt_gpu, probe.features(tg["vals"], tg["cols"], n_genes=N_GENES), tg["obs"])
        step_losses.append((lg.item(), lc.item()))
    for lg, lc in step_losses:
        if not math.isclose(lg, lc, rel_tol=1e-4):
            fail(f"train_step on the card and on the CPU disagree: losses {step_losses}")
    emit({"phase": "step_vs_cpu", "losses_card_cpu": step_losses, "rtol": 1e-4})
    del heads_gpu, heads_cpu, opt_gpu, opt_cpu

    # 5. the main path
    ds = dataset()
    heads = probe.init_heads(N_GENES, device=dev, generator=torch.Generator().manual_seed(0))
    opt = probe.init_adam(heads)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    csr_to_dense.ell_to_dense.launches = 0
    run = probe.train_probe(ds, heads, opt, device=dev)
    launches = csr_to_dense.ell_to_dense.launches
    losses = run["losses"]
    steps = run["steps"]
    if steps < MIN_STEPS:
        fail(f"the epoch gave {steps} steps, fewer than {MIN_STEPS}")
    if launches != steps:
        fail(f"ell_to_dense launched {launches} times in {steps} steps")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss: {losses}")
    first, last = statistics.mean(losses[:20]), statistics.mean(losses[-20:])
    if not last < first:
        fail(f"loss did not fall: first 20 steps {first}, last 20 {last}")
    stream_ms = sorted(run["step_stream_ms"])
    emit({"phase": "main_path", "steps": steps, "batch": BATCH, "fetch_factor": FETCH_FACTOR,
          "block_size": BLOCK, "genes": N_GENES, "cells": len(store),
          "cut": "32,768 cells (two fetches per epoch), not 65,536, to leave time for LM serving",
          "ell_to_dense_launches": launches, "seconds": run["seconds"],
          "samples_per_s": steps * BATCH / run["seconds"],
          "step_ms_mean": run["seconds"] / steps * 1e3,
          "step_stream_ms_median": statistics.median(stream_ms),
          "step_stream_ms_p90": stream_ms[int(0.9 * (len(stream_ms) - 1))],
          "loader_wait_s": run["loader_wait_s"],
          "stream_idle_share": 1 - sum(stream_ms) / 1e3 / run["seconds"],
          "peak_device_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
          "loss_first20": first, "loss_last20": last})

    # 6. a traced window of the next epoch, after the counts were read:
    #    device kernel time by name (the profiler's own cost is in the wall)
    from torch.profiler import ProfilerActivity, profile

    ds.set_epoch(1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = probe.train_probe(ds, heads, opt, device=dev, max_steps=TRACE_STEPS)
    on_card = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_us = sum(e.self_device_time_total for e in on_card)
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:10]
    mine = [e for e in on_card if "ell_to_dense" in e.key]
    if not mine:
        fail("the trace shows no ell_to_dense kernel on the card")
    emit({"phase": "trace", "steps": traced["steps"], "seconds": traced["seconds"],
          "loader_wait_s": traced["loader_wait_s"],
          "device_kernel_ms": kernel_us / 1e3 if on_card else None,
          "device_busy_share": kernel_us / 1e6 / traced["seconds"] if on_card else None,
          "ell_to_dense": {"count": sum(e.count for e in mine),
                           "device_ms": sum(e.self_device_time_total for e in mine) / 1e3,
                           "ms_per_launch": sum(e.self_device_time_total for e in mine) / 1e3
                           / sum(e.count for e in mine)},
          "top_kernels": [[e.key[:80], e.count, e.self_device_time_total / 1e3] for e in top]})

    kernel["launches"] = launches
    emit({"kernels": [{k: kernel[k] for k in KERNEL_KEYS}, lm_kernel, *train_kernels,
                      ssm_kernel]})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


KERNEL_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
               "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")


def _greedy_standalone(model, lm, prompt, max_new: int, max_len: int, dev):
    """Greedy continuation of one prompt at batch 1, and each step's logits."""
    import torch

    cache = model.init_cache(1, max_len, device=dev)
    tokens = torch.as_tensor(prompt[None], dtype=torch.int64, device=dev)
    logits, cache = model.prefill(lm, {"tokens": tokens}, cache)
    toks, lgs = [int(logits[0].argmax())], [logits[0].float().cpu()]
    while len(toks) < max_new:
        logits, cache = model.decode(lm, torch.tensor([toks[-1]], device=dev), cache,
                                     len(prompt) + len(toks) - 1)
        toks.append(int(logits[0].argmax()))
        lgs.append(logits[0].float().cpu())
    return toks, lgs


def _tie_diverged(got, want, lgs, tie: float):
    """None if ``got`` equals ``want``; else the first step where they
    differ, with the gap between the two tokens' logits there, which must
    be under ``tie`` (after an exact tie the rest is not compared)."""
    for j, (g, w) in enumerate(zip(got, want)):
        if g != w:
            gap = abs(float(lgs[j][g]) - float(lgs[j][w]))
            if not gap < tie:
                fail(f"greedy tokens differ at step {j} ({g} vs {w}) with a logit gap {gap} >= {tie}")
            return {"step": j, "gap": gap}
    if len(got) != len(want):
        fail(f"sequences of {len(got)} and {len(want)} tokens")
    return None


def lm_phases(dev, sm_clock_hz: float) -> dict:
    """Phases 7-10, LM serving at smollm-360m's full width; returns the
    kernels-line entry of ``flash_attention``."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import Model
    from repro_torch.serve.scheduler import SlotBatcher

    cfg = get_config(ARCH)
    if (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim) != FULL_WIDTH:
        fail(f"{ARCH} is not at its published width: {cfg}")

    # 7. the kernel against its plain version
    gen = torch.Generator().manual_seed(0)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        worst = 0.0
        for B, H, Hkv, S, T, D in FA_SWEEP:
            q = torch.randn((B, H, S, D), generator=gen).to(dev, dtype)
            k = torch.randn((B, Hkv, T, D), generator=gen).to(dev, dtype)
            v = torch.randn((B, Hkv, T, D), generator=gen).to(dev, dtype)
            for causal, window in FA_MASKS:
                got = fa.flash_attention(q, k, v, causal=causal, window=window)
                want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
                worst = max(worst, (got.float() - want.float()).abs().max().item())
        q = torch.randn((1, 2, 8, 32), generator=gen).to(dev, dtype)
        k = torch.randn((1, 2, 256, 32), generator=gen).to(dev, dtype)
        v = torch.randn((1, 2, 256, 32), generator=gen).to(dev, dtype)
        got = fa.flash_attention(q, k, v, causal=True, q_offset=200)
        want = ref.flash_attention_ref(q, k, v, causal=True, q_offset=200)
        worst = max(worst, (got.float() - want.float()).abs().max().item())
        name = str(dtype).removeprefix("torch.")
        errs[name] = worst
        if not worst <= FA_ATOL[name]:
            fail(f"flash_attention disagrees with its plain version in {name}: {worst} > {FA_ATOL[name]}")

    # the prefill's shape, as the strided (B, S, H, D) views the model passes
    B, S, H, Hkv, D = SERVE_BATCH, SERVE_PROMPT, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    qs = torch.randn((B, S, H, D), generator=gen).to(dev, torch.bfloat16)
    ks = torch.randn((B, S, Hkv, D), generator=gen).to(dev, torch.bfloat16)
    vs = torch.randn((B, S, Hkv, D), generator=gen).to(dev, torch.bfloat16)
    q, k, v = qs.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2)
    hopper_before = fa.hopper_launches
    got = fa.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    if fa.hopper_launches != hopper_before + 1:
        fail(f"the prefill shape took the {fa.route(q, k, v)} kernel, not the Hopper one")
    path_err = (got.float() - want.float()).abs().max().item()
    if not path_err <= FA_ATOL["bfloat16"]:
        fail(f"flash_attention disagrees with its plain version at the prefill shape: {path_err}")
    kernel_ms = event_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    previous_out, _ = previous_kernel(q, k, v, False)
    previous_err = (previous_out.float() - want.float()).abs().max().item()
    if not previous_err <= FA_ATOL["bfloat16"]:
        fail(f"the mma.sync forward disagrees with its plain version at the prefill shape: {previous_err}")
    mma_sync_ms = event_ms(lambda: previous_kernel(q, k, v, False))
    host = host_us({"hopper_wrapper": lambda: fa.flash_attention(q, k, v, causal=True),
                    "previous_wrapper": lambda: previous_kernel(q, k, v, False)})
    plain_ms = event_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True))
    library_ms = event_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                   enable_gqa=True))
    pairs = S * (S + 1) // 2  # (query, key) pairs the causal mask keeps, per head
    moved = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()  # q, k, v read; o written
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * B * H * D * pairs / BF16_FLOP_PER_S * 1e3
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    exp_ms = B * H * pairs / (SFU_EXP2_PER_CLOCK_PER_SM * sms * sm_clock_hz) * 1e3  # one per pair
    kernel = {"name": "flash_attention", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
              "replaces": "src/repro/kernels/flash_attention.py:86",
              "kernel": "flash_fwd_hopper", "previous_kernel": "flash_fwd_bf16 (mma.sync)",
              "previous_kernel_ms": mma_sync_ms, "host_us_per_call": host,
              "shape": [B, H, Hkv, S, S, D], "dtype": "bfloat16",
              "max_abs_err": max(path_err, *errs.values()), "sweep_max_abs_err": errs,
              "path_shape_max_abs_err": path_err,
              "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "library": "scaled_dot_product_attention",
              "bound_ms": max(bytes_ms, ops_ms),
              "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
              "bound_parts_ms": {"bytes": bytes_ms, "tensor_cores": ops_ms, "exponentials": exp_ms},
              "bytes": moved, "flop": 4 * B * H * D * pairs}
    emit({"phase": "flash_kernel", **kernel})
    del q, k, v, qs, ks, vs, got, want, previous_out

    # 8. the card against the CPU at full width in float32
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    model32 = Model(cfg32)
    lm_cpu = model32.init(generator=torch.Generator().manual_seed(1), device="cpu")
    lm32 = copy.deepcopy(lm_cpu).to(dev)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, CPU_PROMPT)))
    max_len = CPU_PROMPT + CPU_DECODE
    caches = {"cpu": model32.init_cache(1, max_len, device="cpu"),
              "card": model32.init_cache(1, max_len, device=dev)}
    want, _ = model32.prefill(lm_cpu, {"tokens": prompt}, caches["cpu"])
    got, _ = model32.prefill(lm32, {"tokens": prompt.to(dev)}, caches["card"])
    steps = [(got.cpu(), want)]
    tok = want.argmax(-1)  # both sides decode the CPU's greedy tokens
    for i in range(CPU_DECODE):
        want, _ = model32.decode(lm_cpu, tok, caches["cpu"], CPU_PROMPT + i)
        got, _ = model32.decode(lm32, tok.to(dev), caches["card"], CPU_PROMPT + i)
        steps.append((got.cpu(), want))
        tok = want.argmax(-1)
    cpu_err, ties = 0.0, 0
    for g, w in steps:
        if not bool(torch.isfinite(g).all()):
            fail("non-finite logits on the card")
        if not torch.allclose(g, w, rtol=CPU_RTOL, atol=CPU_ATOL):
            fail(f"card and CPU logits disagree: max err {(g - w).abs().max().item()}")
        cpu_err = max(cpu_err, (g - w).abs().max().item())
        gt, wt = int(g[0].argmax()), int(w[0].argmax())
        if gt != wt:
            if not abs(float(w[0, gt]) - float(w[0, wt])) < TIE_F32:
                fail(f"greedy tokens differ off a tie: card {gt}, CPU {wt}")
            ties += 1
    emit({"phase": "lm_vs_cpu", "arch": ARCH, "layers": cfg.num_layers, "dtype": "float32",
          "prompt": CPU_PROMPT, "decode_steps": CPU_DECODE, "max_abs_err": cpu_err,
          "max_abs_logit": max(w.abs().max().item() for _, w in steps),
          "rtol": CPU_RTOL, "atol": CPU_ATOL, "greedy_ties": ties})
    del lm_cpu, caches

    # 9. the main path: serve_batch at full width in bf16
    model = Model(cfg)
    params = model.init(generator=torch.Generator().manual_seed(0), device=dev)
    prompts = rng.integers(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    # a warm-up serve at the same shapes: the caching allocator's first
    # cudaMallocs and cuBLAS's first choice of algorithms stay out of the times
    serve_batch(model, prompts, SERVE_GEN, params=params, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    timings = {}
    fa.flash_attention.launches = 0
    fa.hopper_launches = 0
    toks = serve_batch(model, prompts, SERVE_GEN, params=params, device=dev, timings=timings)
    launches, hopper = fa.flash_attention.launches, fa.hopper_launches
    if launches != cfg.num_layers:
        fail(f"flash_attention launched {launches} times in one prefill of {cfg.num_layers} layers")
    if hopper != launches:
        fail(f"{hopper} of the prefill's {launches} attention launches took the Hopper kernel")
    if toks.shape != (SERVE_BATCH, SERVE_GEN) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        fail(f"serve_batch gave tokens of shape {toks.shape} outside the vocabulary")
    peak = torch.cuda.max_memory_allocated(dev)
    decode_ms = timings["decode_s"] / timings["decode_steps"] * 1e3

    cache = model.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_GEN, device=dev)
    batch = {"tokens": torch.from_numpy(prompts.astype(np.int64)).to(dev)}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.prefill(params, batch, cache)
        torch.cuda.synchronize()
    on_card = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    mine = [e for e in on_card if "flash_fwd" in e.key]
    if not mine:
        fail("the trace shows no flash_attention kernel on the card")
    prefill_kernel_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    fa_ms = sum(e.self_device_time_total for e in mine) / 1e3
    fa_n = sum(e.count for e in mine)
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:8]
    emit({"phase": "serve", "arch": ARCH, "layers": cfg.num_layers, "d_model": cfg.d_model,
          "dtype": cfg.compute_dtype, "batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
          "gen": SERVE_GEN, "prefill_ms": timings["prefill_s"] * 1e3,
          "decode_ms_per_step": decode_ms,
          "decode_tokens_per_s": SERVE_BATCH * timings["decode_steps"] / timings["decode_s"],
          "peak_device_mem_gb": peak / 1e9, "flash_attention_launches": launches,
          "hopper_launches": hopper,
          "prefills": 1, "traced_prefill_device_kernel_ms": prefill_kernel_ms,
          "flash_attention_trace": {"count": fa_n, "device_ms": fa_ms, "ms_per_launch": fa_ms / fa_n,
                                    "share_of_prefill_kernel_time": fa_ms / prefill_kernel_ms},
          "top_kernels": [[e.key[:80], e.count, e.self_device_time_total / 1e3] for e in top]})
    kernel["launches"] = launches
    kernel["hopper_launches"] = hopper
    kernel["trace_ms_per_launch"] = fa_ms / fa_n
    del params, cache

    # 10. continuous batching at full width in float32
    brng = np.random.default_rng(0)
    lens = brng.integers(BATCH_PROMPT_LENS[0], BATCH_PROMPT_LENS[1] + 1, BATCH_REQUESTS)
    max_new = brng.integers(BATCH_NEW[0], BATCH_NEW[1] + 1, BATCH_REQUESTS)
    prompts = [brng.integers(0, cfg.vocab_size, int(n)).astype(np.int32) for n in lens]
    batcher = SlotBatcher(model32, lm32, batch_slots=BATCH_SLOTS, max_len=BATCH_MAX_LEN)
    for p, m in zip(prompts, max_new):
        batcher.submit(p, int(m))
    t0 = time.perf_counter()
    done = batcher.run()
    batch_s = time.perf_counter() - t0
    if [r.rid for r in done] != list(range(BATCH_REQUESTS)) or not all(r.done for r in done):
        fail(f"the batcher completed {[r.rid for r in done]}")
    diverged = []
    for req, p, m in zip(done, prompts, max_new):
        want, lgs = _greedy_standalone(model32, lm32, p, int(m), BATCH_MAX_LEN, dev)
        tie = _tie_diverged(req.out, want, lgs, TIE_F32)
        if tie is not None:
            diverged.append({"rid": req.rid, **tie})
    emit({"phase": "batching", "dtype": "float32", "slots": BATCH_SLOTS,
          "requests": BATCH_REQUESTS, "max_len": BATCH_MAX_LEN,
          "prompt_lens": lens.tolist(), "max_new": max_new.tolist(),
          "tokens": int(sum(len(r.out) for r in done)), "cursor_end": batcher.pos,
          "seconds": batch_s, "ties": diverged})
    del lm32, batcher
    return {k: kernel[k] for k in (*KERNEL_KEYS, "dtype", "library", "trace_ms_per_launch",
                                     "kernel", "hopper_launches", "previous_kernel",
                                     "previous_kernel_ms", "host_us_per_call", "bound_parts_ms")}


def _scaled_err(got, want, atol: float, rtol: float) -> tuple[float, float]:
    """(max |got - want|, max |got - want| / (atol + rtol |want|)): the
    second is at most 1 within the tolerance."""
    d = (got.float() - want.float()).abs()
    return d.max().item(), (d / (atol + rtol * want.float().abs())).max().item()


def _rms_err(got, want) -> tuple[float, float, float]:
    """(max |got - want|, the same over the training shape's tolerance,
    rms(want)); the second is at most 1 within the tolerance."""
    want = want.float()
    rms = want.square().mean().sqrt().item()
    return _scaled_err(got, want, TRAIN_TOL_RMS * rms, TRAIN_TOL_REL) + (rms,)


def attention_errors(q, k, v, dout, causal, window, err):
    """The training attention kernels (forward with lse, dq, dk/dv) against
    their plain versions on these inputs: ``err(got, want)`` of the forward's
    out, dq and the worse of dk and dv (the one with the larger second
    item), and (max, max / 1e-4) of lse.  Returns ``(errors, outputs)``."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ref

    out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal, window=window)
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    dq = fab.flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=causal, window=window)
    dk, dv = fab.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal=causal, window=window)
    w_out, w_lse = ref.flash_attention_fwd_lse_ref(q, k, v, causal=causal, window=window)
    wq, wk, wv = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                             window=window)
    torch.cuda.synchronize()
    errs = {"fwd": err(out, w_out), "lse": _scaled_err(lse, w_lse, 1e-4, 0.0),
            "dq": err(dq, wq), "dkv": max(err(dk, wk), err(dv, wv), key=lambda e: e[1])}
    return errs, (out, lse, delta)


def train_phases(dev, sm_clock_hz: float, sdpa_bwd_kernels: list) -> list:
    """Phases 11-14, LM training at smollm-360m's full width; returns the
    kernels-line entries of the forward with lse, dq and dk/dv.
    ``sdpa_bwd_kernels``: the names :func:`sdpa_backward_kernels` found,
    printed in phase 11."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.distributed.fault import run_with_restarts
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ref
    from repro_torch.launch.train import build_loader, train_loop
    from repro_torch.models import Model
    from repro_torch.train.optimizer import AdamWConfig, constant_lr
    from repro_torch.train.step import make_train_state, make_train_step

    cfg = get_config(ARCH)

    # 11. the three kernels against their plain versions
    gen = torch.Generator().manual_seed(3)
    worst = {}  # (kernel, dtype) -> (abs, scaled)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for B, H, Hkv, S, T, D in BWD_SWEEP:
            q = torch.randn((B, H, S, D), generator=gen).to(dev, dtype)
            k = torch.randn((B, Hkv, T, D), generator=gen).to(dev, dtype)
            v = torch.randn((B, Hkv, T, D), generator=gen).to(dev, dtype)
            dout = torch.randn((B, H, S, D), generator=gen).to(dev, dtype)
            for causal, window in BWD_MASKS:
                errs, _ = attention_errors(q, k, v, dout, causal, window,
                                           lambda g, w: _scaled_err(g, w, *BWD_TOL[name]))
                for kern, e in errs.items():
                    old = worst.get((kern, name), (0.0, 0.0))
                    worst[(kern, name)] = (max(old[0], e[0]), max(old[1], e[1]))
    bad = {f"{k}/{n}": e for (k, n), e in worst.items() if not e[1] <= 1.0}
    if bad:
        fail(f"training attention kernels disagree with their plain versions on the sweep: {bad}")

    B, S, H, Hkv, D = TRAIN_BATCH, TRAIN_SEQ, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    bf = torch.bfloat16
    qs = torch.randn((B, S, H, D), generator=gen).to(dev, bf)
    ks = torch.randn((B, S, Hkv, D), generator=gen).to(dev, bf)
    vs = torch.randn((B, S, Hkv, D), generator=gen).to(dev, bf)
    q, k, v = qs.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2)
    dout = torch.randn((B, H, S, D), generator=gen).to(dev, bf)
    hopper_before = (fa.hopper_launches, fab.hopper_launches)
    path, (out, lse, delta) = attention_errors(q, k, v, dout, True, None, _rms_err)
    if fa.hopper_launches != hopper_before[0] + 1:
        fail(f"the training shape's forward took the {fa.route(q, k, v)} kernel, not the Hopper one")
    if fab.hopper_launches != hopper_before[1] + 2:
        fail(f"the training shape's backward took the {fab.route(q, k, v, dout)} kernels, not the "
             f"Hopper ones")
    if not all(e[1] <= 1.0 for e in path.values()):
        fail(f"training attention kernels disagree with their plain versions at the training shape: {path}")
    path_sweep_tol, _ = attention_errors(q, k, v, dout, True, None,
                                         lambda g, w: _scaled_err(g, w, *BWD_TOL["bfloat16"]))
    if not all(e[1] <= 1.0 for e in path_sweep_tol.values()):
        fail(f"training attention kernels exceed the sweep's bf16 tolerance at the training shape: "
             f"{path_sweep_tol}")
    mutants = _flash_mutants(q, k, v, *ref.flash_attention_fwd_lse_ref(q, k, v, causal=True))
    failing = {n: max(e["out"][1], e["lse"][1]) for n, e in mutants.items()}
    weak = {n: r for n, r in failing.items() if n != "shipped" and r < FLASH_MUTANT_MIN}
    if weak:
        fail(f"mutants of the Hopper forward pass the rule with less than {FLASH_MUTANT_MIN}x: {weak}")
    if failing["shipped"] > 1.0:
        fail(f"the unedited Hopper forward built as a mutant fails the rule: {mutants['shipped']}")
    wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=True)
    bwd_mutants = _bwd_mutants(q, k, v, dout, lse, delta, wants)
    bwd_failing = {n: max(e[1] for e in errs.values()) for n, errs in bwd_mutants.items()}
    weak = {n: r for n, r in bwd_failing.items() if n != "shipped" and not r >= FLASH_MUTANT_MIN}
    if weak:
        fail(f"mutants of the Hopper backward pass the rule with less than {FLASH_MUTANT_MIN}x: {weak}")
    if not bwd_failing["shipped"] <= 1.0:
        fail(f"the unedited Hopper backward built as a mutant fails the rule: {bwd_mutants['shipped']}")
    # the mma.sync backward kernels the Hopper route replaced, held to the same rule
    (prev_dq,), (prev_dk, prev_dv) = (previous_bwd(q, k, v, dout, lse, delta, d) for d in (False, True))
    torch.cuda.synchronize()
    prev_err = {n: _rms_err(g, w) for n, g, w in zip(("dq", "dk", "dv"), (prev_dq, prev_dk, prev_dv),
                                                     wants)}
    if not all(e[1] <= 1.0 for e in prev_err.values()):
        fail(f"the mma.sync backward kernels disagree with their plain version: {prev_err}")
    del wants, prev_dq, prev_dk, prev_dv
    times = {
        "fwd": event_ms(lambda: fa.flash_attention_fwd_lse(q, k, v, causal=True)),
        "dq": event_ms(lambda: fab.flash_attention_bwd_dq(q, k, v, dout, lse, delta)),
        "dkv": event_ms(lambda: fab.flash_attention_bwd_dkv(q, k, v, dout, lse, delta)),
    }
    previous_ms = {
        "fwd": event_ms(lambda: previous_kernel(q, k, v, True)),
        "dq": event_ms(lambda: previous_bwd(q, k, v, dout, lse, delta, False)),
        "dkv": event_ms(lambda: previous_bwd(q, k, v, dout, lse, delta, True)),
    }
    host = host_us({"fwd/hopper_wrapper": lambda: fa.flash_attention_fwd_lse(q, k, v, causal=True),
                    "fwd/previous_wrapper": lambda: previous_kernel(q, k, v, True),
                    "dq/hopper_wrapper": lambda: fab.flash_attention_bwd_dq(q, k, v, dout, lse, delta),
                    "dq/previous_wrapper": lambda: previous_bwd(q, k, v, dout, lse, delta, False),
                    "dkv/hopper_wrapper": lambda: fab.flash_attention_bwd_dkv(q, k, v, dout, lse, delta),
                    "dkv/previous_wrapper": lambda: previous_bwd(q, k, v, dout, lse, delta, True)})
    plain = {
        "fwd": event_ms(lambda: ref.flash_attention_fwd_lse_ref(q, k, v, causal=True)),
        "bwd": event_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=True)),
    }
    with torch.no_grad():
        sdpa_fwd_ms = event_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                      enable_gqa=True))
    # SDPA's backward alone: autograd.grad over one saved forward, its graph kept
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o_sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)

    def sdpa_bwd():
        torch.autograd.grad(o_sdpa, (qg, kg, vg), dout, retain_graph=True)

    sdpa_bwd_ms = event_ms(sdpa_bwd)
    del qg, kg, vg, o_sdpa

    pairs = S * (S + 1) // 2
    qb, kb = q.numel() * 2, k.numel() * 2  # bf16 bytes of q (= dO, o, dq) and of k (= v, dk, dv)
    rows = B * H * S * 4  # float32 bytes of lse (= delta)
    work = {  # (bytes, flop): inputs read once, outputs written once
        "fwd": (qb + 2 * kb + qb + rows, 4 * B * H * D * pairs),
        "dq": (qb + 2 * kb + qb + 2 * rows + qb, 6 * B * H * D * pairs),
        "dkv": (qb + 2 * kb + qb + 2 * rows + 2 * kb, 8 * B * H * D * pairs),
    }
    src = "src/repro_torch/kernels/csrc/"
    sdpa_bwd_name = "scaled_dot_product_attention backward alone (dq, dk and dv in one call)"
    meta = {
        "fwd": ("flash_attention_fwd_lse", src + "flash_attention.cu",
                "src/repro/kernels/flash_attention_bwd.py:164", plain["fwd"], sdpa_fwd_ms,
                "scaled_dot_product_attention forward"),
        "dq": ("flash_attention_bwd_dq", src + "flash_attention_bwd.cu",
               "src/repro/kernels/flash_attention_bwd.py:81", plain["bwd"], sdpa_bwd_ms,
               sdpa_bwd_name),
        "dkv": ("flash_attention_bwd_dkv", src + "flash_attention_bwd.cu",
                "src/repro/kernels/flash_attention_bwd.py:115", plain["bwd"], sdpa_bwd_ms,
                sdpa_bwd_name),
    }
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    exp_ms = B * H * pairs / (SFU_EXP2_PER_CLOCK_PER_SM * sms * sm_clock_hz) * 1e3  # one per visible pair
    hopper_kernel = {"fwd": ("flash_fwd_hopper", "flash_fwd_bf16 (mma.sync)", failing),
                     "dq": ("flash_bwd_dq_hopper", "dq_bf16 (mma.sync)", bwd_failing),
                     "dkv": ("flash_bwd_dkv_hopper", "dkv_bf16 (mma.sync)", bwd_failing)}
    kernels = {}
    for key, (name, source, replaces, plain_ms, lib_ms, lib) in meta.items():
        nbytes, flop = work[key]
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flop / BF16_FLOP_PER_S * 1e3
        err = max(worst[(key, "float32")][0], worst[(key, "bfloat16")][0], path[key][0])
        if key == "fwd":
            err = max(err, worst[("lse", "float32")][0], worst[("lse", "bfloat16")][0], path["lse"][0])
        kernels[key] = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "shape": [B, H, Hkv, S, S, D], "dtype": "bfloat16", "max_abs_err": err,
            "ms": times[key], "kernel_ms": times[key], "plain_ms": plain_ms,
            "plain": "flash_attention_bwd_ref (dq, dk and dv in one call)" if key != "fwd"
            else "flash_attention_fwd_lse_ref",
            "library_ms": lib_ms, "library": lib,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bytes": nbytes,
            "flop": flop, "want_rms": path[key][2],
            "kernel": hopper_kernel[key][0], "previous_kernel": hopper_kernel[key][1],
            "previous_kernel_ms": previous_ms[key],
            "host_us_per_call": {w: host[f"{key}/{w}"] for w in ("hopper_wrapper", "previous_wrapper")},
            "mutant_err_of_rule": hopper_kernel[key][2],
            "bound_parts_ms": {"bytes": bytes_ms, "tensor_cores": ops_ms, "exponentials": exp_ms}}
    kernels["dq"]["previous_kernel_err"] = prev_err["dq"]
    kernels["dkv"]["previous_kernel_err"] = max(prev_err["dk"], prev_err["dv"], key=lambda e: e[1])
    emit({"phase": "train_kernels", "sweep_errors": {f"{k}/{n}": e for (k, n), e in worst.items()},
          "training_shape_errors": path, "training_shape_errors_of_sweep_tol": path_sweep_tol,
          "tolerance": BWD_TOL,
          "training_shape_tolerance": {"rms": TRAIN_TOL_RMS, "rel": TRAIN_TOL_REL},
          "kernels_sum_ms": sum(times.values()), "bwd_pair_ms": times["dq"] + times["dkv"],
          "sdpa_fwd_ms": sdpa_fwd_ms, "sdpa_bwd_ms": sdpa_bwd_ms,
          "sdpa_bwd_kernels": sdpa_bwd_kernels,
          "previous_kernel_ms": previous_ms, "previous_bwd_errors": prev_err,
          "host_us_per_call": host,
          "mutants": mutants, "bwd_mutants": bwd_mutants, "mutant_min_err_of_rule": FLASH_MUTANT_MIN,
          **{f"{k}_ms": t for k, t in times.items()},
          **{f"{k}_bound_ms": kernels[k]["bound_ms"] for k in kernels},
          **{f"plain_{k}_ms": t for k, t in plain.items()}})
    del q, k, v, qs, ks, vs, dout, out, lse, delta

    # 12. one float32 train step at full width on the card and on the CPU
    cfg32 = dataclasses.replace(cfg, num_layers=CPU_STEP_LAYERS, param_dtype="float32",
                                compute_dtype="float32")
    model32 = Model(cfg32)
    opt_cfg = AdamWConfig(lr=constant_lr(CPU_STEP_LR), weight_decay=0.01)
    lm_cpu = model32.init(generator=torch.Generator().manual_seed(2), device="cpu")
    lm_gpu = copy.deepcopy(lm_cpu).to(dev)
    seq = np.random.default_rng(1).integers(0, cfg.vocab_size, (CPU_STEP_BATCH, CPU_STEP_SEQ + 1))
    batch = {"tokens": torch.from_numpy(seq[:, :-1]), "labels": torch.from_numpy(seq[:, 1:])}
    states = {"cpu": make_train_state(model32, opt_cfg, params=lm_cpu),
              "card": make_train_state(model32, opt_cfg, params=lm_gpu)}
    before = {n: p.detach().clone() for n, p in lm_cpu.named_parameters()}
    step_fn = make_train_step(model32, opt_cfg)
    _, m_cpu = step_fn(states["cpu"], batch)
    _, m_gpu = step_fn(states["card"], {k: t.to(dev) for k, t in batch.items()})
    loss_rel = abs(float(m_gpu["loss"]) / float(m_cpu["loss"]) - 1)
    gnorm_rel = abs(float(m_gpu["grad_norm"]) / float(m_cpu["grad_norm"]) - 1)
    if not (loss_rel <= CPU_LOSS_RTOL and gnorm_rel <= CPU_GNORM_RTOL):
        fail(f"a train step on the card and on the CPU disagree: loss {float(m_gpu['loss'])} vs "
             f"{float(m_cpu['loss'])}, grad norm {float(m_gpu['grad_norm'])} vs {float(m_cpu['grad_norm'])}")
    gpu_params = dict(lm_gpu.named_parameters())
    share, worst_p, moved = 1.0, 0.0, 0.0
    for n, p in lm_cpu.named_parameters():
        d = (gpu_params[n].detach().cpu() - p.detach()).abs()
        share = min(share, float((d <= CPU_PARAM_TOL).float().mean()))
        worst_p = max(worst_p, float(d.max()))
        moved = max(moved, float((p.detach() - before[n]).abs().max()))
    if not (share >= CPU_PARAM_SHARE and worst_p <= 2 * CPU_STEP_LR + CPU_PARAM_TOL):
        fail(f"updated parameters on the card and the CPU disagree: {share} of a tensor within "
             f"{CPU_PARAM_TOL}, max err {worst_p}")
    emit({"phase": "train_vs_cpu", "layers": CPU_STEP_LAYERS, "dtype": "float32",
          "batch": [CPU_STEP_BATCH, CPU_STEP_SEQ], "loss_card": float(m_gpu["loss"]),
          "loss_cpu": float(m_cpu["loss"]), "loss_rel_err": loss_rel,
          "grad_norm_card": float(m_gpu["grad_norm"]), "grad_norm_cpu": float(m_cpu["grad_norm"]),
          "grad_norm_rel_err": gnorm_rel, "param_min_share_within_tol": share,
          "param_max_abs_err": worst_p, "param_max_update": moved})
    del lm_cpu, lm_gpu, states, gpu_params, before

    # 13. the main path: main's build_loader and train_loop at full width and depth
    model = Model(cfg)
    corpus = os.path.join(HERE, "build", "chip_smoke_corpus")
    t0 = time.perf_counter()
    loader = build_loader(corpus, TRAIN_SEQ, TRAIN_BATCH, n_tokens=TRAIN_CORPUS_TOKENS,
                          vocab_size=min(cfg.vocab_size, 1024))
    corpus_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    timings = {}
    fa.flash_attention_fwd_lse.launches = 0
    fab.flash_attention_bwd_dq.launches = 0
    fab.flash_attention_bwd_dkv.launches = 0
    fab.flash_attention_bwd_dq.hopper_launches = 0
    fab.flash_attention_bwd_dkv.hopper_launches = 0
    fa.hopper_launches = 0
    fab.hopper_launches = 0
    total = TRAIN_WARMUP + TRAIN_STEPS
    t0 = time.perf_counter()
    run = train_loop(model, loader, steps=total, log_every=1, device=dev, timings=timings)
    wall = time.perf_counter() - t0
    launches = {"fwd": fa.flash_attention_fwd_lse.launches,
                "dq": fab.flash_attention_bwd_dq.launches,
                "dkv": fab.flash_attention_bwd_dkv.launches}
    per_step = {"fwd": 2 * cfg.num_layers, "dq": cfg.num_layers, "dkv": cfg.num_layers}
    if launches != {k: n * total for k, n in per_step.items()}:
        fail(f"the training kernels launched {launches} times in {total} steps; "
             f"need {per_step} per step")
    hopper = fa.hopper_launches
    if hopper != launches["fwd"]:
        fail(f"{hopper} of the {launches['fwd']} training forwards took the Hopper kernel")
    hopper_bwd = {"dq": fab.flash_attention_bwd_dq.hopper_launches,
                  "dkv": fab.flash_attention_bwd_dkv.hopper_launches}
    for key, n in hopper_bwd.items():
        if n != launches[key]:
            fail(f"{n} of the {launches[key]} {key} launches took the Hopper kernel")
    bwd_hopper = fab.hopper_launches
    if bwd_hopper != sum(hopper_bwd.values()):
        fail(f"the module counts {bwd_hopper} Hopper backward launches, its entry points "
             f"{hopper_bwd}")
    losses = [m["loss"] for m in run["metrics"]]
    if len(losses) != total or not all(math.isfinite(x) for x in losses):
        fail(f"non-finite or missing losses: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"loss did not fall: {losses[0]} at the first step, {losses[-1]} at the last")
    step_s = timings["step_s"]
    timed = sorted(step_s[TRAIN_WARMUP:])
    med = statistics.median(timed)
    # the timed steps' wall, loader included: end of the last warm-up step
    # to the end of the last step
    timed_wall = timings["end"][-1] - timings["end"][TRAIN_WARMUP - 1]
    fetch_share = sum(timings["fetch_s"][TRAIN_WARMUP:]) / timed_wall
    peak = torch.cuda.max_memory_allocated(dev)

    # one more step under the profiler (the counts were read above)
    step_fn = make_train_step(model, AdamWConfig(lr=constant_lr(3e-4), weight_decay=0.01))
    tb = {k: torch.from_numpy(np.asarray(next(iter(loader))[k])).to(dev) for k in ("tokens", "labels")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step_fn(run["final_state"], tb)
        torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    on_card = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    step_kernel_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    trace = {}
    for key, pat in (("fwd", "flash_fwd_hopper"), ("dq", "flash_bwd_dq_hopper"),
                     ("dkv", "flash_bwd_dkv_hopper")):
        mine = [e for e in on_card if pat in e.key]
        n = sum(e.count for e in mine)
        if n != per_step[key]:
            fail(f"the traced step shows {n} launches of {pat}, not {per_step[key]}")
        ms = sum(e.self_device_time_total for e in mine) / 1e3
        trace[key] = {"count": n, "device_ms": ms, "ms_per_launch": ms / n}
        kernels[key]["launches"] = launches[key]  # in the main path's run of `total` steps
        kernels[key]["launches_per_step"] = launches[key] // total
        kernels[key]["trace_ms_per_launch"] = ms / n
    kernels["fwd"]["hopper_launches"] = hopper
    kernels["dq"]["hopper_launches"] = hopper_bwd["dq"]
    kernels["dkv"]["hopper_launches"] = hopper_bwd["dkv"]
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:10]
    emit({"phase": "train", "arch": ARCH, "layers": cfg.num_layers, "d_model": cfg.d_model,
          "dtype": cfg.compute_dtype, "remat": cfg.remat, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "corpus_tokens": TRAIN_CORPUS_TOKENS, "corpus_vocab": min(cfg.vocab_size, 1024),
          "corpus_s": corpus_s, "warmup_steps": TRAIN_WARMUP, "timed_steps": TRAIN_STEPS,
          "step_ms_median": med * 1e3, "step_ms_p90": timed[int(0.9 * (len(timed) - 1))] * 1e3,
          "step_ms_first": step_s[0] * 1e3, "wall_s": wall,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med, "timed_wall_s": timed_wall,
          "wall_tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * TRAIN_STEPS / timed_wall,
          "loader_share_of_wall": fetch_share,
          "fetch_ms_median": statistics.median(timings["fetch_s"][TRAIN_WARMUP:]) * 1e3,
          "loss_first": losses[0],
          "loss_last": losses[-1], "peak_device_mem_gb": peak / 1e9,
          "launches_per_step": {k: v // total for k, v in launches.items()},
          "hopper_launches_per_step": {"fwd": hopper // total,
                                       **{k: n // total for k, n in hopper_bwd.items()}},
          "traced_step_s": traced_s, "traced_step_device_kernel_ms": step_kernel_ms,
          "traced_step_device_busy_share": step_kernel_ms / 1e3 / traced_s,
          "attention_kernels_share_of_device_ms":
              sum(t["device_ms"] for t in trace.values()) / step_kernel_ms,
          "trace": trace,
          "top_kernels": [[e.key[:80], e.count, e.self_device_time_total / 1e3] for e in top]})
    del run, loader, step_fn, tb
    torch.cuda.empty_cache()

    # 14. crash and resume at full width with 4 layers: bitwise
    cfg4 = dataclasses.replace(cfg, num_layers=RESUME_LAYERS)
    model4 = Model(cfg4)
    ck_root = os.path.join(HERE, "build", "chip_smoke_ckpt")
    shutil.rmtree(ck_root, ignore_errors=True)

    def loader4():
        return build_loader(corpus, TRAIN_SEQ, TRAIN_BATCH, n_tokens=TRAIN_CORPUS_TOKENS,
                            vocab_size=min(cfg.vocab_size, 1024))

    t0 = time.perf_counter()
    want = train_loop(model4, loader4(), steps=RESUME_STEPS, ckpt_dir=os.path.join(ck_root, "ref"),
                      ckpt_every=RESUME_EVERY, log_every=100, device=dev)["final_state"]
    restarts = []

    def work(resume: bool):
        return train_loop(model4, loader4(), steps=RESUME_STEPS,
                          ckpt_dir=os.path.join(ck_root, "crashy"), ckpt_every=RESUME_EVERY,
                          log_every=100, resume=resume,
                          crash_after=None if resume else RESUME_CRASH, device=dev)

    got = run_with_restarts(work, max_restarts=1, on_restart=lambda n, e: restarts.append(str(e)))
    got = got["final_state"]
    resume_s = time.perf_counter() - t0
    if len(restarts) != 1 or "injected crash" not in restarts[0]:
        fail(f"the resume phase restarted {restarts}")
    wp, gp = dict(want["params"].named_parameters()), dict(got["params"].named_parameters())
    differ = [n for n in wp if not torch.equal(wp[n], gp[n])]
    differ += [f"m/{n}" for n in wp if not torch.equal(want["opt"].m[n], got["opt"].m[n])]
    differ += [f"v/{n}" for n in wp if not torch.equal(want["opt"].v[n], got["opt"].v[n])]
    if differ or got["step"] != want["step"]:
        fail(f"the resumed run differs from the uninterrupted one in {differ[:8]}")
    emit({"phase": "resume", "layers": RESUME_LAYERS, "steps": RESUME_STEPS,
          "ckpt_every": RESUME_EVERY, "crash_after": RESUME_CRASH, "restarts": restarts,
          "resumed_from": RESUME_EVERY * (RESUME_CRASH // RESUME_EVERY), "bitwise_equal": True,
          "tensors_compared": 3 * len(wp), "seconds": resume_s})
    shutil.rmtree(ck_root, ignore_errors=True)
    del want, got, wp, gp
    extra = ("kernel", "hopper_launches", "previous_kernel", "previous_kernel_ms",
             "host_us_per_call", "mutant_err_of_rule", "bound_parts_ms")
    return [{k: kernels[key][k] for k in (*KERNEL_KEYS, "dtype", "library", "plain",
                                             "trace_ms_per_launch", "launches_per_step", "bytes",
                                             "flop", "want_rms", *extra)}
            for key in ("fwd", "dq", "dkv")]


def _ssm_inputs(B, S, Dm, N, dtype, dev, gen):
    """The scan's inputs with the model's distributions and layouts: x one
    half of a wider projection, dt log-uniform in [1e-3, 1e-1] (mamba's dt
    init), A near -(1..N), B and C column slices of a float32 x_proj output
    (after dt_rank = 256 columns), D near 1, h0 ~ N(0, 0.3)."""
    import torch

    xz = torch.randn((B, S, 2 * Dm), generator=gen, device=dev).to(dtype)
    dt = torch.exp(torch.empty((B, S, Dm), device=dev).uniform_(math.log(1e-3), math.log(1e-1),
                                                               generator=gen))
    A = -torch.exp(torch.log(torch.arange(1, N + 1, device=dev).float())[None]
                   + 0.1 * torch.randn((Dm, N), generator=gen, device=dev))
    xdb = torch.randn((B, S, 256 + 2 * N), generator=gen, device=dev)
    D = 1 + 0.1 * torch.randn((Dm,), generator=gen, device=dev)
    h0 = 0.3 * torch.randn((B, Dm, N), generator=gen, device=dev)
    return xz[..., :Dm], dt, A, xdb[..., 256:256 + N], xdb[..., 256 + N:], D, h0


def _rule_err(got, want, dtype_name: str) -> tuple[float, float, float]:
    """(max |got - want|, the same over SSM_RULE[dtype_name], rms(want));
    the second is at most 1 within the rule."""
    want = want.float()
    a, r = SSM_RULE[dtype_name]
    rms = want.square().mean().sqrt().item()
    return _scaled_err(got, want, a * rms, r) + (rms,)


def _build_mutants(source: str, edits: dict, bind) -> tuple[dict, str]:
    """Build ``csrc/<source>.cu`` unedited (as ``shipped``) and once per
    (old, new) edit of ``edits``, each line occurring once in the source,
    all under ``build/<source>_mutants`` with the port's flags and its
    headers; returns ({name: the library bound by ``bind``}, that
    directory, which the caller removes)."""
    import ctypes

    from repro_torch.kernels import _build

    src = (_build.CSRC / f"{source}.cu").read_text()
    out_dir = os.path.join(HERE, "build", f"{source}_mutants")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    jobs = {}
    for name, edit in {"shipped": None, **edits}.items():
        text = src
        if edit is not None:
            if src.count(edit[0]) != 1:
                fail(f"mutant {name}: its line occurs {src.count(edit[0])} times in {source}.cu")
            text = src.replace(edit[0], edit[1])
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", so, cu]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            fail(f"mutant {name} of {source}.cu did not build:\n{log}")
        libs[name] = bind(ctypes.CDLL(so))
    return libs, out_dir


def _ssm_mutants(dev, inputs) -> dict:
    """Run the unedited ssm_scan and each of SSM_MUTANTS, built by
    :func:`_build_mutants`, on ``inputs`` into zero-filled outputs; return
    each one's (y, h_final) errors against the plain version over the rule."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ssm

    libs, out_dir = _build_mutants("ssm_scan", SSM_MUTANTS, ssm.bind)
    x, dt, A, Bc, Cc, D, h0 = inputs
    want_y, want_h = ref.ssm_scan_ref(*inputs)
    result = {}
    for name, lib in libs.items():
        y = torch.zeros(x.shape, dtype=x.dtype, device=dev)
        h = torch.zeros(h0.shape, dtype=torch.float32, device=dev)
        ssm.launch(lib, x, dt, A, Bc, Cc, D, h0, y, h)
        torch.cuda.synchronize()
        result[name] = {"y": _rule_err(y, want_y, str(x.dtype).removeprefix("torch.")),
                        "h_final": _rule_err(h, want_h, "float32")}
    shutil.rmtree(out_dir, ignore_errors=True)
    return result


def _flash_mutants(q, k, v, want_out, want_lse) -> dict:
    """Run the unedited Hopper forward and each of FLASH_MUTANTS, built by
    :func:`_build_mutants`, on the training shape's causal inputs; return
    each one's out error over the training rule and lse's over 1e-4, as
    (max abs, over the rule[, rms(want)]).  An lse of -inf (a row left
    without keys) counts as -1e30, so that every error stays a finite
    number in the JSON lines."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    libs, out_dir = _build_mutants("flash_attention", FLASH_MUTANTS, fa.bind)
    result = {}
    for name, lib in libs.items():
        out, lse, kernel = fa.launch(lib, q, k, v, True, None, 0, True)
        torch.cuda.synchronize()
        if kernel != "hopper":
            fail(f"the mutation check ran the {kernel} kernel, not the Hopper one")
        result[name] = {"out": _rms_err(out, want_out),
                        "lse": _scaled_err(lse.nan_to_num(neginf=-1e30), want_lse, 1e-4, 0.0)}
    shutil.rmtree(out_dir, ignore_errors=True)
    return result


def _bwd_mutants(q, k, v, dout, lse, delta, wants) -> dict:
    """Run the unedited Hopper backward and each of BWD_MUTANTS, built by
    :func:`_build_mutants`, on the training shape's causal inputs; return
    each one's dq, dk and dv errors against ``wants`` (the plain version's)
    over the training rule, as (max abs, over the rule, rms(want)).  A
    non-finite error counts as 1e30, so that every error stays a finite
    number in the JSON lines."""
    import torch

    from repro_torch.kernels import flash_attention_bwd as fab

    libs, out_dir = _build_mutants("flash_attention_bwd", BWD_MUTANTS, fab.bind)
    result = {}
    for name, lib in libs.items():
        (dq,), kq = fab.launch(lib, False, q, k, v, dout, lse, delta, True, None)
        (dk, dv), kkv = fab.launch(lib, True, q, k, v, dout, lse, delta, True, None)
        torch.cuda.synchronize()
        if kq != "hopper" or kkv != "hopper":
            fail(f"the mutation check ran the {kq} and {kkv} kernels, not the Hopper ones")
        result[name] = {n: tuple(x if math.isfinite(x) else 1e30 for x in _rms_err(g, w))
                        for n, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), wants)}
    shutil.rmtree(out_dir, ignore_errors=True)
    return result


def ssm_phases(dev, sm_clock_hz: float) -> dict:
    """Phases 15-18, Mamba serving at falcon-mamba-7b's full width; returns
    the kernels-line entry of ``ssm_scan``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ssm
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import Model
    from repro_torch.serve.scheduler import SlotBatcher

    cfg = get_config(SSM_ARCH)
    s = cfg.ssm
    if (cfg.num_layers, cfg.d_model, s.expand * cfg.d_model, s.d_state, s.d_conv) != SSM_FULL:
        fail(f"{SSM_ARCH} is not at its published width: {cfg}")

    # 15. the kernel against its plain version
    gen = torch.Generator(device=dev).manual_seed(15)
    sweep = {}  # "dtype/y" or "dtype/h_final" -> the worst (abs, over the rule, rms)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for B, S, Dm, N in SSM_SWEEP:
            for with_h0 in (False, True):
                x, dt, A, Bc, Cc, D, h0 = _ssm_inputs(B, S, Dm, N, dtype, dev, gen)
                h0 = h0 if with_h0 else None
                y, h = ssm.ssm_scan(x, dt, A, Bc, Cc, D, h0)
                want_y, want_h = ref.ssm_scan_ref(x, dt, A, Bc, Cc, D, h0)
                for key, e in ((f"{name}/y", _rule_err(y, want_y, name)),
                               (f"{name}/h_final", _rule_err(h, want_h, "float32"))):
                    sweep[key] = max(sweep.get(key, e), e, key=lambda t: t[1])
    if not all(e[1] <= 1.0 for e in sweep.values()):
        fail(f"ssm_scan disagrees with its plain version on the sweep: {sweep}")

    B, S, Dm, N = SSM_PATH
    inputs = _ssm_inputs(B, S, Dm, N, torch.bfloat16, dev, gen)
    x, dt, A, Bc, Cc, D, h0 = inputs
    y, h = ssm.ssm_scan(*inputs)
    want_y, want_h = ref.ssm_scan_ref(*inputs)
    torch.cuda.synchronize()
    path = {"y": _rule_err(y, want_y, "bfloat16"), "h_final": _rule_err(h, want_h, "float32")}
    if not all(e[1] <= 1.0 for e in path.values()):
        fail(f"ssm_scan disagrees with its plain version at the path shape: {path}")
    del y, h, want_y, want_h
    mutants = _ssm_mutants(dev, inputs)
    weak = {k: v for k, v in mutants.items()
            if k != "shipped" and max(v["y"][1], v["h_final"][1]) < SSM_MUTANT_MIN}
    if weak:
        fail(f"mutants of ssm_scan pass the rule with less than {SSM_MUTANT_MIN}x: {weak}")
    if max(mutants["shipped"]["y"][1], mutants["shipped"]["h_final"][1]) > 1.0:
        fail(f"the unedited ssm_scan built as a mutant fails the rule: {mutants['shipped']}")
    kernel_ms = event_ms(lambda: ssm.ssm_scan(*inputs))
    plain_ms = event_ms(lambda: ref.ssm_scan_ref(*inputs), calls=1, groups=3)
    # each input read once, each output written once
    moved = sum(t.numel() * t.element_size() for t in inputs) + x.numel() * x.element_size() \
        + h0.numel() * 4
    exps = B * S * Dm * N
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    exp_ms = exps / (SFU_EXP2_PER_CLOCK_PER_SM * sms * sm_clock_hz) * 1e3
    fp32_ms = 6 * exps / FP32_FLOP_PER_S * 1e3  # per state and step: 2 FMAs and 2 products
    kernel = {"name": "ssm_scan", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
              "replaces": "src/repro/kernels/ssm_scan.py:68",
              "shape": list(SSM_PATH), "dtype": "bfloat16",
              "max_abs_err": max(e[0] for e in (*sweep.values(), *path.values())),
              "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
              "plain": "ssm_scan_ref, 3 calls", "library_ms": None,
              "library": "none: no single PyTorch call computes a selective scan",
              "bound_ms": max(bytes_ms, exp_ms),
              "bound_by": "bytes" if bytes_ms >= exp_ms else "operations",
              "bound_parts_ms": {"bytes": bytes_ms, "exponentials": exp_ms,
                                 "fp32_pipe": fp32_ms},
              "bytes": moved, "exponentials": exps, "sm_clock_hz": sm_clock_hz, "sms": sms}
    emit({"phase": "ssm_kernel", **kernel, "rule": SSM_RULE,
          "sweep_errors": sweep,
          "path_shape_errors": path,  # [max abs err, err / rule, rms(want)]
          "path_shape_y_err_of_rule": path["y"][1],
          "path_shape_h_final_err_of_rule": path["h_final"][1],
          "mutants": mutants, "mutant_min_err_of_rule": SSM_MUTANT_MIN})
    del inputs, x, dt, A, Bc, Cc, D, h0
    torch.cuda.empty_cache()

    # 16. the card against the CPU at full width with 2 layers in float32
    cfg32 = dataclasses.replace(cfg, num_layers=SSM_CPU_LAYERS, param_dtype="float32",
                                compute_dtype="float32")
    model32 = Model(cfg32)
    lm32 = model32.init(generator=torch.Generator(device=dev).manual_seed(16), device=dev)
    lm_cpu = model32.init(generator=torch.Generator(device=dev).manual_seed(16), device="cpu")
    rng = np.random.default_rng(16)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SSM_CPU_BATCH, SSM_CPU_PROMPT)))
    max_len = SSM_CPU_PROMPT + SSM_CPU_DECODE
    caches = {"cpu": model32.init_cache(SSM_CPU_BATCH, max_len, device="cpu"),
              "card": model32.init_cache(SSM_CPU_BATCH, max_len, device=dev)}

    def state_err() -> dict:
        out = {}
        for k in ("conv", "h"):
            g, w = caches["card"]["sub_0"][k].cpu(), caches["cpu"]["sub_0"][k]
            if not torch.allclose(g, w, rtol=SSM_STATE_RTOL, atol=SSM_STATE_ATOL):
                fail(f"card and CPU {k} states disagree: max err {(g - w).abs().max().item()}")
            out[k] = (g - w).abs().max().item()
        return out

    ssm.ssm_scan.launches = 0
    want, _ = model32.prefill(lm_cpu, {"tokens": prompt}, caches["cpu"])
    got, _ = model32.prefill(lm32, {"tokens": prompt.to(dev)}, caches["card"])
    if ssm.ssm_scan.launches != SSM_CPU_LAYERS:
        fail(f"the card's prefill launched ssm_scan {ssm.ssm_scan.launches} times")
    prefill_state = state_err()
    steps = [(got.cpu(), want)]
    tok = want.argmax(-1)
    for i in range(SSM_CPU_DECODE):
        want, _ = model32.decode(lm_cpu, tok, caches["cpu"], SSM_CPU_PROMPT + i)
        got, _ = model32.decode(lm32, tok.to(dev), caches["card"], SSM_CPU_PROMPT + i)
        steps.append((got.cpu(), want))
        tok = want.argmax(-1)
    cpu_err, ties = 0.0, 0
    for g, w in steps:
        if not bool(torch.isfinite(g).all()):
            fail("non-finite logits on the card")
        if not torch.allclose(g, w, rtol=CPU_RTOL, atol=CPU_ATOL):
            fail(f"card and CPU logits disagree: max err {(g - w).abs().max().item()}")
        cpu_err = max(cpu_err, (g - w).abs().max().item())
        for b in range(SSM_CPU_BATCH):
            gt, wt = int(g[b].argmax()), int(w[b].argmax())
            if gt != wt:
                if not abs(float(w[b, gt]) - float(w[b, wt])) < TIE_F32:
                    fail(f"greedy tokens differ off a tie: card {gt}, CPU {wt}")
                ties += 1
    emit({"phase": "ssm_vs_cpu", "arch": SSM_ARCH, "layers": SSM_CPU_LAYERS, "dtype": "float32",
          "batch": SSM_CPU_BATCH, "prompt": SSM_CPU_PROMPT, "decode_steps": SSM_CPU_DECODE,
          "max_abs_err": cpu_err, "max_abs_logit": max(w.abs().max().item() for _, w in steps),
          "rtol": CPU_RTOL, "atol": CPU_ATOL, "greedy_ties": ties,
          "state_max_abs_err_after_prefill": prefill_state,
          "state_max_abs_err_after_decode": state_err(),
          "state_rtol": SSM_STATE_RTOL, "state_atol": SSM_STATE_ATOL})
    del lm32, lm_cpu, caches
    torch.cuda.empty_cache()

    # 17. the main path: serve_batch at full width and depth in bf16
    model = Model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(generator=torch.Generator(device=dev).manual_seed(17), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    prompts = rng.integers(0, cfg.vocab_size, (SSM_SERVE_BATCH, SSM_SERVE_PROMPT)).astype(np.int32)
    serve_batch(model, prompts, SSM_SERVE_GEN, params=params, device=dev)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    timings = {}
    ssm.ssm_scan.launches = 0
    toks = serve_batch(model, prompts, SSM_SERVE_GEN, params=params, device=dev, timings=timings)
    launches = ssm.ssm_scan.launches
    # one prefill and SSM_SERVE_GEN - 1 decode steps: the prefill's 64, none in decode
    per_decode_step = (launches - cfg.num_layers) / timings["decode_steps"]
    if launches != cfg.num_layers:
        fail(f"ssm_scan launched {launches} times in one prefill of {cfg.num_layers} layers "
             f"and {timings['decode_steps']} decode steps")
    if toks.shape != (SSM_SERVE_BATCH, SSM_SERVE_GEN) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        fail(f"serve_batch gave tokens of shape {toks.shape} outside the vocabulary")
    peak = torch.cuda.max_memory_allocated(dev)
    decode_ms = timings["decode_s"] / timings["decode_steps"] * 1e3

    def traced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        on_card = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        return on_card, sum(e.self_device_time_total for e in on_card) / 1e3, wall

    cache = model.init_cache(SSM_SERVE_BATCH, SSM_SERVE_PROMPT + SSM_SERVE_GEN, device=dev)
    batch = {"tokens": torch.from_numpy(prompts.astype(np.int64)).to(dev)}
    on_card, prefill_kernel_ms, prefill_wall = traced(lambda: model.prefill(params, batch, cache))
    mine = [e for e in on_card if "ssm_scan" in e.key]
    if not mine:
        fail("the trace shows no ssm_scan kernel on the card")
    scan_ms = sum(e.self_device_time_total for e in mine) / 1e3
    scan_n = sum(e.count for e in mine)
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:8]
    tok = torch.from_numpy(toks[:, -1].astype(np.int64)).to(dev)
    dec_card, decode_kernel_ms, decode_wall = traced(
        lambda: model.decode(params, tok, cache, SSM_SERVE_PROMPT))
    if any("ssm_scan" in e.key for e in dec_card):
        fail("a traced decode step launched ssm_scan")
    dec_top = sorted(dec_card, key=lambda e: -e.self_device_time_total)[:5]
    emit({"phase": "ssm_serve", "arch": SSM_ARCH, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "d_inner": s.expand * cfg.d_model, "params": n_params,
          "dtype": cfg.compute_dtype, "batch": SSM_SERVE_BATCH, "prompt": SSM_SERVE_PROMPT,
          "gen": SSM_SERVE_GEN, "init_on_card_s": init_s,
          "prefill_ms": timings["prefill_s"] * 1e3, "decode_ms_per_step": decode_ms,
          "decode_tokens_per_s": SSM_SERVE_BATCH * timings["decode_steps"] / timings["decode_s"],
          "peak_device_mem_gb": peak / 1e9, "ssm_scan_launches": launches, "prefills": 1,
          "decode_steps": timings["decode_steps"],
          "ssm_scan_launches_per_decode_step": per_decode_step,
          "traced_prefill_device_kernel_ms": prefill_kernel_ms,
          "traced_prefill_wall_ms": prefill_wall * 1e3,
          "ssm_scan_trace": {"count": scan_n, "device_ms": scan_ms,
                             "ms_per_launch": scan_ms / scan_n,
                             "share_of_prefill_kernel_time": scan_ms / prefill_kernel_ms},
          "top_kernels": [[e.key[:80], e.count, e.self_device_time_total / 1e3] for e in top],
          "traced_decode_step_device_kernel_ms": decode_kernel_ms,
          "traced_decode_step_wall_ms": decode_wall * 1e3,
          "traced_decode_step_kernel_launches": sum(e.count for e in dec_card),
          "decode_top_kernels": [[e.key[:80], e.count, e.self_device_time_total / 1e3]
                                 for e in dec_top]})
    kernel["launches"] = launches
    kernel["trace_ms_per_launch"] = scan_ms / scan_n
    del params, cache, batch
    torch.cuda.empty_cache()

    # 18. continuous batching over SSM caches at full width in float32
    cfg_b = dataclasses.replace(cfg, num_layers=SSM_BATCH_LAYERS, param_dtype="float32",
                                compute_dtype="float32")
    model_b = Model(cfg_b)
    lm_b = model_b.init(generator=torch.Generator(device=dev).manual_seed(18), device=dev)
    brng = np.random.default_rng(18)
    lens = brng.integers(SSM_BATCH_PROMPT_LENS[0], SSM_BATCH_PROMPT_LENS[1] + 1,
                         SSM_BATCH_REQUESTS)
    max_new = brng.integers(SSM_BATCH_NEW[0], SSM_BATCH_NEW[1] + 1, SSM_BATCH_REQUESTS)
    prompts = [brng.integers(0, cfg.vocab_size, int(n)).astype(np.int32) for n in lens]
    batcher = SlotBatcher(model_b, lm_b, batch_slots=BATCH_SLOTS, max_len=SSM_BATCH_MAX_LEN)
    for p, m in zip(prompts, max_new):
        batcher.submit(p, int(m))
    t0 = time.perf_counter()
    done = batcher.run()
    batch_s = time.perf_counter() - t0
    if [r.rid for r in done] != list(range(SSM_BATCH_REQUESTS)) or not all(r.done for r in done):
        fail(f"the batcher completed {[r.rid for r in done]}")
    diverged = []
    for req, p, m in zip(done, prompts, max_new):
        want, lgs = _greedy_standalone(model_b, lm_b, p, int(m), SSM_BATCH_MAX_LEN, dev)
        tie = _tie_diverged(req.out, want, lgs, TIE_F32)
        if tie is not None:
            diverged.append({"rid": req.rid, **tie})
    emit({"phase": "ssm_batching", "arch": SSM_ARCH, "layers": SSM_BATCH_LAYERS,
          "dtype": "float32", "slots": BATCH_SLOTS, "requests": SSM_BATCH_REQUESTS,
          "max_len": SSM_BATCH_MAX_LEN, "prompt_lens": lens.tolist(),
          "max_new": max_new.tolist(), "tokens": int(sum(len(r.out) for r in done)),
          "cursor_end": batcher.pos, "seconds": batch_s, "ties": diverged})
    del lm_b, batcher
    torch.cuda.empty_cache()
    return {k: kernel[k] for k in (*KERNEL_KEYS, "dtype", "library", "plain",
                                     "trace_ms_per_launch", "bound_parts_ms", "bytes",
                                     "exponentials", "sm_clock_hz", "sms")}


if __name__ == "__main__":
    main()
