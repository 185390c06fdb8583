"""Which selective-scan kernel takes which inputs, on the CPU: the route
rule of ``repro_torch.kernels.ssm_scan`` is a pure function of type,
shape, strides and base addresses, so it needs no card.  Also the SASS
reader of ``chip_smoke.py``.  The kernels themselves run in
``test_torch_cuda.py``."""
import os
import sys

import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan as ssm

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the repo's card script: its helpers only)


def _model_layout(B, S, Dm, N, dt_rank, dtype, *, x_half=False, device="cpu"):
    """The scan's inputs as ``models/ssm.py`` passes them: x contiguous (or
    one half of the (B, S, 2 D) in-projection), dt contiguous, B and C column
    slices of the float32 x_proj output (B, S, dt_rank + 2 N)."""
    if x_half:
        x = torch.empty((B, S, 2 * Dm), dtype=dtype, device=device)[..., :Dm]
    else:
        x = torch.empty((B, S, Dm), dtype=dtype, device=device)
    dt = torch.empty((B, S, Dm), device=device)
    xdb = torch.empty((B, S, dt_rank + 2 * N), device=device)
    return x, dt, xdb[..., dt_rank:dt_rank + N], xdb[..., dt_rank + N:]


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("x_half", [False, True], ids=["x", "xz-half"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,Dm,N,dt_rank", [
    (8, 1024, 8192, 16, 256),  # falcon-mamba-7b's prefill
    (2, 300, 8192, 16, 256),   # its card-against-CPU prompt
    (2, 37, 128, 4, 4),        # the smoke config (d_model 64)
    (1, 1, 96, 16, 8),         # one step, D not a multiple of the block's channels
], ids=["path", "prompt-300", "smoke", "one-step"])
def test_model_layouts_take_the_hopper_kernel(B, S, Dm, N, dt_rank, dtype, x_half, device):
    x, dt, Bc, Cc = _model_layout(B, S, Dm, N, dt_rank, dtype, x_half=x_half, device=device)
    assert ssm.route(x, dt, Bc, Cc) == "hopper"


def test_chip_smoke_inputs_take_the_hopper_kernel():
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, Dm, N in chip_smoke.SSM_SWEEP:
            x, dt, A, Bc, Cc, D, h0 = chip_smoke._ssm_inputs(B, S, Dm, N, dtype, "cpu", gen)
            assert ssm.route(x, dt, Bc, Cc) == "hopper", (B, S, Dm, N, dtype)


def _misaligned_b_and_c():
    """B and C after a dt_rank of 3: 12 and 28 bytes into their rows."""
    return _model_layout(2, 40, 96, 4, 3, torch.float32)


def _odd_row_stride():
    """bf16 x as a half of xz with D = 37: rows of 148 bytes."""
    return _model_layout(2, 40, 37, 16, 256, torch.bfloat16, x_half=True)


def _y_rows_of_200_bytes():
    """bf16 x as a half of xz with D = 100: x, dt, B and C as TMA takes
    them, but y's rows of 200 bytes are not."""
    return _model_layout(2, 40, 100, 16, 256, torch.bfloat16, x_half=True)


def _transposed_x():
    """x with a last-axis stride of S."""
    x, dt, Bc, Cc = _model_layout(2, 40, 96, 16, 256, torch.float32)
    return torch.empty((2, 96, 40)).transpose(1, 2), dt, Bc, Cc


def _strided_last_axis_of_dt():
    x, dt, Bc, Cc = _model_layout(2, 40, 96, 16, 256, torch.float32)
    return x, torch.empty((2, 40, 96, 2))[..., 0], Bc, Cc


def _misaligned_base_of_x():
    """x starting 4 bytes into its buffer."""
    x, dt, Bc, Cc = _model_layout(2, 40, 96, 16, 256, torch.float32)
    return torch.empty((2 * 40 * 96 + 1,))[1:].view(2, 40, 96), dt, Bc, Cc


def _transposed_b_and_c():
    x, dt, Bc, Cc = _model_layout(2, 40, 96, 16, 256, torch.float32)
    b = torch.empty((2, 16, 40)).transpose(1, 2)
    return x, dt, b, b


@pytest.mark.parametrize("make", [
    _misaligned_b_and_c, _odd_row_stride, _y_rows_of_200_bytes, _transposed_x,
    _strided_last_axis_of_dt, _misaligned_base_of_x, _transposed_b_and_c,
], ids=["b-c-after-dt-rank-3", "row-stride-148B", "y-row-200B", "x-transposed",
        "dt-last-stride-2", "x-base-4B", "b-c-transposed"])
def test_other_strides_keep_the_simt_kernel(make):
    assert ssm.route(*make()) == "simt"


def test_length_one_axes_do_not_count_their_strides():
    """An axis of length 1 is never stepped along, so its stride (here an
    odd one) does not keep the input from TMA; a row stride of 148 bytes
    over 40 steps does."""
    x = torch.empty((1, 40, 96)).as_strided((1, 40, 96), (3, 96, 1))
    dt = torch.empty((1, 40, 96))
    bc = torch.empty((1, 40, 16)).as_strided((1, 40, 16), (7, 16, 1))
    assert ssm.route(x, dt, bc, bc) == "hopper"
    one_step = torch.empty((1, 1, 96)).as_strided((1, 1, 96), (5, 37, 1))
    assert ssm.route(one_step, dt[:, :1], bc[:, :1], bc[:, :1]) == "hopper"
    odd_rows = torch.empty((40 * 37,)).as_strided((1, 40, 16), (0, 37, 1))
    assert ssm.route(x, dt, odd_rows, bc) == "simt"


@pytest.mark.parametrize("dtype,Dm", [(torch.bfloat16, 100), (torch.float32, 99)],
                         ids=["bf16-200B", "f32-396B"])
def test_one_step_of_one_row_takes_the_hopper_kernel_at_any_width(dtype, Dm):
    """With B = S = 1 no axis but the last is stepped along, so rows of y
    (and of x and dt) that are not a multiple of 16 bytes do not keep the
    inputs from TMA: the kernel's tensor maps give such axes a stride
    rounded up to 16 bytes."""
    x, dt, Bc, Cc = _model_layout(1, 1, Dm, 16, 256, dtype, x_half=True)
    assert ssm.route(x, dt, Bc, Cc) == "hopper"
    x, dt, Bc, Cc = _model_layout(2, 1, Dm, 16, 256, dtype, x_half=True)
    assert ssm.route(x, dt, Bc, Cc) == "simt"  # two rows of y, 200 or 396 bytes apart


def _inputs(B=2, S=9, Dm=96, N=16, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return chip_smoke._ssm_inputs(B, S, Dm, N, dtype, "cpu", g)


@pytest.mark.parametrize("case,err", [
    ("x_float16", TypeError), ("dt_float64", TypeError), ("b_bf16", TypeError),
    ("state_size_5", ValueError), ("state_size_17", ValueError), ("dt_shape", ValueError),
    ("x_two_axes", ValueError), ("c_shape", ValueError), ("b_steps", ValueError),
])
def test_route_raises_where_the_kernels_do(case, err):
    x, dt, A, Bc, Cc, D, h0 = _inputs()
    if case == "x_float16":
        x = x.half()
    elif case == "dt_float64":
        dt = dt.double()
    elif case == "b_bf16":
        Bc = Bc.bfloat16()
    elif case in ("state_size_5", "state_size_17"):
        x, dt, A, Bc, Cc, D, h0 = _inputs(N=int(case.rsplit("_", 1)[1]))
    elif case == "dt_shape":
        dt = dt[:, :-1]
    elif case == "x_two_axes":
        x = x[0]
    elif case == "c_shape":
        Cc = Cc[..., :4]
    elif case == "b_steps":
        Bc, Cc = Bc[:, 1:], Cc[:, 1:]
    with pytest.raises(err):
        ssm.route(x, dt, Bc, Cc)
    with pytest.raises(err):
        ssm._check_inputs(x, dt, A, Bc, Cc, D, h0)


@pytest.mark.parametrize("case", ["a_shape", "a_strided", "d_shape", "h0_shape", "h0_float64"])
def test_check_inputs_raises_on_a_d_and_h0(case):
    """What route does not see: A, D and h0."""
    x, dt, A, Bc, Cc, D, h0 = _inputs()
    err = ValueError
    if case == "a_shape":
        A = A[:, :4]
    elif case == "a_strided":
        A = A.t().contiguous().t()
    elif case == "d_shape":
        D = D[:-1]
    elif case == "h0_shape":
        h0 = h0[:1]
    elif case == "h0_float64":
        h0, err = h0.double(), TypeError
    assert ssm.route(x, dt, Bc, Cc) == "hopper"
    with pytest.raises(err):
        ssm._check_inputs(x, dt, A, Bc, Cc, D, h0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cpu_tensors_take_the_plain_version_and_count_nothing(dtype):
    inputs = _inputs(dtype=dtype, seed=3)
    counts = (ssm.hopper_launches, ssm.ssm_scan.launches)
    y, h = ops.ssm_scan(*inputs)
    want_y, want_h = ref.ssm_scan_ref(*inputs)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert (ssm.hopper_launches, ssm.ssm_scan.launches) == counts
    with pytest.raises(ValueError):  # the kernels' wrapper takes CUDA tensors only
        ssm.ssm_scan(*inputs)
    assert (ssm.hopper_launches, ssm.ssm_scan.launches) == counts


_SASS = """
	Function : _ZN12_GLOBAL__N_16staged15ssm_scan_hopperI13__nv_bfloat16Li16EEEvNS0_4MapsENS0_6ParamsE
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                        /* 0x00000a00ff017b82 */
                                                                                 /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                            /* 0x0000000000007919 */
        /*0020*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R2+URZ], R3 ;
        /*0030*/              @!P0 BRA 0x20 ;
        /*0040*/               @P3 BRA 0xb0 ;
        /*0050*/                   FMUL R3, R2, R4 ;
        /*0060*/                   MUFU.EX2 R5, R3 ;
        /*0070*/                   FFMA R6, R5, R6, R7 ;
        /*0080*/                   MUFU.EX2 R8, R8 ;
        /*0090*/                   FFMA R9, R8, R9, R7 ;
        /*00a0*/                   BRA 0xf0 ;
        /*00b0*/                   FMUL R3, R2, R4 ;
        /*00c0*/                   MUFU.EX2 R5, R3 ;
        /*00d0*/                   NOP ;
        /*00e0*/               @P1 BRA 0xb0 ;
        /*00f0*/                   STS.U16 [R10], R6 ;
        /*0100*/              @!P2 BRA 0x20 ;
        /*0110*/                   EXIT ;
        /*0120*/                   BRA 0x120;
	Function : _ZN12_GLOBAL__N_115ssm_scan_kernelI13__nv_bfloat16Li16EEEvNS_6ParamsE
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   FMUL R5, R3, R3 ;
        /*0010*/                   EXIT ;
"""


def test_sass_exp_loop_reads_the_unrolled_block_and_the_chunk_loop():
    """The block: the branch-free run with the most exponentials.  The
    loop: the chunk loop without what is nested in it (the spin on a
    barrier, the ragged chunk's loop); NOP does not count."""
    got = chip_smoke.sass_exp_loop(_SASS, "ssm_scan_hopper", "__nv_bfloat16", "Li16E")
    assert got["block"] == {"instructions": 6, "mufu_ex2": 2, "per_mufu": 3.0,
                            "opcodes": {"MUFU.EX2": 2, "FFMA": 2, "FMUL": 1, "BRA": 1}}
    loop = got["loop"]
    assert (loop["instructions"], loop["mufu_ex2"], loop["per_mufu"]) == (9, 2, 4.5)
    assert loop["opcodes"] == {"BRA": 3, "MUFU.EX2": 2, "FFMA": 2, "FMUL": 1, "STS.U16": 1}
    with pytest.raises(ValueError):  # no exponential there
        chip_smoke.sass_exp_loop(_SASS, "ssm_scan_kernel", "__nv_bfloat16")
    with pytest.raises(ValueError):  # two functions match
        chip_smoke.sass_exp_loop(_SASS, "ssm_scan")



# ------------------------------------------------- the backward's two routes
def _dy(x, *, last_stride=1, offset=0):
    """A dy of x's shape and type: contiguous, or with a last-axis stride,
    or starting ``offset`` elements into its buffer."""
    Bsz, S, Dm = x.shape
    if last_stride != 1:
        return torch.empty((Bsz, S, Dm, last_stride), dtype=x.dtype, device=x.device)[..., 0]
    flat = torch.empty((Bsz * S * Dm + offset,), dtype=x.dtype, device=x.device)
    return flat[offset:].view(Bsz, S, Dm)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("x_half", [False, True], ids=["x", "xz-half"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,Dm,N,dt_rank", [
    (4, 2048, 8192, 16, 256),  # falcon-mamba-7b's training scan
    (4, 2048, 16384, 16, 512),  # jamba's Mamba layers at training length
    (2, 37, 128, 4, 4),        # the falcon-mamba and jamba smoke configs (d_model 64)
    (1, 1, 96, 16, 8),         # one step, D not a multiple of the block's 128 channels
], ids=["falcon-mamba", "jamba", "smoke", "one-step"])
def test_model_layouts_take_the_hopper_backward(B, S, Dm, N, dt_rank, dtype, x_half, device):
    """x contiguous or a half of xz, dt contiguous, B and C column views of
    x_proj's float32 output, dy contiguous (as ``y * silu(z)`` hands it back)
    or a half of a wider tensor."""
    x, dt, Bc, Cc = _model_layout(B, S, Dm, N, dt_rank, dtype, x_half=x_half, device=device)
    assert ssm.bwd_route(x, dt, Bc, Cc, _dy(x)) == "hopper"
    wide = torch.empty((B, S, 2 * Dm), dtype=dtype, device=device)
    assert ssm.bwd_route(x, dt, Bc, Cc, wide[..., Dm:]) == "hopper"


def test_chip_smoke_backward_inputs_take_the_hopper_route():
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for Dm in chip_smoke.SSM_BWD_D:
            for N in (4, 16):
                inputs, dy, _ = chip_smoke._bwd_inputs(2, 17, Dm, N, dtype, "cpu", gen, True)
                assert ssm.bwd_route(*inputs[:2], *inputs[3:5], dy) == "hopper", (Dm, N, dtype)
                strided = torch.stack([dy, dy], dim=-1)[..., 0]
                assert ssm.bwd_route(*inputs[:2], *inputs[3:5], strided) == "strided"


def _bwd_case(case):
    """Model layouts (f32, D 96) with one input the hopper backward refuses."""
    x, dt, Bc, Cc = _model_layout(2, 40, 96, 16, 256, torch.float32)
    dy = _dy(x)
    if case == "dy-last-stride-2":
        dy = _dy(x, last_stride=2)
    elif case == "dy-base-4B":
        dy = _dy(x, offset=1)
    elif case == "dy-transposed":
        dy = torch.empty((2, 96, 40)).transpose(1, 2)
    elif case == "x-transposed":
        x = torch.empty((2, 96, 40)).transpose(1, 2)
    elif case == "dt-last-stride-2":
        dt = torch.empty((2, 40, 96, 2))[..., 0]
    elif case == "bf16-row-stride-148B":  # x a half of xz with D 37
        x, dt, Bc, Cc = _model_layout(2, 40, 37, 16, 256, torch.bfloat16, x_half=True)
        dy = _dy(x)
    elif case == "D-100":  # rows TMA could take, but not whole 8-channel vectors
        x, dt, Bc, Cc = _model_layout(2, 40, 100, 16, 256, torch.float32)
        dy = _dy(x)
    return x, dt, Bc, Cc, dy


@pytest.mark.parametrize("case", ["dy-last-stride-2", "dy-base-4B", "dy-transposed",
                                  "x-transposed", "dt-last-stride-2", "bf16-row-stride-148B",
                                  "D-100"])
def test_other_layouts_take_the_strided_backward(case):
    assert ssm.bwd_route(*_bwd_case(case)) == "strided"


def test_b_and_c_strides_do_not_choose_the_backward():
    """B and C strides do not choose the backward on their own, only
    through the forward's route, whose checkpoints the hopper backward
    reads: where the forward takes them (column views after dt_rank 8,
    separate contiguous tensors) the backward takes the hopper kernel;
    after a dt_rank of 3 (rows 12 and 28 bytes in) or transposed, the
    forward takes its simt kernel and the backward the strided one."""
    x, dt, Bc, Cc = _model_layout(2, 40, 96, 4, 8, torch.float32)
    assert ssm.route(x, dt, Bc, Cc) == ssm.bwd_route(x, dt, Bc, Cc, _dy(x)) == "hopper"
    b = torch.empty((2, 40, 16))
    x, dt, _, _ = _model_layout(2, 40, 96, 16, 256, torch.float32)
    assert ssm.route(x, dt, b, b.clone()) == ssm.bwd_route(x, dt, b, b.clone(), _dy(x)) == "hopper"
    x, dt, Bc, Cc = _model_layout(2, 40, 96, 4, 3, torch.float32)
    assert ssm.route(x, dt, Bc, Cc) == "simt"
    assert ssm.bwd_route(x, dt, Bc, Cc, _dy(x)) == "strided"
    b = torch.empty((2, 16, 40)).transpose(1, 2)
    x, dt, _, _ = _model_layout(2, 40, 96, 16, 256, torch.float32)
    assert ssm.route(x, dt, b, b) == "simt"
    assert ssm.bwd_route(x, dt, b, b, _dy(x)) == "strided"


def test_length_one_axes_do_not_count_their_strides_in_the_backward():
    """One batch row: its batch strides (odd here) are never stepped along;
    one step: neither are the step strides.  Over 40 steps, an odd step
    stride of dy keeps it from the hopper route."""
    x = torch.empty((1, 40, 96)).as_strided((1, 40, 96), (3, 96, 1))
    dt = torch.empty((1, 40, 96)).as_strided((1, 40, 96), (7, 96, 1))
    bc = torch.empty((1, 40, 16))
    dy = torch.empty((1, 40, 96)).as_strided((1, 40, 96), (5, 96, 1))
    assert ssm.bwd_route(x, dt, bc, bc, dy) == "hopper"
    one = torch.empty((1, 1, 96)).as_strided((1, 1, 96), (5, 37, 1))
    assert ssm.bwd_route(one, one.clone(), bc[:, :1], bc[:, :1], one) == "hopper"
    odd = torch.empty((40 * 99,)).as_strided((1, 40, 96), (0, 99, 1))
    assert ssm.bwd_route(x, dt, bc, bc, odd) == "strided"


@pytest.mark.parametrize("case", ["dy_shape", "dy_type", "x_float16", "state_size_5"])
def test_bwd_route_raises_where_the_kernels_do(case):
    x, dt, A, Bc, Cc, D, h0 = _inputs()
    dy = torch.zeros_like(x)
    err = ValueError
    if case == "dy_shape":
        dy = dy[:, 1:]
    elif case == "dy_type":
        dy = dy.bfloat16()
    elif case == "x_float16":
        x, dy, err = x.half(), dy.half(), TypeError
    elif case == "state_size_5":
        x, dt, A, Bc, Cc, D, h0 = _inputs(N=5)
    with pytest.raises(err):
        ssm.bwd_route(x, dt, Bc, Cc, dy)


@pytest.mark.parametrize("case", ["shape", "float64", "strided", "base-4B"])
def test_checkpoints_of_another_layout_are_refused(case):
    """What the backward accepts as the training forward's checkpoints:
    (B, ceil(S / 8), D N) float32, contiguous, 16-byte-aligned."""
    x = torch.empty((2, 17, 96))
    ckpt = torch.empty((2, 3, 96 * 16))
    ssm._check_ckpt(ckpt, x, 16, ssm.SEGMENT_STEPS)
    if case == "shape":
        ckpt = torch.empty((2, 2, 96 * 16))
    elif case == "float64":
        ckpt = ckpt.double()
    elif case == "strided":
        ckpt = torch.empty((2, 96 * 16, 3)).transpose(1, 2)
    elif case == "base-4B":
        ckpt = torch.empty((2 * 3 * 96 * 16 + 1,))[1:].view(2, 3, 96 * 16)
    with pytest.raises(ValueError):
        ssm._check_ckpt(ckpt, x, 16, ssm.SEGMENT_STEPS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cpu_backward_takes_the_plain_version_and_counts_nothing(dtype):
    """``ops.ssm_scan`` under a gradient on the CPU: the plain forward, no
    checkpoints, the plain reverse recurrence; no count of either route
    moves, and the kernels' wrappers refuse CPU tensors."""
    x, dt, A, Bc, Cc, D, h0 = _inputs(dtype=dtype, seed=4)
    leaves = [t.detach().clone().requires_grad_() for t in (x, dt, A, Bc, Cc, D, h0)]
    counts = (ssm.ssm_scan_bwd.launches, ssm.hopper_bwd_launches, ssm.ssm_scan_bwd.copies,
              ssm.ssm_scan_bwd.with_checkpoints, ssm.ssm_scan_train.checkpoints,
              ssm.hopper_launches, ssm.ssm_scan.launches)
    y, h = ops.ssm_scan(*leaves)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(5)).to(dtype)
    got = torch.autograd.grad(y, leaves, dy)
    want = ref.ssm_scan_bwd_ref(x, dt, A, Bc, Cc, D, h0, dy, None)
    order = (0, 1, 2, 3, 4, 5, 6)  # ops' order x dt A B C D h0; ref's dx ddt dA dB dC dD dh0
    assert all(torch.equal(got[i], want[i]) for i in order)
    assert ops._scan_train(x, dt, A, Bc, Cc, D, h0)[2] is None
    with pytest.raises(ValueError):
        ssm.ssm_scan_train(x, dt, A, Bc, Cc, D, h0)
    with pytest.raises(ValueError):
        ssm.ssm_scan_bwd(x, dt, A, Bc, Cc, D, h0, dy)
    assert (ssm.ssm_scan_bwd.launches, ssm.hopper_bwd_launches, ssm.ssm_scan_bwd.copies,
            ssm.ssm_scan_bwd.with_checkpoints, ssm.ssm_scan_train.checkpoints,
            ssm.hopper_launches, ssm.ssm_scan.launches) == counts
