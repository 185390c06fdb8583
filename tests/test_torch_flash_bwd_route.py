"""Which flash-attention backward kernels take which inputs, on the CPU: the
route rule of ``repro_torch.kernels.flash_attention_bwd`` is a pure
function of type, shape, strides and base addresses, so it needs no card;
and CPU tensors through ``FlashAttentionFn`` take the plain version and
count no launch.  The kernels themselves run in ``test_torch_cuda.py``."""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ops, ref

SMOLLM_HEADS, SMOLLM_KV_HEADS = 15, 5


def _bshd_views(B, S, H, Hkv, D, dtype=torch.bfloat16, device="cpu"):
    """q, k, v as the model passes them: (B, S, H, D) projections viewed as
    (B, H, S, D), k and v sliced from one (B, S, 2 Hkv, D) tensor."""
    q = torch.empty((B, S, H, D), dtype=dtype, device=device).transpose(1, 2)
    kv = torch.empty((B, S, 2 * Hkv, D), dtype=dtype, device=device)
    return q, kv[:, :, :Hkv].transpose(1, 2), kv[:, :, Hkv:].transpose(1, 2)


def _douts(q):
    """The cotangent in either layout: contiguous (B, H, S, D), as autograd
    hands it from the attention output, and q's (B, S, H, D) view."""
    B, H, S, D = q.shape
    bshd = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    return torch.empty(q.shape, dtype=q.dtype, device=q.device), bshd


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("dout_layout", [0, 1], ids=["bhsd", "bshd"])
@pytest.mark.parametrize("D", fab.HOPPER_HEAD_DIMS)
@pytest.mark.parametrize("B,S", [(4, 2048), (2, 130)], ids=["training", "uneven"])
def test_training_path_views_take_the_hopper_kernels(B, S, D, dout_layout, device):
    q, k, v = _bshd_views(B, S, SMOLLM_HEADS, SMOLLM_KV_HEADS, D, device=device)
    dout = _douts(q)[dout_layout]
    assert fab.route(q, k, v, dout) == "hopper"
    assert fab.route(*(t.contiguous() for t in (q, k, v, dout))) == "hopper"


def _misaligned_row_stride():
    """D 64 inside rows of 68 values: a 136-byte row stride."""
    x = torch.empty((1, 3, 40, 68), dtype=torch.bfloat16)[..., :64]
    return x, x[:, :1], x[:, :1], torch.empty(x.shape, dtype=x.dtype)


def _misaligned_dout():
    """Aligned q, k and v with a dout 8 bytes into its buffer."""
    q, k, v = (t.contiguous() for t in _bshd_views(1, 40, 2, 1, 64))
    dout = torch.empty((q.numel() + 4,), dtype=q.dtype)[4:].view(q.shape)
    return q, k, v, dout


@pytest.mark.parametrize("make,want", [
    (lambda: (*_bshd_views(2, 37, 3, 1, 20), torch.empty((2, 3, 37, 20), dtype=torch.bfloat16)),
     "bf16"),  # the smoke config's head_dim
    (lambda: (*_bshd_views(1, 64, 2, 2, 16), torch.empty((1, 2, 64, 16), dtype=torch.bfloat16)),
     "bf16"),  # the sweeps'
    (lambda: (*_bshd_views(2, 64, 4, 2, 32), torch.empty((2, 4, 64, 32), dtype=torch.bfloat16)),
     "bf16"),
    (lambda: (*_bshd_views(4, 2048, 15, 5, 64, dtype=torch.float32), torch.empty((4, 15, 2048, 64))),
     "f32"),  # the card-against-CPU step's type
    (lambda: (*_bshd_views(1, 40, 2, 2, 128, dtype=torch.float32), torch.empty((1, 2, 40, 128))),
     "f32"),
    (_misaligned_row_stride, "bf16"),
    (_misaligned_dout, "bf16"),
], ids=["d20", "d16", "d32", "f32-d64", "f32-d128", "row-stride-136B", "dout-base-8B"])
def test_other_inputs_keep_their_kernels(make, want):
    assert fab.route(*make()) == want


@pytest.mark.parametrize("case,err", [
    ("float16", TypeError), ("mixed_types", TypeError), ("head_dim_160", ValueError),
    ("last_axis_strided", ValueError), ("heads_not_grouped", ValueError),
    ("window_zero", ValueError), ("dout_shape", ValueError), ("dout_type", ValueError),
    ("dout_last_axis_strided", ValueError),
])
def test_route_raises_where_the_kernels_do(case, err):
    q, k, v = _bshd_views(1, 16, 4, 2, 64)
    dout = torch.empty(q.shape, dtype=q.dtype)
    window = 0 if case == "window_zero" else None
    if case == "float16":
        q, k, v, dout = q.half(), k.half(), v.half(), dout.half()
    elif case == "mixed_types":
        k = k.float()
    elif case == "head_dim_160":
        q, k, v = _bshd_views(1, 16, 4, 2, 160)
        dout = torch.empty(q.shape, dtype=q.dtype)
    elif case == "last_axis_strided":
        q, k, v = (t[..., ::2] for t in _bshd_views(1, 16, 4, 2, 128))
        dout = torch.empty(q.shape, dtype=q.dtype)
    elif case == "heads_not_grouped":
        q = _bshd_views(1, 16, 3, 2, 64)[0]
        dout = torch.empty(q.shape, dtype=q.dtype)
    elif case == "dout_shape":
        dout = dout[:, :, :8]
    elif case == "dout_type":
        dout = dout.float()
    elif case == "dout_last_axis_strided":
        dout = torch.empty((1, 4, 16, 128), dtype=q.dtype)[..., ::2]
    with pytest.raises(err):
        fab.route(q, k, v, dout, window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cpu_tensors_take_the_plain_version_and_count_nothing(dtype):
    """``ops.flash_attention`` on CPU tensors that need a gradient runs
    ``FlashAttentionFn`` with the plain versions: its gradients equal
    ``flash_attention_bwd_ref``'s from the same residuals, and no launch
    count moves; the kernels' wrappers refuse CPU tensors."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 15, 70, 64), generator=g).to(dtype).requires_grad_()
    k, v = (torch.randn((1, 5, 70, 64), generator=g).to(dtype).requires_grad_() for _ in range(2))
    dout = torch.randn((1, 15, 70, 64), generator=g).to(dtype)
    def all_counts():
        dq, dkv = fab.flash_attention_bwd_dq, fab.flash_attention_bwd_dkv
        return (fab.hopper_launches, dq.launches, dkv.launches, dq.hopper_launches,
                dkv.hopper_launches, fa.hopper_launches, fa.flash_attention_fwd_lse.launches)

    counts = all_counts()
    out = ops.flash_attention(q, k, v, causal=True)
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert all_counts() == counts
    o, lse = ref.flash_attention_fwd_lse_ref(q.detach(), k.detach(), v.detach(), causal=True)
    want = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), o, lse, dout,
                                       causal=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    delta = (dout.float() * o.float()).sum(-1).contiguous()
    for fn in (fab.flash_attention_bwd_dq, fab.flash_attention_bwd_dkv):
        with pytest.raises(ValueError):  # the kernels' wrappers take CUDA tensors only
            fn(q.detach(), k.detach(), v.detach(), dout, lse, delta)
    assert all_counts() == counts
