"""The Mamba-1 selective scan on the card: the wrapper of the Hopper kernels
in ``csrc/ssm_scan.cu``, which replace the TPU kernel
``repro.kernels.ssm_scan.ssm_scan``.

One thread per (batch, channel) walks the whole sequence with its N
states in registers (see the source).  Two kernels, chosen by
:func:`route` from the inputs' type, shape, strides and base addresses
alone (never by trying one):

- ``"hopper"`` (``ssm_scan_hopper``): ``x``, ``dt``, ``Bc`` and ``Cc``
  each at a 16-byte-aligned address, with a contiguous last axis and the
  strides of the other axes multiples of 16 bytes (an axis of length 1 is
  never stepped along, so its stride does not count), and a row of ``y``
  (D values of ``x``'s type) a multiple of 16 bytes: what TMA takes.
  The model's layouts are such (``x`` contiguous or a half of ``xz``,
  ``dt`` contiguous, ``Bc`` and ``Cc`` column slices of x_proj's float32
  output).  Each 16-step chunk of x, dt, B and C is staged by TMA into a
  ring of shared-memory stages ahead of the recurrence, and each chunk of
  y stored from shared memory by TMA.
- ``"simt"`` (``ssm_scan_kernel``): any other strides, the last axis
  included; each chunk's B and C staged between two block barriers.

The plain version is :func:`repro_torch.kernels.ref.ssm_scan_ref`; all
three add ``D * x`` in float32 and round y to ``x``'s type once, as the
TPU kernel does.  ``A``, ``D`` and ``h0`` must be contiguous (the model's
are) and are never copied.  ``y`` and ``h_final`` come out contiguous.

``ssm_scan.launches`` counts the launches of either kernel and the
module's ``hopper_launches`` those of ``ssm_scan_hopper``: the wrapper
adds to them where it launches and nowhere else.

The backward (:func:`ssm_scan_bwd`, ``csrc/ssm_scan_bwd.cu``) has two
kernels, chosen by :func:`bwd_route` from the same kind of facts:

- ``"hopper"`` (``ssm_scan_bwd_hopper``): inputs whose forward takes the
  ``"hopper"`` route, with ``dy`` too at a 16-byte-aligned address with a
  contiguous last axis and the other strides multiples of 16 bytes (an
  axis of length 1 exempt), and D a multiple of 8: each lane loads a
  warp's eight channels of a step as one 16-byte vector.  The model's
  layouts are such (``dy`` as autograd hands it).  Four lanes share a
  channel, 128 channels a block.
- ``"strided"`` (``ssm_scan_bwd_strided``): any other strides; one thread
  a channel, 32 channels a block.

Both walk the sequence in reverse, recomputing each segment's states from
a float32 checkpoint of the state at its start, one every
:data:`SEGMENT_STEPS` steps: B ceil(S / 8) D N values, N / 2 B S D bytes
(537 MB at falcon-mamba-7b's training shape).  The hopper kernel reads
those that the training forward wrote as it ran (:func:`ssm_scan_train`,
``ssm_scan_train_hopper``, counted in ``ssm_scan_train.checkpoints``):
the caller hands them over (counted in ``ssm_scan_bwd.with_checkpoints``),
or :func:`ssm_scan_bwd` runs that forward first.  The strided kernel
writes its own, in a first pass from ``h0``.  Each block writes its
channels' dB and dC sums for every step into a (B, ceil(D / block
channels), S, 2N) float32 scratch of partials (the block's channels: 128
on the hopper route, 67 MB at that shape; 32 on the strided one), and
each channel its dA and dD summed over time into (B, D, N) and (B, D); a
second kernel sums the partials over the blocks and the batch, in order
(no atomics: two calls give the same bits).  :func:`launch_bwd`
allocates the scratch, sized from what the library reports: the
partials, and the strided route's checkpoints.  ``ssm_scan_bwd.launches``
counts the calls that launch either kernel, the module's
``hopper_bwd_launches`` those of ``ssm_scan_bwd_hopper``,
``ssm_scan_bwd.copies`` the one copy it may make (a non-contiguous
``dh_final``).  Its plain version is
:func:`repro_torch.kernels.ref.ssm_scan_bwd_ref`.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional

import torch

from . import _build

__all__ = ["ssm_scan", "ssm_scan_bwd", "ssm_scan_train", "SEGMENT_STEPS", "STATE_SIZES", "bind",
           "bind_bwd", "bwd_route", "launch", "launch_bwd", "route"]

STATE_SIZES = (4, 16)  # the N compiled in: falcon-mamba-7b's smoke config and its own
SEGMENT_STEPS = 8  # the checkpoint interval, compiled into both sources and checked there
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DIMS, _STRIDES = ctypes.c_int64 * 4, ctypes.c_int64 * 12  # (B, S, D, N); x, dt, B, C
_BWD_STRIDES = ctypes.c_int64 * 15  # x, dt, B, C, dy

hopper_launches = 0  # launches of ssm_scan_hopper
hopper_bwd_launches = 0  # launches of ssm_scan_bwd_hopper


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument types on a loaded library of
    ``csrc/ssm_scan.cu`` (or of a build of an edited copy)."""
    args = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x dt A B
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # C D h0 y
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,  # h_final dtype dims strides
        ctypes.c_void_p,  # stream
    ]
    for fn in (lib.ssm_scan_fwd, lib.ssm_scan_fwd_hopper):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.ssm_scan_fwd_hopper_ckpt.argtypes = args[:9] + [ctypes.c_void_p] + args[9:]  # + ckpt
    lib.ssm_scan_fwd_hopper_ckpt.restype = ctypes.c_int
    lib.ssm_scan_fwd_segment_steps.argtypes = []
    lib.ssm_scan_fwd_segment_steps.restype = ctypes.c_int64
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument types on a loaded library of
    ``csrc/ssm_scan_bwd.cu`` (or of a build of an edited copy)."""
    pointers = [ctypes.c_void_p] * 20  # 9 inputs, 7 outputs, 4 scratch
    rest = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]  # dims strides stream
    for fn in (lib.ssm_scan_bwd, lib.ssm_scan_bwd_hopper):
        fn.argtypes = pointers + [ctypes.c_int] + rest  # dtype
        fn.restype = ctypes.c_int
    for fn in (lib.ssm_scan_bwd_segment_steps, lib.ssm_scan_bwd_block_channels,
               lib.ssm_scan_bwd_hopper_block_channels):
        fn.argtypes = []
        fn.restype = ctypes.c_int64
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(_build.load("ssm_scan"))


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    return bind_bwd(_build.load("ssm_scan_bwd"))


def _check_layout(x, dt, Bc, Cc) -> None:
    """Raise on a type or shape of ``x``, ``dt``, ``Bc``, ``Cc`` that the
    kernels do not take, on any device."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("dt", dt), ("Bc", Bc), ("Cc", Cc)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"need x and dt (B, S, D), got {tuple(x.shape)}, {tuple(dt.shape)}")
    Bsz, S, _ = x.shape
    if Bc.dim() != 3 or Bc.shape[:2] != (Bsz, S) or Cc.shape != Bc.shape:
        raise ValueError(f"need B and C ({Bsz}, {S}, N), got {tuple(Bc.shape)}, {tuple(Cc.shape)}")
    if Bc.shape[2] not in STATE_SIZES:
        raise ValueError(f"the state size N must be one of {STATE_SIZES}, got {Bc.shape[2]}")
    if Bsz >= 2**16:
        raise ValueError(f"at most 65,535 batch rows per launch, got {Bsz}")


def _tma_ready(t: torch.Tensor) -> bool:
    """True where TMA can address the 3-axis ``t``: a 16-byte-aligned base,
    a contiguous last axis, the other strides multiples of 16 bytes (an
    axis of length 1 is never stepped along)."""
    if t.data_ptr() % 16:
        return False
    size = t.element_size()
    (s0, s1, s2), (n0, n1, n2) = t.stride(), t.shape
    return ((n2 == 1 or s2 == 1) and (n1 == 1 or s1 * size % 16 == 0)
            and (n0 == 1 or s0 * size % 16 == 0))


def route(x: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor) -> str:
    """The kernel that takes these inputs: ``"hopper"`` or ``"simt"`` (see
    the module's docstring).  A pure function of type, shape, strides and
    base addresses: it needs no card, and raises where the kernels refuse
    the type or shape of these four."""
    _check_layout(x, dt, Bc, Cc)
    Bsz, S, Dm = x.shape
    row = Dm * x.element_size()  # of y, which comes out contiguous in x's type
    y_ready = (S == 1 or row % 16 == 0) and (Bsz == 1 or S * row % 16 == 0)
    if S < 2**31 and Dm < 2**31 and y_ready and all(_tma_ready(t) for t in (x, dt, Bc, Cc)):
        return "hopper"
    return "simt"


def _check_inputs(x, dt, A, Bc, Cc, D, h0) -> str:
    """Raise on any input the kernels do not take; else the route."""
    kernel = route(x, dt, Bc, Cc)
    named = {"A": A, "D": D}
    if h0 is not None:
        named["h0"] = h0
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    Bsz, _, Dm = x.shape
    N = Bc.shape[2]
    if A.shape != (Dm, N):
        raise ValueError(f"need A ({Dm}, {N}), got {tuple(A.shape)}")
    if D.shape != (Dm,):
        raise ValueError(f"need D ({Dm},), got {tuple(D.shape)}")
    if h0 is not None and h0.shape != (Bsz, Dm, N):
        raise ValueError(f"need h0 ({Bsz}, {Dm}, {N}), got {tuple(h0.shape)}")
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    tensors = [x, dt, Bc, Cc, *named.values()]
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"the kernel takes tensors on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    return kernel


def _check_ckpt(ckpt: torch.Tensor, x: torch.Tensor, N: int, seg: int) -> None:
    """Raise unless ``ckpt`` is a checkpoint tensor of the hopper routes:
    (B, ceil(S / seg), D * N) float32, contiguous, 16-byte-aligned, on x's
    device."""
    Bsz, S, Dm = x.shape
    want = (Bsz, -(-S // seg), Dm * N)
    if (ckpt.dtype != torch.float32 or tuple(ckpt.shape) != want or not ckpt.is_contiguous()
            or ckpt.data_ptr() % 16 or ckpt.device != x.device):
        raise ValueError(f"need checkpoints {want} float32, contiguous, 16-byte-aligned on "
                         f"{x.device}, got {tuple(ckpt.shape)} {ckpt.dtype} on {ckpt.device}")


def launch(lib: Optional[ctypes.CDLL], x, dt, A, Bc, Cc, D, h0,
           out: Optional[tuple] = None, ckpt: Optional[torch.Tensor] = None) -> tuple:
    """Check the inputs and launch, from ``lib`` (a library bound by
    :func:`bind`; None: the package's own, built at first use), the kernel
    that :func:`route` names, into ``out`` = (y (B, S, D), h_final (B, D,
    N)), both contiguous, or new outputs.  With ``ckpt`` (the hopper route
    only: (B, ceil(S / 8), D * N) float32), ``ssm_scan_train_hopper``,
    which also writes the backward's checkpoints into it.  Returns ``(y,
    h_final, kernel or None)``, None for an empty shape, which launches
    nothing; raises if the launch fails.  Counts nothing: :func:`ssm_scan`
    and :func:`ssm_scan_train` do."""
    kernel = _check_inputs(x, dt, A, Bc, Cc, D, h0)
    Bsz, S, Dm = x.shape
    N = Bc.shape[2]
    if ckpt is not None:
        if kernel != "hopper":
            raise ValueError(f"only the hopper route writes checkpoints; these inputs take "
                             f"{kernel}")
        _check_ckpt(ckpt, x, N, SEGMENT_STEPS)
    if out is None:
        out = (torch.empty((Bsz, S, Dm), dtype=x.dtype, device=x.device),
               torch.empty((Bsz, Dm, N), dtype=torch.float32, device=x.device))
    y, h_final = out
    if Bsz * Dm == 0:
        return y, h_final, None
    if lib is None:
        lib = _library()
    fn = lib.ssm_scan_fwd_hopper if kernel == "hopper" else lib.ssm_scan_fwd
    extra = ()
    if ckpt is not None:
        seg = lib.ssm_scan_fwd_segment_steps()
        if seg != SEGMENT_STEPS:
            raise RuntimeError(f"the forward library checkpoints every {seg} steps, not "
                               f"{SEGMENT_STEPS}")
        fn, extra = lib.ssm_scan_fwd_hopper_ckpt, (ckpt.data_ptr(),)
    # The path calls on the current device, where a device guard and a
    # Stream object would cost more host time than the C call: read the
    # device's raw current stream, and enter a guard only for another device.
    device = x.device.index
    guard = (contextlib.nullcontext() if device == torch.cuda.current_device()
             else torch.cuda.device(device))
    with guard:
        err = fn(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
            D.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_final.data_ptr(), *extra, _DTYPES[x.dtype], _DIMS(Bsz, S, Dm, N),
            _STRIDES(*x.stride(), *dt.stride(), *Bc.stride(), *Cc.stride()),
            torch._C._cuda_getCurrentRawStream(device),
        )
    if err != 0:
        raise RuntimeError(f"ssm_scan ({kernel}) launch failed: "
                           f"{lib.cuda_error_string(err).decode()} ({err})")
    return y, h_final, kernel


def ssm_scan(
    x: torch.Tensor,  # (B, S, D) float32 or bf16
    dt: torch.Tensor,  # (B, S, D) float32
    A: torch.Tensor,  # (D, N) float32
    Bc: torch.Tensor,  # (B, S, N) float32
    Cc: torch.Tensor,  # (B, S, N) float32
    D: torch.Tensor,  # (D,) float32
    h0: Optional[torch.Tensor] = None,  # (B, D, N) float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, D) in ``x``'s type, h_final (B, D, N) float32) on the card.

    Any S, 0 and 1 included; N one of :data:`STATE_SIZES`; zeros stand in for
    an absent ``h0``.  Raises on any input the kernels do not take (see
    the module's docstring): there is no fallback to the plain version.
    """
    global hopper_launches
    y, h_final, kernel = launch(None, x, dt, A, Bc, Cc, D, h0)
    if kernel is not None:
        ssm_scan.launches += 1
        if kernel == "hopper":
            hopper_launches += 1
    return y, h_final


ssm_scan.launches = 0


def ssm_scan_train(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bc: torch.Tensor,
                   Cc: torch.Tensor, D: torch.Tensor, h0: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """:func:`ssm_scan` as training runs it: ``(y, h_final, ckpt)``.  On
    the hopper route ``ssm_scan_train_hopper`` also writes ``ckpt``, the
    state at the start of every :data:`SEGMENT_STEPS`-step segment, (B,
    ceil(S / 8), D * N) float32 (N / 2 B S D bytes, 8 B S D at N 16: 537
    MB at falcon-mamba-7b's training shape), from which the hopper route
    of :func:`ssm_scan_bwd` recomputes the states; elsewhere, and for an
    empty x, ``ckpt`` is None.  Counted as
    :func:`ssm_scan` counts, and in ``ssm_scan_train.checkpoints``."""
    global hopper_launches
    ckpt = None
    if route(x, dt, Bc, Cc) == "hopper" and x.numel():
        Bsz, S, Dm = x.shape
        ckpt = torch.empty((Bsz, -(-S // SEGMENT_STEPS), Dm * Bc.shape[2]), dtype=torch.float32,
                           device=x.device)
    y, h_final, kernel = launch(None, x, dt, A, Bc, Cc, D, h0, ckpt=ckpt)
    if kernel is not None:
        ssm_scan.launches += 1
        if kernel == "hopper":
            hopper_launches += 1
    if ckpt is not None:
        ssm_scan_train.checkpoints += 1
    return y, h_final, ckpt


ssm_scan_train.checkpoints = 0


def bwd_route(x: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor,
              dy: torch.Tensor) -> str:
    """The backward kernel that takes these inputs: ``"hopper"`` or
    ``"strided"`` (see the module's docstring).  A pure function of type,
    shape, strides and base addresses: it needs no card, and raises where
    the kernels refuse them (the forward's refusals, and a ``dy`` not of
    x's shape and type).  The hopper route reads the checkpoints of
    ``ssm_scan_train_hopper``, so it takes only inputs whose forward
    :func:`route` names ``"hopper"``."""
    forward = route(x, dt, Bc, Cc)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"need dy of x's shape {tuple(x.shape)} and type {x.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    if forward == "hopper" and x.shape[2] % 8 == 0 and _tma_ready(dy):
        return "hopper"
    return "strided"


def _check_bwd_inputs(x, dt, A, Bc, Cc, D, h0, dy, dh_final) -> str:
    """Raise on any input the backward does not take; else its route."""
    _check_inputs(x, dt, A, Bc, Cc, D, h0)
    kernel = bwd_route(x, dt, Bc, Cc, dy)
    if dh_final is not None:
        want = (x.shape[0], x.shape[2], Bc.shape[2])
        if dh_final.dtype != torch.float32 or dh_final.shape != want:
            raise ValueError(f"need dh_final {want} float32, got {tuple(dh_final.shape)} "
                             f"{dh_final.dtype}")
        if not dh_final.is_contiguous():
            raise ValueError("dh_final must be contiguous")
    for name, t in (("dy", dy), ("dh_final", dh_final)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    return kernel


def launch_bwd(lib: Optional[ctypes.CDLL], x, dt, A, Bc, Cc, D, h0, dy, dh_final,
               out: Optional[tuple] = None, ckpt: Optional[torch.Tensor] = None) -> tuple:
    """Check the inputs and launch, from ``lib`` (a library bound by
    :func:`bind_bwd`; None: the package's own, built at first use), the
    backward into ``out`` = (dx, ddt, dB, dC, dA, dD, dh0), all contiguous,
    or new outputs.  Returns ``(dx, ddt, dA, dB, dC, dD, dh0, kernel)``
    in :func:`repro_torch.kernels.ref.ssm_scan_bwd_ref`'s order, ``kernel``
    the route that :func:`bwd_route` names, or None for an empty batch or
    width, which launches nothing (the sums dB, dC, dA and dD are then
    zeros, written here).  The hopper route needs ``ckpt``, the
    checkpoints that :func:`ssm_scan_train` wrote for these inputs (None
    only where S is 0); the strided route takes none and writes its own
    into scratch.  Raises if the launch fails.  Counts nothing:
    :func:`ssm_scan_bwd` does."""
    kernel = _check_bwd_inputs(x, dt, A, Bc, Cc, D, h0, dy, dh_final)
    if ckpt is not None:
        if kernel != "hopper":
            raise ValueError(f"only the hopper route reads the forward's checkpoints; these "
                             f"inputs take {kernel}")
        _check_ckpt(ckpt, x, Bc.shape[2], SEGMENT_STEPS)
    elif kernel == "hopper" and x.numel():
        raise ValueError("the hopper route reads the training forward's checkpoints: pass "
                         "ssm_scan_train's ckpt")
    Bsz, S, Dm = x.shape
    N = Bc.shape[2]
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    if out is None:
        out = (torch.empty((Bsz, S, Dm), dtype=x.dtype, device=dev), torch.empty((Bsz, S, Dm), **f32),
               torch.empty((Bsz, S, N), **f32), torch.empty((Bsz, S, N), **f32),
               torch.empty((Dm, N), **f32), torch.empty((Dm,), **f32),
               torch.empty((Bsz, Dm, N), **f32))
    dx, ddt, dB, dC, dA, dD, dh0 = out
    if kernel == "hopper" and (dx.data_ptr() % 16 or ddt.data_ptr() % 16):
        raise ValueError("the hopper route writes dx and ddt in 16-byte vectors: their outputs "
                         "must start at 16-byte-aligned addresses")
    if Bsz * Dm == 0:
        for t in (dB, dC, dA, dD):
            t.zero_()
        return dx, ddt, dA, dB, dC, dD, dh0, None
    if lib is None:
        lib = _bwd_library()
    hopper = kernel == "hopper"
    seg = lib.ssm_scan_bwd_segment_steps()
    width = (lib.ssm_scan_bwd_hopper_block_channels() if hopper
             else lib.ssm_scan_bwd_block_channels())
    if seg != SEGMENT_STEPS:
        raise RuntimeError(f"the backward library checkpoints every {seg} steps, not "
                           f"{SEGMENT_STEPS}")
    # scratch: the strided route's checkpoints (B, segments, N, D); the
    # blocks' dB and dC partials; the channels' dA and dD summed over time
    if not hopper:
        ckpt = torch.empty((Bsz, -(-S // seg), Dm * N), **f32)
    bc_part = torch.empty((Bsz, -(-Dm // width), S, 2 * N), **f32)
    a_part = torch.empty((Bsz, Dm, N), **f32)
    d_part = torch.empty((Bsz, Dm), **f32)
    device = dev.index
    guard = (contextlib.nullcontext() if device == torch.cuda.current_device()
             else torch.cuda.device(device))

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = lib.ssm_scan_bwd_hopper if hopper else lib.ssm_scan_bwd
    with guard:
        err = fn(
            *map(ptr, (x, dt, A, Bc, Cc, D, h0, dy, dh_final, dx, ddt, dB, dC, dA, dD, dh0,
                       ckpt, bc_part, a_part, d_part)),
            _DTYPES[x.dtype], _DIMS(Bsz, S, Dm, N),
            _BWD_STRIDES(*x.stride(), *dt.stride(), *Bc.stride(), *Cc.stride(), *dy.stride()),
            torch._C._cuda_getCurrentRawStream(device),
        )
    if err != 0:
        raise RuntimeError(f"ssm_scan_bwd ({kernel}) launch failed: "
                           f"{lib.cuda_error_string(err).decode()} ({err})")
    return dx, ddt, dA, dB, dC, dD, dh0, kernel


def ssm_scan_bwd(
    x: torch.Tensor,  # (B, S, D) float32 or bf16
    dt: torch.Tensor,  # (B, S, D) float32
    A: torch.Tensor,  # (D, N) float32
    Bc: torch.Tensor,  # (B, S, N) float32
    Cc: torch.Tensor,  # (B, S, N) float32
    D: torch.Tensor,  # (D,) float32
    h0: Optional[torch.Tensor],  # (B, D, N) float32, or None
    dy: torch.Tensor,  # (B, S, D) in x's type
    dh_final: Optional[torch.Tensor] = None,  # (B, D, N) float32, or None
    ckpt: Optional[torch.Tensor] = None,  # ssm_scan_train's checkpoints, or None
) -> tuple[torch.Tensor, ...]:
    """The scan's VJP on the card: ``(dx, ddt, dA, dB, dC, dD, dh0)`` as
    :func:`repro_torch.kernels.ref.ssm_scan_bwd_ref` returns them, dx in
    x's type, the rest float32, all contiguous.  Takes what
    :func:`ssm_scan` takes, with ``dy`` of any strides; a ``dh_final`` of
    other strides is copied (counted in ``ssm_scan_bwd.copies``).  The
    hopper route reads ``ckpt``, the checkpoints of :func:`ssm_scan_train`
    on the same inputs (counted in ``ssm_scan_bwd.with_checkpoints``);
    without them it first runs :func:`ssm_scan_train` itself (counted
    there), which gives the same bits.  Raises on anything else: there is
    no fallback to the plain version."""
    global hopper_bwd_launches
    if dh_final is not None and not dh_final.is_contiguous():
        dh_final = dh_final.contiguous()
        ssm_scan_bwd.copies += 1
    given = ckpt is not None
    if not given and x.numel() and _check_bwd_inputs(x, dt, A, Bc, Cc, D, h0, dy,
                                                     dh_final) == "hopper":
        ckpt = ssm_scan_train(x, dt, A, Bc, Cc, D, h0)[2]
    *grads, kernel = launch_bwd(None, x, dt, A, Bc, Cc, D, h0, dy, dh_final, ckpt=ckpt)
    if kernel is not None:
        ssm_scan_bwd.launches += 1
        if kernel == "hopper":
            hopper_bwd_launches += 1
            if given:
                ssm_scan_bwd.with_checkpoints += 1
    return tuple(grads)


ssm_scan_bwd.launches = 0
ssm_scan_bwd.copies = 0
ssm_scan_bwd.with_checkpoints = 0
