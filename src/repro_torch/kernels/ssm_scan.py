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

The backward (:func:`ssm_scan_bwd`, ``csrc/ssm_scan_bwd.cu``) is one
kernel for every layout (:func:`bwd_route`): it reads x, dt, B, C and dy
through their strides, recomputes the states from ``h0`` (a float32
checkpoint every few steps in a scratch the wrapper allocates) and walks
the sequence in reverse; a second kernel sums the warps' dB and dC terms
and the channels' dA and dD over the batch, in order (no atomics: two
calls give the same bits).  ``ssm_scan_bwd.launches`` counts its calls
that launch, ``ssm_scan_bwd.copies`` the one copy it may make (a
non-contiguous ``dh_final``).  Its plain version is
:func:`repro_torch.kernels.ref.ssm_scan_bwd_ref`.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional

import torch

from . import _build

__all__ = ["ssm_scan", "ssm_scan_bwd", "STATE_SIZES", "bind", "bind_bwd", "bwd_route", "launch",
           "launch_bwd", "route"]

STATE_SIZES = (4, 16)  # the N compiled in: falcon-mamba-7b's smoke config and its own
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DIMS, _STRIDES = ctypes.c_int64 * 4, ctypes.c_int64 * 12  # (B, S, D, N); x, dt, B, C
_BWD_STRIDES = ctypes.c_int64 * 15  # x, dt, B, C, dy

hopper_launches = 0  # launches of ssm_scan_hopper


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
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument types on a loaded library of
    ``csrc/ssm_scan_bwd.cu`` (or of a build of an edited copy)."""
    lib.ssm_scan_bwd.argtypes = [ctypes.c_void_p] * 20 + [  # 9 inputs, 7 outputs, 4 scratch
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]  # dtype dims strides stream
    lib.ssm_scan_bwd.restype = ctypes.c_int
    for fn in (lib.ssm_scan_bwd_segment_steps, lib.ssm_scan_bwd_block_channels):
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


def launch(lib: Optional[ctypes.CDLL], x, dt, A, Bc, Cc, D, h0,
           out: Optional[tuple] = None) -> tuple:
    """Check the inputs and launch, from ``lib`` (a library bound by
    :func:`bind`; None: the package's own, built at first use), the kernel
    that :func:`route` names, into ``out`` = (y (B, S, D), h_final (B, D,
    N)), both contiguous, or new outputs.  Returns ``(y, h_final, kernel or
    None)``, None for an empty shape, which launches nothing; raises if
    the launch fails.  Counts nothing: :func:`ssm_scan` does."""
    kernel = _check_inputs(x, dt, A, Bc, Cc, D, h0)
    Bsz, S, Dm = x.shape
    N = Bc.shape[2]
    if out is None:
        out = (torch.empty((Bsz, S, Dm), dtype=x.dtype, device=x.device),
               torch.empty((Bsz, Dm, N), dtype=torch.float32, device=x.device))
    y, h_final = out
    if Bsz * Dm == 0:
        return y, h_final, None
    if lib is None:
        lib = _library()
    fn = lib.ssm_scan_fwd_hopper if kernel == "hopper" else lib.ssm_scan_fwd
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
            h_final.data_ptr(), _DTYPES[x.dtype], _DIMS(Bsz, S, Dm, N),
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


def bwd_route(x: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor,
              dy: torch.Tensor) -> str:
    """The backward kernel that takes these inputs: ``"ssm_scan_bwd"``, the
    one kernel, for any strides.  A pure function of type and shape: it
    needs no card, and raises where the kernel refuses them (the forward's
    refusals, and a ``dy`` not of x's shape and type)."""
    _check_layout(x, dt, Bc, Cc)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"need dy of x's shape {tuple(x.shape)} and type {x.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    return "ssm_scan_bwd"


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
               out: Optional[tuple] = None) -> tuple:
    """Check the inputs and launch, from ``lib`` (a library bound by
    :func:`bind_bwd`; None: the package's own, built at first use), the
    backward into ``out`` = (dx, ddt, dB, dC, dA, dD, dh0), all contiguous,
    or new outputs.  Returns ``(dx, ddt, dA, dB, dC, dD, dh0, launched)``
    in :func:`repro_torch.kernels.ref.ssm_scan_bwd_ref`'s order; nothing is
    launched for an empty batch or width (the sums dB, dC, dA and dD are
    then zeros, written here).  Raises if the launch fails.  Counts
    nothing: :func:`ssm_scan_bwd` does."""
    _check_bwd_inputs(x, dt, A, Bc, Cc, D, h0, dy, dh_final)
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
    if Bsz * Dm == 0:
        for t in (dB, dC, dA, dD):
            t.zero_()
        return dx, ddt, dA, dB, dC, dD, dh0, False
    if lib is None:
        lib = _bwd_library()
    seg, lanes = lib.ssm_scan_bwd_segment_steps(), lib.ssm_scan_bwd_block_channels()
    # scratch: the segments' checkpoints, the warps' dB and dC terms, the
    # channels' dA and dD summed over time
    ckpt = torch.empty((Bsz, -(-S // seg), N, Dm), **f32)
    bc_part = torch.empty((Bsz, -(-Dm // lanes), S, 2 * N), **f32)
    a_part = torch.empty((Bsz, Dm, N), **f32)
    d_part = torch.empty((Bsz, Dm), **f32)
    device = dev.index
    guard = (contextlib.nullcontext() if device == torch.cuda.current_device()
             else torch.cuda.device(device))

    def ptr(t):
        return None if t is None else t.data_ptr()

    with guard:
        err = lib.ssm_scan_bwd(
            *map(ptr, (x, dt, A, Bc, Cc, D, h0, dy, dh_final, dx, ddt, dB, dC, dA, dD, dh0,
                       ckpt, bc_part, a_part, d_part)),
            _DTYPES[x.dtype], _DIMS(Bsz, S, Dm, N),
            _BWD_STRIDES(*x.stride(), *dt.stride(), *Bc.stride(), *Cc.stride(), *dy.stride()),
            torch._C._cuda_getCurrentRawStream(device),
        )
    if err != 0:
        raise RuntimeError(f"ssm_scan_bwd launch failed: {lib.cuda_error_string(err).decode()} "
                           f"({err})")
    return dx, ddt, dA, dB, dC, dD, dh0, True


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
) -> tuple[torch.Tensor, ...]:
    """The scan's VJP on the card: ``(dx, ddt, dA, dB, dC, dD, dh0)`` as
    :func:`repro_torch.kernels.ref.ssm_scan_bwd_ref` returns them, dx in
    x's type, the rest float32, all contiguous.  Takes what
    :func:`ssm_scan` takes, with ``dy`` of any strides; a ``dh_final`` of
    other strides is copied (counted in ``ssm_scan_bwd.copies``).  Raises
    on anything else: there is no fallback to the plain version."""
    if dh_final is not None and not dh_final.is_contiguous():
        dh_final = dh_final.contiguous()
        ssm_scan_bwd.copies += 1
    *grads, launched = launch_bwd(None, x, dt, A, Bc, Cc, D, h0, dy, dh_final)
    if launched:
        ssm_scan_bwd.launches += 1
    return tuple(grads)


ssm_scan_bwd.launches = 0
ssm_scan_bwd.copies = 0
