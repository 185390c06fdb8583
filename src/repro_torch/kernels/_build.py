"""Build the port's CUDA sources with ``nvcc`` at first use; load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/repro_torch_kernels/<name>-<hash>.so`` in the checkout, where
the hash covers the source, the shared headers ``csrc/*.cuh`` and the
flags, so an edited source or header builds anew.  ``ptxas -v``'s report
(each kernel's registers, shared memory and spills) is kept beside it as
``<name>-<hash>.log``: :func:`ptxas_report` reads it.
Nothing includes PyTorch's headers: ``nvcc`` takes seconds per source.
Only the machine with the card can build: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Iterable, Optional

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "load", "ptxas_report"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}  # the process's loaded libraries


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return nvcc


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> list[str]:
    """Compile ``csrc/<name>.cu`` for each name (all sources by default)
    that is not built yet: one ``nvcc`` per source, all started together.
    Returns the names compiled; raises with ``nvcc``'s output if any fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        so = _target(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, so)
    failed = []
    for name, (proc, tmp, so) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode == 0:
            so.with_suffix(".log").write_text(log)
            os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
        else:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return sorted(jobs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if need be."""
    lib = _loaded.get(name)
    if lib is None:
        so = _target(name)
        if not so.exists():
            build([name])
        lib = _loaded[name] = ctypes.CDLL(str(so))
    return lib


def ptxas_report(name: str) -> dict[str, dict[str, int]]:
    """Registers, stack frame and spill bytes and, where it has any,
    static shared memory of each kernel in the built ``csrc/<name>.cu``,
    by mangled name, from its ``ptxas -v`` log."""
    report, kernel = {}, None
    for line in _target(name).with_suffix(".log").read_text().splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            kernel = found.group(1)
            report[kernel] = {}
            continue
        if kernel is None:
            continue
        stack = re.search(r"(\d+) bytes stack frame", line)
        if stack:
            report[kernel]["stack_frame_bytes"] = int(stack.group(1))
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spills:
            report[kernel]["spill_store_bytes"] = int(spills.group(1))
            report[kernel]["spill_load_bytes"] = int(spills.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            report[kernel]["registers"] = int(regs.group(1))
        smem = re.search(r"(\d+) bytes smem", line)
        if smem:
            report[kernel]["smem_bytes"] = int(smem.group(1))
    return report
