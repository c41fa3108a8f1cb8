"""Build the port's CUDA kernels from ``csrc/`` at first use and bind them.

Each ``csrc/<name>.cu`` compiles on its own (one ``nvcc`` per source, all
started together) into ``_build/lib<name>.<hash>.so``, a shared library with
a plain C interface loaded through ``ctypes`` — no PyTorch headers, so a
build takes seconds. The sources share the Hopper helpers of
``csrc/hopper.cuh``. The hash covers the source, the headers and the flags,
so a changed kernel rebuilds and an unchanged one is reused. ``_build/`` is git-ignored.

Nothing here runs at import time: the CPU tests import every module, and the
CPU has no ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("quant_matmul", "flash_attention", "paged_attention", "moe_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SMS = 132  # streaming multiprocessors of the H100 SXM the launch plans size grids for

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}  # name -> nvcc/ptxas output of the last build


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or the
    toolkit's default ``/usr/local/cuda/bin/nvcc``."""
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "build from csrc/ at first use and need the CUDA toolkit")


def lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    # the shared headers (csrc/*.cuh) are part of every source's build
    src += b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}.{digest}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` process per source, all running at once. Returns seconds per
    source built (0.0 for a reused library); raises with the compiler's
    output when a build fails. Each source is filed in the compile ledger
    (``runtime/introspection.py``): its seconds, or that it was reused."""
    from ..runtime.introspection import ledger

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: lib_path(n) for n in names if not lib_path(n).exists()}
    secs = {n: 0.0 for n in names}
    for n in names:
        if n not in todo:
            ledger().record_build(n, 0.0, reused=True)
    if not todo:
        return secs
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n, out in todo.items():
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (p, tmp) in procs.items():
        log, _ = p.communicate()
        BUILD_LOG[n] = log
        secs[n] = time.perf_counter() - t0
        if p.returncode != 0:
            failed.append(f"--- {n}.cu (nvcc exit {p.returncode}) ---\n{log}")
            continue
        os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    for n in todo:
        ledger().record_build(n, secs[n], reused=False)
    return secs


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (building it if needed)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(lib_path(name)))
            lib.dlt_error_string.argtypes = [ctypes.c_int]
            lib.dlt_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def on_card(device: torch.device) -> contextlib.AbstractContextManager:
    """The context for a launch on ``device``'s card. A ctypes call launches
    on the caller's current CUDA device, so a tensor on another card is
    launched under ``torch.cuda.device`` of its own; on the current card,
    which is every launch of a one-card run, no context is entered. The
    other-card branch is written for sp shards on several cards and has not
    been run on more than one card yet."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a launch returned a CUDA error (cudaGetLastError)."""
    if code != 0:
        msg = lib.dlt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
