"""Build and load the port's CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` compiles on its own with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, at first
use, under ``build/kernels/`` at the repository root, keyed by a hash of
the source, the shared ``csrc/*.cuh`` headers it may include, and the
flags. The sources include no PyTorch header, so a
build takes seconds. The library is loaded with ``ctypes``: wrappers pass
every pointer and the stream as ``c_void_p`` and ints as ``c_int``; each C
entry point returns ``cudaGetLastError()`` and :func:`check` raises on a
nonzero code.

A missing ``nvcc`` or a failed build raises. Nothing here substitutes a
plain version for a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: every kernel source under ``csrc/`` (``<name>.cu``), what
#: :func:`build_all` compiles for a run that drives all the paths
KERNELS = ("flash_attention_fwd", "flash_attention_bwd",
           "paged_attention_decode", "paged_attention_append", "fused_adamw",
           "fused_adamw_sr", "int4_matmul")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH,
    else ``/usr/local/cuda/bin/nvcc``. Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda): the port's CUDA "
        "kernels are built from paddle_tpu_torch/csrc at first use")


def library_path(name: str) -> Path:
    """The library's path, keyed by the source, the shared headers
    (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start one ``nvcc`` for ``name`` unless its library is built; returns
    ``(process, tmp_path, final_path)`` or None when nothing is to do."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name, job):
    proc, tmp, out = job
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names) -> dict[str, str]:
    """Build every named kernel, all ``nvcc`` processes started together.
    Returns each kernel's compiler log (ptxas register and spill lines)."""
    with _LOCK:
        jobs = {n: _start_build(n) for n in names}
        try:
            for n, job in jobs.items():
                if job is not None:
                    _finish_build(n, job)
        finally:
            for job in jobs.values():
                if job is not None and job[0].poll() is None:
                    job[0].kill()
                    job[0].wait()
    logs = {}
    for n in names:
        log = BUILD_DIR / f"{n}.log"
        logs[n] = log.read_text() if log.exists() else ""
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(library_path(name)))
            lib.pt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.pt_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero CUDA error code."""
    if code != 0:
        msg = lib.pt_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, as a ``c_void_p`` (read
    raw: no Stream object per launch)."""
    import torch
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(t.device.index))
