"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds).  The library lands in ``swapnet_tpu_torch/build/`` (listed in
``.gitignore``) under a name that carries a hash of the source and flags, so
an edited source is rebuilt and an unchanged one is reused.  ``build``
starts one ``nvcc`` per source, all at once, and waits for all of them,
each at most ``BUILD_TIMEOUT_S``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

BUILD_TIMEOUT_S = 600  # per nvcc process; a build takes seconds

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise FileNotFoundError(
            "nvcc not found on PATH or under /usr/local/cuda; the CUDA "
            "kernels build only where the CUDA toolkit is installed")
    return path


def library_path(name: str) -> Path:
    source = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, in parallel.

    Returns the compiler's output (``-Xptxas -v`` resource lines) per
    source that was built now; raises ``RuntimeError`` if any build fails.
    """
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in running.items():
        try:
            logs[name] = proc.communicate(timeout=BUILD_TIMEOUT_S)[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            logs[name] = proc.communicate()[0]
            failed.append(f"{name}: nvcc did not finish in {BUILD_TIMEOUT_S} s")
            continue
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{logs[name]}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        if name not in _LOADED:
            build([name])
            _LOADED[name] = ctypes.CDLL(str(library_path(name)))
        return _LOADED[name]
