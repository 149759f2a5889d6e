"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for sm_90a into a
shared library with a plain C interface, at first use, into
``sage_tpu_torch/build/`` (listed in ``.gitignore``), and loaded with
``ctypes``. The library's name carries a hash of the source and the
flags, so an edited source is never served by a stale build. Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..utils import trace

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

# -fmad=false: no multiply-add contraction anywhere in the kernels, so
# f32 arithmetic keeps the reference's op order (the kernels also use the
# explicit _rn intrinsics where the order matters).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> (seconds, compiler output) of the build this process ran
build_logs: Dict[str, Tuple[float, str]] = {}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                           "build the port's kernels")
    return found


def build(name: str, extra_flags: Optional[List[str]] = None) -> str:
    """Compile ``csrc/<name>.cu`` (if not already built) and return the
    library's path. ``extra_flags`` (e.g. ``["-Xptxas", "-v"]``) are part
    of the build's identity."""
    src = os.path.join(CSRC, name + ".cu")
    flags = NVCC_FLAGS + list(extra_flags or [])
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(flags).encode()).hexdigest()
    out = os.path.join(BUILD_DIR, f"lib{name}_{digest[:12]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        with trace.span("cuda.build"):
            proc = subprocess.run(
                [nvcc_path(), *flags, "-o", tmp, src],
                capture_output=True, text=True,
            )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_logs[name] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    return out


def load(name: str, extra_flags: Optional[List[str]] = None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name, extra_flags))
            _libs[name] = lib
        return lib
