"""Build-at-first-use for the port's CUDA sources (`csrc/*.cu`).

Each source is compiled by nvcc into a shared library with a plain C
interface and loaded with ctypes (no PyTorch headers, so a build takes
seconds). The library lands in `<package>/build/`, named by a hash of
the source and the flags, so an edited source rebuilds and an unchanged
one loads the library already there. Nothing is built at import time:
the first wrapper call that needs a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "build"

# sm_90a keeps the Hopper-only instructions (wgmma, setmaxnreg) open to
# the kernels. No --use_fast_math: kernels that must match the reference
# bit for bit rely on IEEE division and rounding.
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: source name -> (seconds spent building in this process, ptxas report);
#: 0 seconds when the library was already on disk.
build_info: Dict[str, Tuple[float, str]] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin/nvcc, then
    /usr/local/cuda/bin/nvcc, then nvcc on PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = Path(root) / "bin" / "nvcc"
            if cand.is_file():
                return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels are built on the machine "
            "with the GPU"
        )
    return found


def library_path(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha256(
        src.read_bytes() + "\0".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD / f"lib{src.stem}-{digest}.so"


def _build(src: Path, lib: Path) -> str:
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {src.name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or none
    return proc.stdout + proc.stderr


def load(source: str) -> ctypes.CDLL:
    """The ctypes library for `csrc/<source>`, built on first use."""
    with _lock:
        lib = _loaded.get(source)
        if lib is not None:
            return lib
        path = library_path(source)
        t0 = time.perf_counter()
        report = ""
        if not path.exists():
            report = _build(CSRC / source, path)
        build_info[source] = (
            time.perf_counter() - t0 if report else 0.0, report
        )
        lib = ctypes.CDLL(str(path))
        _loaded[source] = lib
        return lib


__all__ = ["BUILD", "CSRC", "NVCC_FLAGS", "build_info", "library_path",
           "load", "nvcc"]
