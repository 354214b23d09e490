"""Build-at-first-use for the port's CUDA sources (`csrc/*.cu`).

Each source is compiled by nvcc into a shared library with a plain C
interface and loaded with ctypes (no PyTorch headers, so a build takes
seconds). The library lands in `<package>/build/`, named by a hash of
the source and the flags, so an edited source rebuilds and an unchanged
one loads the library already there. Nothing is built at import time:
the first wrapper call that needs a kernel builds it, or `build` builds
several sources at once, one nvcc process each, started together. A
source listed in `PARTS` is compiled in parts instead, one nvcc process
a part, all started with the rest, and its objects are linked into the
one library (`flash_attention.cu`: its six kernel / dtype dispatches,
so its build takes the time of the largest).
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
ARCH: Tuple[str, ...] = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS: Tuple[str, ...] = (
    *ARCH,
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: source -> (macro, parts): nvcc -c -D<macro>=p for p in range(parts),
#: the objects linked into the source's library.
PARTS: Dict[str, Tuple[str, int]] = {"flash_attention.cu": ("DMP_FLASH_PART",
                                                            6)}

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
        + repr(PARTS.get(source)).encode()
    ).hexdigest()[:16]
    return BUILD / f"lib{src.stem}-{digest}.so"


def _popen(cmd):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), cmd


def _start(source: str):
    """Start nvcc for `csrc/<source>` into a temporary file, or one nvcc
    a part into temporary objects (`PARTS`); returns (the [(process,
    command)] started, the objects to link, temporary path, library
    path)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    lib = library_path(source)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    if source not in PARTS:
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        return [_popen(cmd)], [], tmp, lib
    macro, parts = PARTS[source]
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [tmp.with_name(f"{tmp.name}.{p}.o") for p in range(parts)]
    procs = [_popen([nvcc(), *flags, "-c", f"-D{macro}={p}", "-o", str(o),
                     str(CSRC / source)]) for p, o in enumerate(objs)]
    return procs, objs, tmp, lib


def _wait(source: str, proc, cmd) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {source}:\n"
            f"{' '.join(cmd)}\n{out}"
        )
    return out


def _finish(source: str, started, t0: float) -> None:
    procs, objs, tmp, lib = started
    try:
        out = "".join(_wait(source, proc, cmd) for proc, cmd in procs)
        if objs:
            out += _wait(source, *_popen(
                [nvcc(), *ARCH, "-shared", "-o", str(tmp),
                 *map(str, objs)]))
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or none
    build_info[source] = (time.perf_counter() - t0, out)


def build(sources) -> None:
    """Build every source of `sources` whose library is not on disk yet,
    one nvcc process each (a part each under `PARTS`), all started
    together."""
    with _lock:
        t0 = time.perf_counter()
        started = {s: _start(s) for s in sources
                   if s not in _loaded and not library_path(s).exists()}
        try:
            for source, st in started.items():
                _finish(source, st, t0)
        finally:
            for procs, *_ in started.values():
                for proc, _ in procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()


def load(source: str) -> ctypes.CDLL:
    """The ctypes library for `csrc/<source>`, built on first use."""
    build([source])
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            build_info.setdefault(source, (0.0, ""))
            lib = ctypes.CDLL(str(library_path(source)))
            _loaded[source] = lib
        return lib


__all__ = ["BUILD", "CSRC", "NVCC_FLAGS", "PARTS", "build", "build_info",
           "library_path", "load", "nvcc"]
