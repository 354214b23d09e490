"""The input pipeline's native hot loop (port of `native/`).

`augment.cpp` is the batched RandomCrop + RandomHorizontalFlip +
normalize with a std::thread pool. It is compiled with g++ at first use
into `<package>/build/`, named by a hash of the source and the flags (an
edited source rebuilds, an unchanged one loads the library already
there; the file is written under a temporary name and renamed, so
processes building at once never load a half-written library), and
bound with ctypes. Nothing is built at import time.

If the compiler or the library is unavailable, `lib()` returns None and
the Loader falls back to the NumPy implementation with identical
numerics, unless it was asked for the native path (`use_native=True`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "augment.cpp"
BUILD = _SRC.parent.parent / "build"
FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(FLAGS).encode())
    return BUILD / f"libdmp_native_{digest.hexdigest()[:16]}.so"


def _compile(so: Path) -> bool:
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(_SRC)],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0 or not tmp.exists():
            return False
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, compiling it on first call; None when
    the native path is unavailable (no compiler, failed build)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not so.exists() and not _compile(so):
            return None
        try:
            cdll = ctypes.CDLL(str(so))
        except OSError:
            return None
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        ci = ctypes.c_int
        cdll.dmp_augment_normalize.argtypes = [
            u8p, ci, ci, ci, ci, i32p, i32p, u8p, ci, f32p, f32p, f32p, ci
        ]
        cdll.dmp_augment_normalize.restype = None
        cdll.dmp_normalize.argtypes = [u8p, ci, ci, ci, ci, f32p, f32p,
                                       f32p, ci]
        cdll.dmp_normalize.restype = None
        _lib = cdll
        return _lib


def available() -> bool:
    return lib() is not None


def augment_normalize(images: np.ndarray, ys: np.ndarray, xs: np.ndarray,
                      flips: np.ndarray, padding: int, mean: np.ndarray,
                      std: np.ndarray, workers: int = 1) -> np.ndarray:
    """Batched crop + flip + normalize of uint8 NHWC images. The caller
    has checked `available()`; the ctypes call releases the GIL."""
    if images.dtype != np.uint8 or images.ndim != 4:
        raise ValueError(f"augment_normalize takes uint8 NHWC images, got "
                         f"{images.dtype} {images.shape}")
    n, h, w, c = images.shape
    if not len(ys) == len(xs) == len(flips) == n or len(mean) != c \
            or len(std) != c:
        raise ValueError("augment_normalize: one crop offset pair and flip "
                         "per image, one mean and std per channel")
    cdll = lib()
    out = np.empty((n, h, w, c), np.float32)
    cdll.dmp_augment_normalize(
        np.ascontiguousarray(images), n, h, w, c,
        np.ascontiguousarray(ys, np.int32), np.ascontiguousarray(xs, np.int32),
        np.ascontiguousarray(flips, np.uint8), padding,
        np.ascontiguousarray(mean, np.float32),
        np.ascontiguousarray(std, np.float32), out, workers,
    )
    return out


def normalize(images: np.ndarray, mean: np.ndarray, std: np.ndarray,
              workers: int = 1) -> np.ndarray:
    """(x / 255 - mean) / std of uint8 NHWC images, no crop or flip."""
    if images.dtype != np.uint8 or images.ndim != 4:
        raise ValueError(f"normalize takes uint8 NHWC images, got "
                         f"{images.dtype} {images.shape}")
    n, h, w, c = images.shape
    if len(mean) != c or len(std) != c:
        raise ValueError("normalize: one mean and std per channel")
    cdll = lib()
    out = np.empty((n, h, w, c), np.float32)
    cdll.dmp_normalize(
        np.ascontiguousarray(images), n, h, w, c,
        np.ascontiguousarray(mean, np.float32),
        np.ascontiguousarray(std, np.float32), out, workers,
    )
    return out


__all__ = ["augment_normalize", "available", "lib", "library_path",
           "normalize"]
