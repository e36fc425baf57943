"""ctypes binding of the repository's host data engine, ``native/lip_data.cpp``:
the epoch shuffle (a splitmix64 Fisher-Yates) and the batched RandomCrop +
horizontal flip of CIFAR-10's train-time augmentation.

The port's own copy of the loader in
``laplace_inducing_points_tpu/data/native.py`` (the port imports nothing of
that package). The shared library is built with ``g++`` on first use into
``laplace_inducing_points_tpu_torch/_build/`` (ignored by git), under a name
that carries a hash of the source and the flags. Without a compiler the
shuffle runs the same splitmix64 stream in Python (the same order), and the
crop and flip's numpy version runs (the same distribution, another stream),
as in the reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SRC = _REPO_ROOT / "native" / "lip_data.cpp"
_BUILD_DIR = _REPO_ROOT / "laplace_inducing_points_tpu_torch" / "_build"
# no -march=native: the crop and flip only copy floats, and a library built
# for one host's CPU could fault on another that loads the same checkout
_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"liblip_data_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> bool:
    """Compile into a temporary file and rename it into place, so processes
    that build at once never load a half-written library."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, str(_SRC)], check=True,
                       capture_output=True)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.CalledProcessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _SRC.exists():
            return None
        path = _library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        i64, u64 = ctypes.c_int64, ctypes.c_uint64
        pf = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        pi = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.lip_crop_flip_f32.argtypes = [pf, pi, pf, i64, i64, i64, i64, i64, u64]
        lib.lip_crop_flip_f32.restype = None
        lib.lip_shuffle_indices.argtypes = [pi, i64, u64]
        lib.lip_shuffle_indices.restype = None
        _lib = lib
        return _lib


def have_native() -> bool:
    return _load() is not None


_MASK = (1 << 64) - 1


def _shuffle_python(n: int, seed: int) -> np.ndarray:
    """``lip_shuffle_indices`` in Python: the same splitmix64 draws."""
    out = list(range(n))
    s = seed & _MASK
    for i in range(n - 1, 0, -1):
        s = (s + 0x9E3779B97F4A7C15) & _MASK
        z = s
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
        z ^= z >> 31
        j = z % (i + 1)
        out[i], out[j] = out[j], out[i]
    return np.asarray(out, dtype=np.int64)


def shuffle_indices(n: int, seed: int) -> np.ndarray:
    """A Fisher-Yates permutation of ``[0, n)`` drawn from splitmix64 at
    ``seed``: the order of the JAX package's loader."""
    lib = _load()
    if lib is None:
        return _shuffle_python(n, seed)
    out = np.empty(n, dtype=np.int64)
    lib.lip_shuffle_indices(out, n, seed & _MASK)
    return out


def crop_flip_f32(padded: np.ndarray, idx: np.ndarray, h: int, w: int,
                  pad: int, seed: int) -> np.ndarray:
    """Batched RandomCrop + HFlip out of a pre-padded (N, H+2p, W+2p, C) array."""
    c = padded.shape[-1]
    lib = _load()
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if lib is None or padded.dtype != np.float32 or not padded.flags.c_contiguous:
        rng = np.random.default_rng(seed)
        out = np.empty((len(idx), h, w, c), dtype=padded.dtype)
        offs = rng.integers(0, 2 * pad + 1, size=(len(idx), 2))
        flips = rng.random(len(idx)) < 0.5
        for j, (i, (dy, dx), fl) in enumerate(zip(idx, offs, flips)):
            img = padded[i, dy:dy + h, dx:dx + w]
            out[j] = img[:, ::-1] if fl else img
        return out
    dst = np.empty((len(idx), h, w, c), dtype=np.float32)
    lib.lip_crop_flip_f32(padded, idx, dst, len(idx), h, w, c, pad,
                          seed & 0xFFFFFFFFFFFFFFFF)
    return dst
