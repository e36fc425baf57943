"""Build, load and bind the port's CUDA kernels.

The sources in ``laplace_inducing_points_tpu_torch/csrc`` are compiled by
``nvcc`` for ``sm_90a``, one process per ``.cu`` file, all started together,
and linked into one shared library with a plain C interface, loaded with
``ctypes``. The library's name carries a hash of the sources and
flags, so a changed source builds anew and an unchanged one is reused. The
build happens at the first launch, never at import, and into
``laplace_inducing_points_tpu_torch/_build/`` (ignored by git). Without
``nvcc`` the build raises: nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> list[Path]:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"liblip_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        candidate = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = candidate if os.path.exists(candidate) else None
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "from source and need the CUDA toolkit")
    return found


def build(path: Path) -> None:
    """Compile every ``.cu`` source into ``path``, each in its own ``nvcc``
    process, in parallel; the ptxas reports (registers, shared memory, spills)
    go to ``path`` with the suffix ``.log``."""
    path.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=path.parent) as tmp:
        objects, procs = [], []
        for cu in (p for p in sources() if p.suffix == ".cu"):
            obj = os.path.join(tmp, cu.stem + ".o")
            objects.append(obj)
            procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(cu)],
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
        logs = [proc.communicate()[0] for proc in procs]
        path.with_suffix(".log").write_text("".join(logs))
        failed = [log for proc, log in zip(procs, logs) if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "".join(failed))
        so = os.path.join(tmp, path.name)
        proc = subprocess.run([nvcc, "-shared", "-o", so, *objects], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(so, path)


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first use and declared for ctypes."""
    path = library_path()
    if not path.exists():
        build(path)
    lib = ctypes.CDLL(str(path))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    # pointers and the stream as c_void_p: a bare int would be cut to 32 bits
    lib.lip_nt_rows_f32.argtypes = [ptr, ptr, ptr, i64, i64, i64, ptr]
    lib.lip_nn_rank_f32.argtypes = [ptr, ptr, ptr, i64, i64, i64, ptr]
    lib.lip_nn_rows_f32.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, i64, ptr]
    lib.lip_nt_tiled_f32.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, i64, i64, ptr]
    lib.lip_nn_tiled_f32.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, i64, i64, ptr]
    lib.lip_matmul_geometry.argtypes = [ptr]
    lib.lip_syrk_f32.argtypes = [ptr, ptr, ptr, i64, i64, i64, i64, ptr]
    lib.lip_sweep_geometry.argtypes = [ptr]
    lib.lip_ggn_sweep_tf32.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i64, i64,
                                       i64, ctypes.c_float, ptr]
    for fn in (lib.lip_nt_rows_f32, lib.lip_nn_rank_f32, lib.lip_nn_rows_f32,
               lib.lip_nt_tiled_f32, lib.lip_nn_tiled_f32, lib.lip_matmul_geometry,
               lib.lip_syrk_f32, lib.lip_sweep_geometry, lib.lip_ggn_sweep_tf32):
        fn.restype = ctypes.c_int
    return lib


def check_matrix(name: str, t: torch.Tensor) -> None:
    """What every kernel takes: a contiguous, non-empty f32 matrix on the CPU
    or a CUDA device."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} is on {t.device}; only cpu and cuda are supported")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != 2:
        raise ValueError(f"{name} must be a matrix, got shape {tuple(t.shape)}")
    if t.numel() == 0:
        raise ValueError(f"{name} is empty: shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on_status(status: int, kernel: str) -> None:
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {status}")
