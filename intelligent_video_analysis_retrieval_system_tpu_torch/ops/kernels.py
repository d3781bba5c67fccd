"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The kernels compile with ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, loaded through ``ctypes``: no PyTorch
headers are compiled, so a build takes seconds. The library is built at
first use, from the sources in this package only, into
``build/torch_kernels/<hash of the sources>/`` beside the package (a
directory ``.gitignore`` lists); a later process with the same sources
reuses it.

Nothing here runs at import time: the CPU tests import every module of the
port on machines without ``nvcc`` or a card.
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

__all__ = ["load", "build_dir", "last_build_seconds", "check_launch", "stream_of"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_BUILD_SECONDS: float | None = None

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def build_dir() -> Path:
    """``build/torch_kernels/<hash>`` next to the package, keyed by the
    sources and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _CSRC.parent.parent / "build" / "torch_kernels" / h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built"
    )


def _bind(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ivars_chunk_max.restype = i32
    lib.ivars_chunk_max.argtypes = [p, p, p, p, i64, i32, i32, i64, i32, p]
    lib.ivars_int8_chunk_max.restype = i32
    lib.ivars_int8_chunk_max.argtypes = [p, p, p, p, p, i64, i32, i32, i32, i64, p]
    lib.ivars_mha_fwd.restype = i32
    lib.ivars_mha_fwd.argtypes = [p, p, p, p, i32, i32, i32, i32, i32, p]
    lib.ivars_mha_smem_bytes.restype = i64
    lib.ivars_mha_smem_bytes.argtypes = [i32, i32, i32]


def load() -> ctypes.CDLL:
    """The kernel library, built on first call. Raises if it cannot be
    built or loaded — there is no fallback."""
    global _LIB, _BUILD_SECONDS
    with _LOCK:
        if _LIB is not None:
            return _LIB
        out_dir = build_dir()
        so_path = out_dir / "libivars_kernels.so"
        if not so_path.is_file():
            t0 = time.perf_counter()
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f"libivars_kernels.{os.getpid()}.tmp.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *[str(s) for s in _sources() if s.suffix == ".cu"]]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed (rc={proc.returncode}):\n{proc.stderr[-4000:]}"
                )
            tmp.replace(so_path)
            _BUILD_SECONDS = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so_path))
        _bind(lib)
        _LIB = lib
        return lib


def last_build_seconds() -> float | None:
    """Seconds the last ``nvcc`` build in this process took (None if the
    library came from an earlier build)."""
    return _BUILD_SECONDS


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on the tensor's device, as a C pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_launch(rc: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
