"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The kernels compile with ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, loaded through ``ctypes``: no PyTorch
headers are compiled, so a build takes seconds. Every source is compiled
by its own ``nvcc`` process, all started together, and the objects are
linked into the library. It is built at first use, from the sources in
this package only, into ``build/torch_kernels/<hash of the sources>/``
beside the package (a directory ``.gitignore`` lists); a later process
with the same sources reuses it. ``build.log`` there keeps what ``ptxas -v``
said of each kernel's registers, shared memory and spills.

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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    f32 = ctypes.c_float
    lib.ivars_ln_mlp.restype = i32
    lib.ivars_ln_mlp.argtypes = [p, p, p, p, p, p, p, p, i64, i32, i32, f32, i32, i32, p]
    lib.ivars_normalize.restype = i32
    lib.ivars_normalize.argtypes = [p, p, i64, i32, i32, f32, f32, f32, f32, f32, f32, p]


def _build(out_dir: Path, so_path: Path) -> None:
    """One ``nvcc -c`` per source, all at once, then the link."""
    nvcc = _nvcc()
    tag = os.getpid()
    jobs = []
    for src in _sources():
        if src.suffix != ".cu":
            continue
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for src, obj, proc in jobs:
        _, err = proc.communicate()
        log.append(f"== {src.name} (rc={proc.returncode})\n{err}")
        if proc.returncode != 0:
            failed.append(f"{src.name} (rc={proc.returncode}):\n{err[-4000:]}")
    objs = [obj for _, obj, _ in jobs]
    try:
        (out_dir / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = out_dir / f"libivars_kernels.{tag}.tmp.so"
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o",
             str(tmp), *[str(o) for o in objs]], capture_output=True, text=True)
        if link.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc link failed (rc={link.returncode}):\n{link.stderr[-4000:]}")
        tmp.replace(so_path)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)


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
            _build(out_dir, so_path)
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
