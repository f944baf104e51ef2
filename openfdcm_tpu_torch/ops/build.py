"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The kernels are compiled at first use with ``nvcc`` for ``sm_90a``, one
``nvcc`` process per source, all started together, and linked into one
shared library with a plain C interface, loaded with :mod:`ctypes`.  No
PyTorch header is compiled, which keeps the build short.  The library lands in
``build/openfdcm_tpu_torch/`` beside the package, named by a hash of the
sources, their headers and the flags, so an edited source or header is
never served by a stale build.

Nothing here runs at import time: this module imports on hosts without
``nvcc`` or a GPU, where only the kernels' plain PyTorch versions run.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "openfdcm_tpu_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points and their argument types (pointers and the stream last
# are c_void_p: ctypes would otherwise pass a Python int as a 32-bit int).
SIGNATURES = {
    "fdcm_minplus_rows": [_P, _P, _P, _P, _L, _L, _I, _I, _P],
    "fdcm_minplus_rows_wide": [_P, _P, _P, _P, _L, _L, _I, _I, _P],
    "fdcm_minplus_far": [_P, _P, _P, _L, _I, _I, _P],
    "fdcm_prop": [_P, _P, _P, _P, _I, _I, _L, _L, _I, _P, _P],
    "fdcm_prop_table": [_P, _P, _I, _I, _L, _L, _I, _I, _P],
    "fdcm_sweep_paths": [_P, _P, _P, _L, _I, _I, _I, _P],
    "fdcm_window": [_P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I,
                    _I, _I, _P],
    "fdcm_window_tiles": [_P, _P, _L, _I, _I, _P],
    "fdcm_window_v2": [_P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L,
                       _I, _I, _I, _P],
    "fdcm_decide_window": [_P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I,
                           _I, _I, _P],
    "fdcm_window_v3": [_P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L,
                       _I, _I, _I, _P],
    "fdcm_column_pass": [_P, _P, _P, _L, _I, _I, _P],
}


def sources() -> list[Path]:
    """The compiled sources, one ``nvcc`` each."""
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    """The headers the sources include (part of the library's hash)."""
    return sorted(CSRC.glob("*.cuh"))


def find_nvcc() -> str | None:
    """``nvcc`` from ``PATH``, else the CUDA toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.exists() else None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libopenfdcm_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel library unless an up-to-date one exists; returns
    its path.  Raises ``RuntimeError`` naming the failed nvcc command.  The
    compiler's register and spill report goes to ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("cannot build the CUDA kernels: nvcc not found on "
                           "PATH or at /usr/local/cuda/bin/nvcc")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources()]
        jobs = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources(), objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in jobs]
        log, failed = [], []
        for cmd, proc in zip(jobs, procs):    # wait for every compile
            try:
                text = proc.communicate(timeout=900)[0]
            except subprocess.TimeoutExpired:
                proc.kill()
                text = proc.communicate()[0] + "\n(timed out after 900 s)"
            log.append(" ".join(cmd) + "\n" + text)
            if proc.returncode != 0:
                failed.append(log[-1])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        so = Path(tmp) / out.name
        link = [nvcc, *ARCH, "-shared", "-o", str(so), *map(str, objs)]
        res = subprocess.run(link, capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}): "
                               f"{' '.join(link)}\n{res.stdout}{res.stderr}")
        out.with_suffix(".log").write_text("\n".join(log))
        os.replace(so, out)
    return out


_LIBRARY_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built and loaded once per process: calls
    that race the first one (a mesh's shards, a service's dispatch thread)
    wait for it and get the same handle.  ``library.cache_clear()`` forgets
    it."""
    with _LIBRARY_LOCK:
        return _load_library()


@functools.lru_cache(maxsize=1)
def _load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.fdcm_error_string.argtypes = [ctypes.c_int]
    lib.fdcm_error_string.restype = ctypes.c_char_p
    return lib


library.cache_clear = _load_library.cache_clear


def use_kernel(*tensors: torch.Tensor) -> bool:
    """The wrapper rule: ``False`` (run the plain version) when the tensors
    lie on the CPU, ``True`` (launch the kernel) when they lie on one CUDA
    device; anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain version for device {dev}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless ``t`` has the dtype, rank and contiguity a kernel takes."""
    if t.dtype != dtype or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {ndim}-d {dtype} tensor, "
                         f"got {tuple(t.shape)} {t.dtype} "
                         f"contiguous={t.is_contiguous()}")


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry ``name`` on ``device``'s current stream; raise if the
    launch failed (the C function returns ``cudaGetLastError()``)."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.fdcm_error_string(rc).decode()})")
