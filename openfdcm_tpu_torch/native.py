"""The port's native host runtime (``csrc/native.cpp``), loaded with
:mod:`ctypes`: the line-file codec with its zlib envelope, a threaded batch
loader, and DefaultSearch pair generation.  The port's own copy of the JAX
package's ``native/openfdcm_native.cpp``, behind a plain C interface.

The library is compiled at first use with ``g++ -O2 -std=c++17 -shared
-fPIC ... -lz -lpthread`` into ``build/openfdcm_tpu_torch/`` beside the
package, named by a hash of the source and the command, so an edited source
is never served by a stale build.  A failed build raises with the
compiler's message: there is no fallback.  The pure-Python versions in
:mod:`.core.io` and :mod:`.matching.search` are its plain versions, which
the tests hold it against.
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
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "openfdcm_tpu_torch"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
LIBS = ("-lz", "-lpthread")
_ERR = 512

_P, _U64, _I64, _I = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64, ctypes.c_int
_PP = ctypes.POINTER(ctypes.c_void_p)
SIGNATURES = {
    "fdcm_native_loads": [_P, _U64, _PP, ctypes.POINTER(_U64), _P, _I],
    "fdcm_native_dumps": [_P, _U64, _I, _I, _I, _PP, ctypes.POINTER(_U64), _P, _I],
    "fdcm_native_read_file": [ctypes.c_char_p, _PP, ctypes.POINTER(_U64), _P, _I],
    "fdcm_native_read_batch": [ctypes.POINTER(ctypes.c_char_p), _I64, _I, _PP,
                               ctypes.POINTER(_U64), _P, _I],
    "fdcm_native_default_search_pairs": [_P, _I64, _P, _I64, _I64, _I64, _PP,
                                         ctypes.POINTER(_I64), _P, _I],
}


def find_cxx() -> str | None:
    """``g++`` from ``PATH``."""
    return shutil.which("g++")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libopenfdcm_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless an up-to-date one exists; returns its
    path.  Raises ``RuntimeError`` with the compiler's message.  Processes
    that build at once each write their own file and rename it into place."""
    out = library_path()
    if out.exists():
        return out
    cxx = find_cxx()
    if cxx is None:
        raise RuntimeError("cannot build the native runtime: g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = Path(tmp) / out.name
        cmd = [cxx, *CXX_FLAGS, "-o", str(so), str(SOURCE), *LIBS]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}): {' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(so, out)
    return out


_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded library, built and loaded once per process.
    ``library.cache_clear()`` forgets it."""
    with _LOCK:
        return _load()


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.fdcm_native_free.argtypes = [_P]
    lib.fdcm_native_free.restype = None
    return lib


library.cache_clear = _load.cache_clear


def _call(name: str, *args) -> None:
    """Call C entry ``name`` (its last two arguments the error buffer);
    raise ``ValueError`` with its message when it fails."""
    err = ctypes.create_string_buffer(_ERR)
    if getattr(library(), name)(*args, err, _ERR) != 0:
        raise ValueError(err.value.decode(errors="replace"))


def _take(ptr: ctypes.c_void_p, count: int, dtype) -> np.ndarray:
    """A copy of ``count`` items of ``dtype`` at a buffer the library handed
    back, which is then freed."""
    try:
        size = count * np.dtype(dtype).itemsize
        return np.frombuffer(ctypes.string_at(ptr, size), dtype=dtype).copy()
    finally:
        library().fdcm_native_free(ptr)


def _lines(ptr, n) -> np.ndarray:
    return _take(ptr, 4 * n, "<f4").reshape(n, 4)


def loads(data: bytes) -> np.ndarray:
    """The ``(N, 4)`` float32 lines of a whole line file's bytes."""
    ptr, n = ctypes.c_void_p(), _U64()
    _call("fdcm_native_loads", data, len(data), ctypes.byref(ptr), ctypes.byref(n))
    return _lines(ptr, n.value)


def dumps(lines, compress: bool = True) -> bytes:
    """A line file's bytes, the header dated today (UTC) as the plain
    codec's."""
    arr = np.ascontiguousarray(np.asarray(lines, np.float32).reshape(-1, 4))
    t = time.gmtime()
    ptr, size = ctypes.c_void_p(), _U64()
    _call("fdcm_native_dumps", arr.ctypes.data, arr.shape[0], int(compress),
          t.tm_yday - 1, t.tm_year - 1900, ctypes.byref(ptr), ctypes.byref(size))
    return _take(ptr, size.value, np.uint8).tobytes()


def read_file(path) -> np.ndarray:
    """The ``(N, 4)`` float32 lines of the line file at ``path``."""
    ptr, n = ctypes.c_void_p(), _U64()
    _call("fdcm_native_read_file", os.fsencode(path), ctypes.byref(ptr),
          ctypes.byref(n))
    return _lines(ptr, n.value)


def read_batch(paths, num_threads: int = 0) -> list:
    """The lines of each file of ``paths``, in order, read on
    ``num_threads`` threads (0: one per core)."""
    enc = [os.fsencode(p) for p in paths]
    n = len(enc)
    outs, counts = (ctypes.c_void_p * n)(), (_U64 * n)()
    _call("fdcm_native_read_batch", (ctypes.c_char_p * n)(*enc), n,
          int(num_threads), outs, counts)
    return [_lines(ctypes.c_void_p(outs[i]), counts[i]) for i in range(n)]


def default_search_pairs(tmpl_lengths, scene_lengths, max_tmpl: int,
                         max_scene: int) -> np.ndarray:
    """DefaultSearch's ``(M, 2)`` int64 ``(template line, scene position)``
    pairs by line length (``defaultsearch.cpp:29-49``); positions index
    ``scene_lengths``."""
    tl = np.ascontiguousarray(tmpl_lengths, np.float32)
    sl = np.ascontiguousarray(scene_lengths, np.float32)
    ptr, m = ctypes.c_void_p(), _I64()
    _call("fdcm_native_default_search_pairs", tl.ctypes.data, tl.size,
          sl.ctypes.data, sl.size, int(max_tmpl), int(max_scene),
          ctypes.byref(ptr), ctypes.byref(m))
    return _take(ptr, 2 * m.value, np.int32).reshape(-1, 2).astype(np.int64)
