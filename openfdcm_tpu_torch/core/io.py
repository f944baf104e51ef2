"""Binary line-file I/O (``.tmpl`` / ``.scene``), bit-compatible with the
reference and with :mod:`openfdcm_tpu.core.io`.

:func:`read`, :func:`write` and :func:`read_batch` run the native runtime
(:mod:`openfdcm_tpu_torch.native`: the C++ codec with zlib and a threaded
loader); :func:`dumps`, :func:`loads`, :func:`read_plain` and
:func:`read_batch_plain` are the pure-Python codec copied from the JAX
package, their plain versions.

Format (reference ``core/serialization.h`` and the packio envelope):

  envelope:  16-byte signature "OPENFDCM" (zero padded)
             u16 (0) + u32 (2)          — packio version fields
             u8 compressed flag
             u64 uncompressed size, u64 compressed size
             body (zlib stream if flag, raw otherwise)
  body:      45-byte packed LinesSerialHeader (``serialization.h:42-57``)
             n * 16 bytes of float32 (x1, y1, x2, y2) per line

The header records the day of the year and the year of writing, so two
files written on different days differ in those two fields only.
"""
from __future__ import annotations

import struct
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import native

SIGNATURE = b"OPENFDCM" + b"\x00" * 8
_HEADER_FMT = "<HIHH8sHHHHHHIBHQ"
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)
assert _HEADER_SIZE == 45

_VERSION = (0, 8, 0)


def serialize_lines(lines: np.ndarray) -> bytes:
    """Body bytes: header + raw float32 records (``serialization.h:59-80``)."""
    lines = np.ascontiguousarray(np.asarray(lines, np.float32).reshape(-1, 4))
    t = time.gmtime()
    header = struct.pack(
        _HEADER_FMT,
        0, 0, 0, 0, b"\x00" * 8,
        _VERSION[0], _VERSION[1], _VERSION[2],
        t.tm_yday - 1, t.tm_year - 1900,
        _HEADER_SIZE, _HEADER_SIZE,
        0, 16, lines.shape[0],
    )
    return header + lines.tobytes()


def deserialize_lines(body: bytes) -> np.ndarray:
    hdr = struct.unpack(_HEADER_FMT, body[:_HEADER_SIZE])
    line_format, record_len, n = hdr[-3], hdr[-2], hdr[-1]
    if line_format != 0:
        raise ValueError(f"Line data format not recognized, found <{record_len}>")
    data = body[_HEADER_SIZE: _HEADER_SIZE + n * record_len]
    return np.frombuffer(data, dtype="<f4").reshape(n, 4).copy()


def dumps(lines: np.ndarray, compress: bool = True) -> bytes:
    body = serialize_lines(lines)
    if compress:
        comp = zlib.compress(body)
        head = SIGNATURE + struct.pack("<HIB", 0, 2, 1) + struct.pack("<QQ", len(body), len(comp))
        return head + comp
    head = SIGNATURE + struct.pack("<HIB", 0, 2, 0) + struct.pack("<QQ", len(body), len(body))
    return head + body


def loads(data: bytes) -> np.ndarray:
    if data[:8] != SIGNATURE[:8]:
        raise ValueError("not an OPENFDCM line file (bad signature)")
    flag = data[22]
    usz, csz = struct.unpack("<QQ", data[23:39])
    raw = data[39: 39 + csz]
    body = zlib.decompress(raw) if flag else raw
    if len(body) != usz:
        raise ValueError("corrupt line file (size mismatch)")
    return deserialize_lines(body)


def write(filepath: str, lines, compress: bool = True) -> None:
    """Write a line array to disk (native codec).  Reference
    ``serialization.h:104-117``."""
    with open(filepath, "wb") as f:
        f.write(native.dumps(lines, compress))


def read(filepath: str) -> np.ndarray:
    """Read a line array (``(N, 4)`` float32; native codec).  Reference
    ``serialization.h:119-132``."""
    return native.read_file(filepath)


def read_batch(filepaths, num_threads: int = 0) -> list:
    """Read many line files, in the order given, on ``num_threads`` native
    threads (0: one per core)."""
    return native.read_batch(list(filepaths), num_threads)


def read_plain(filepath: str) -> np.ndarray:
    """:func:`read` through the pure-Python codec."""
    with open(filepath, "rb") as f:
        return loads(f.read())


def read_batch_plain(filepaths, num_threads: int = 0) -> list:
    """:func:`read_batch` through the pure-Python codec; ``num_threads > 1``
    reads on that many Python threads (zlib releases the GIL)."""
    paths = list(filepaths)
    if num_threads > 1 and len(paths) > 1:
        with ThreadPoolExecutor(num_threads) as pool:
            return list(pool.map(read_plain, paths))
    return [read_plain(p) for p in paths]
