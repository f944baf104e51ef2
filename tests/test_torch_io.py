"""The port's line-file I/O against :mod:`openfdcm_tpu.core.io`: round
trips, files of either package read by the other bit-equal, and the bytes
of ``dumps`` equal with the header's two date fields masked."""
import struct
import zlib

import numpy as np
import pytest

import openfdcm_tpu as jof
from openfdcm_tpu.core import io as jio
import openfdcm_tpu_torch as ot
from openfdcm_tpu_torch.core import io as tio
from tests.utils import create_lines

# the header's tm_yday and tm_year fields (``io.py:38-44``): bytes 24-27 of
# the 45-byte body header
_DATE = slice(24, 28)


def _lines(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-500, 500, (n, 4)).astype(np.float32)


@pytest.mark.parametrize("compress", [True, False])
def test_round_trip(tmp_path, compress):
    lines = create_lines(100, 10)
    p = str(tmp_path / "a.lines")
    tio.write(p, lines, compress=compress)
    back = ot.read(p)
    assert back.shape == (100, 4) and back.dtype == np.float32
    np.testing.assert_array_equal(back, lines)


def test_empty_round_trip(tmp_path):
    p = str(tmp_path / "e.lines")
    ot.write(p, np.zeros((0, 4), np.float32))
    assert ot.read(p).shape == (0, 4)


@pytest.mark.parametrize("compress", [True, False])
def test_files_cross_read_bit_equal(tmp_path, compress):
    lines = _lines(37, 1)
    lines[3] = [np.inf, -0.0, np.float32(1e-40), -7.5]
    jp, tp = str(tmp_path / "j.tmpl"), str(tmp_path / "t.tmpl")
    jio.write(jp, lines, compress=compress)
    tio.write(tp, lines, compress=compress)
    for got in (tio.read(jp), jio.read(tp), tio.read(tp)):
        assert got.tobytes() == lines.tobytes()


def _body(blob):
    body = blob[39:]
    return zlib.decompress(body) if blob[22] else body


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("n", [0, 1, 250])
def test_dumps_bytes_equal(compress, n):
    lines = _lines(n, n)
    a, b = tio.dumps(lines, compress), jio.dumps(lines, compress)
    ba, bb = bytearray(_body(a)), bytearray(_body(b))
    ba[_DATE] = bb[_DATE] = b"\0" * 4
    assert ba == bb
    if not compress:
        assert a[:39] == b[:39]
    # the masked fields are the date: day of the year and years since 1900
    yday, year = struct.unpack("<HH", bytes(_body(a))[_DATE])
    assert 0 <= yday <= 365 and year >= 124


def test_read_batch_in_order(tmp_path):
    paths = []
    for i in range(9):
        p = tmp_path / f"f{i}.tmpl"
        tio.write(str(p), _lines(i + 1, i))
        paths.append(p)
    for threads in (0, 4):
        got = tio.read_batch(paths, num_threads=threads)
        assert [g.shape[0] for g in got] == list(range(1, 10))
        for g, p in zip(got, paths):
            np.testing.assert_array_equal(g, jof.read(str(p)))


def test_loads_rejects_bad_signature():
    with pytest.raises(ValueError, match="signature"):
        tio.loads(b"NOTFDCM" + b"\0" * 60)
