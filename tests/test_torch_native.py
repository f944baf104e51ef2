"""The port's native host runtime (``openfdcm_tpu_torch/csrc/native.cpp``)
against the JAX package's pure-Python ``io`` and ``search`` (whose own
extension is not built here) and against the port's plain versions.
Mirrors ``tests/test_native.py``: the codec both ways, compressed and not
(decoded lines and every header field but the date equal), the batch
loader's order on 1 and 4 threads, 20 random pair trials with duplicated
lengths."""
import struct
import zlib

import numpy as np
import pytest

from openfdcm_tpu.core import io as jio
from openfdcm_tpu.matching import search as jsearch
from openfdcm_tpu_torch import native
from openfdcm_tpu_torch.core import io as tio
from openfdcm_tpu_torch.matching import search as tsearch

_HEADER = "<HIHH8sHHHHHHIBHQ"     # the 45-byte body header
_DATE = (8, 9)                    # its day-of-year and year fields


def _lines(n, seed):
    rng = np.random.default_rng(seed)
    lines = rng.uniform(-500, 500, (n, 4)).astype(np.float32)
    if n > 3:
        lines[3] = [np.inf, -0.0, np.float32(1e-40), -7.5]
    return lines


def _header(blob):
    """The envelope's 39 bytes and the body header's fields, date dropped."""
    body = zlib.decompress(blob[39:]) if blob[22] else blob[39:]
    fields = struct.unpack(_HEADER, body[:45])
    return blob[:23], [f for i, f in enumerate(fields) if i not in _DATE]


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("n", [0, 1, 37])
def test_codec_both_ways(compress, n):
    lines = _lines(n, n)
    nat = native.dumps(lines, compress)
    py = jio.dumps(lines, compress)
    assert jio.loads(nat).tobytes() == lines.tobytes()
    assert native.loads(py).tobytes() == lines.tobytes()
    assert native.loads(nat).tobytes() == lines.tobytes()
    assert _header(nat) == _header(py)
    assert _header(nat) == _header(tio.dumps(lines, compress))


def test_codec_rejects_bad_files(tmp_path):
    with pytest.raises(ValueError, match="signature"):
        native.loads(b"NOTFDCM" + b"\0" * 60)
    blob = native.dumps(_lines(5, 1), compress=True)
    with pytest.raises(ValueError, match="truncated"):
        native.loads(blob[:-3])
    missing = tmp_path / "missing.tmpl"
    with pytest.raises(ValueError, match="missing.tmpl"):
        native.read_file(missing)


@pytest.mark.parametrize("compress", [True, False])
def test_files_read_and_written_both_ways(tmp_path, compress):
    lines = _lines(23, 4)
    jp, tp = tmp_path / "j.tmpl", tmp_path / "t.tmpl"
    jio.write(str(jp), lines, compress=compress)
    tio.write(str(tp), lines, compress=compress)
    for got in (tio.read(str(jp)), jio.read(str(tp)), tio.read_plain(str(tp)),
                native.read_file(tp)):
        assert got.dtype == np.float32 and got.tobytes() == lines.tobytes()


@pytest.mark.parametrize("threads", [1, 4])
def test_read_batch_order(tmp_path, threads):
    paths = []
    for i in range(13):
        p = tmp_path / f"f{i:02d}.tmpl"
        jio.write(str(p), _lines(i + 1, i), compress=bool(i % 2))
        paths.append(p)
    got = tio.read_batch(paths, num_threads=threads)
    assert [g.shape[0] for g in got] == list(range(1, 14))
    for g, p in zip(got, paths):
        assert g.tobytes() == jio.read(str(p)).tobytes()
    plain = tio.read_batch_plain(paths, num_threads=threads)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(got, plain))
    assert tio.read_batch([], num_threads=threads) == []
    bad = tmp_path / "bad.tmpl"
    bad.write_bytes(b"NOTFDCM" + b"\0" * 60)
    with pytest.raises(ValueError, match="bad.tmpl"):
        tio.read_batch(paths[:3] + [bad] + paths[3:], num_threads=threads)


def test_pairs_match_python():
    """20 random trials (``tests/test_native.py``): the port's native pairs
    against the JAX package's Python pairs and the port's plain version,
    including duplicated lengths and scene ids that map a filtered order."""
    rng = np.random.default_rng(1)
    for trial in range(20):
        nt = int(rng.integers(1, 30))
        ns = int(rng.integers(1, 60))
        tl = rng.uniform(0, 100, nt).astype(np.float32)
        sl = rng.uniform(0, 100, ns).astype(np.float32)
        if ns > 3:
            sl[1] = sl[0]
            sl[3] = sl[2]
        if nt > 2:
            tl[1] = tl[0]
        ids = np.sort(rng.choice(4 * ns, ns, replace=False))
        mt = int(rng.integers(1, 8))
        msc = int(rng.integers(1, 12))
        got = tsearch._pair_by_length(tl, sl, ids, mt, msc)
        want = jsearch._pair_by_length(tl, sl, ids, mt, msc)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")
        np.testing.assert_array_equal(
            got, tsearch._pair_by_length_plain(tl, sl, ids, mt, msc))
    empty = tsearch._pair_by_length(np.zeros(0, np.float32), sl, ids, 3, 3)
    assert empty.shape == (0, 2)


def test_build_without_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "find_cxx", lambda: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.build()


def test_failed_build_raises_with_the_compiler_message(monkeypatch, tmp_path):
    broken = tmp_path / "native.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="error"):
        native.build()
