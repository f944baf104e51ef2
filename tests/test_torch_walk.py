"""The walk decisions of one scored window (``ops/walk.py::decide_window``,
``csrc/walk.cu``) and the stragglers' lockstep walk.

On the CPU: a Python mirror of the CUDA kernel's control flow, in float32
scalars, is held bit-equal to the plain version (``decide_window_plain``,
which the optimizer's ``_greedy_chain_cov`` and ``_batch_chain_cov`` name
for the JAX-parity tests) on windows with ties, 3e38 fills, values above the
fill, NaN, finished walks, ``tcov`` below, inside and past the window and
limits below 1; and the lockstep walk of ``width`` steps a window gives the
same ``(scores, translations, valid)`` as a walk of one batch (or one greedy
window) a host sync, with ``ceil(n / factor)`` windows where that walk takes
``n``.

On the card (marker ``gpu``; no JAX in this file): the kernel bit-equal to
the plain version, and the optimizer with the kernel's decisions equal to
the optimizer with the plain decisions, in every mode and generation.
"""
import math

import numpy as np
import pytest
import torch

from openfdcm_tpu_torch import profiling
from openfdcm_tpu_torch.matching import optimize as topt
from openfdcm_tpu_torch.matching import optimize_kernel as tok
from openfdcm_tpu_torch.ops import walk
from test_torch_gpu import _stair_case  # tests/test_torch_gpu.py

F32 = np.float32
BIG = F32(3.0e38)
BATCHES = [None, 1, 5, 10, 64, 100]     # None: the greedy walk
WIDTHS = [5, 63, 64, 128]


def _decide_case(seed, m, h):
    """Window scores ``(m, h)`` as a view into wider rows, and the walk
    inputs."""
    rng = np.random.default_rng(seed)
    full = rng.integers(0, 8, (m, h + 3)).astype(F32)             # ties
    full[::4] = np.sort(full[::4], axis=1)[:, ::-1]                # long descents
    full[1::5] = rng.uniform(0, 8, full[1::5].shape).astype(F32)
    full[rng.uniform(size=full.shape) < 0.03] = BIG
    full[2::9] = BIG                                               # a row of fills
    full[3::11, 2] = F32(3.2e38)                                   # above the fill
    full[5::13, 3] = np.nan
    t0 = rng.integers(1, 200, m).astype(F32)
    where = rng.integers(0, 3, m)                  # tcov below, inside, past
    tcov = np.select([where == 0, where == 1],
                     [t0 - rng.integers(1, 4, m), t0 + rng.integers(0, h, m)],
                     t0 + h + rng.integers(0, 5, m)).astype(F32)
    t_limit = np.where(rng.uniform(size=m) < 0.15, rng.integers(-3, 1, m),
                       t0 + rng.integers(-5, h + 10, m)).astype(F32)
    prev = rng.integers(0, 9, m).astype(F32)
    prev[::7] = BIG
    best = np.minimum(prev, rng.integers(0, 9, m).astype(F32))
    bmul = rng.integers(-50, 50, m).astype(F32)
    done = rng.uniform(size=m) < 0.3
    return full, t_limit, tcov, (prev, best, bmul, done, t0)


def _tensors(case, device):
    full, t_limit, tcov, state = case
    h = full.shape[1] - 3
    t = lambda a: torch.as_tensor(a, device=device)
    return t(full)[:, 1:h + 1], t(t_limit), t(tcov), tuple(t(x) for x in state)


def _same(got, want):
    for g, w in zip(got, want):
        g, w = g.cpu(), w.cpu()
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype == torch.bool:
            assert torch.equal(g, w)
        else:
            assert torch.equal(g.isnan(), w.isnan())
            assert torch.equal(g.view(torch.int32)[~w.isnan()],
                               w.view(torch.int32)[~w.isnan()])


def _greedy(s, h, lim, cov, sign, st):
    t0, last, wmin, widx, nan_kept, k = st["t"], st["prev"], F32(0), h, False, h
    for i in range(h):
        x, step = s[i], t0 + F32(i)
        valid = step <= cov and step <= lim and not st["done"]
        if x > last or not valid:
            k = i
            break
        if np.isnan(x):
            nan_kept = True
        elif widx == h or x < wmin:
            wmin, widx = x, i
        last = x
    if nan_kept:
        wmin, widx = F32(np.nan), h
    elif k < h and (widx == h or BIG < wmin):
        wmin, widx = BIG, k
    if wmin < st["best"]:
        st["best"], st["bmul"] = wmin, sign * (t0 + F32(widx))
    st["prev"], st["t"] = last, t0 + F32(k)
    st["done"] = st["done"] or (k < h and (st["t"] <= cov or st["t"] > lim))


def _batches(s, h, lim, cov, sign, batch, st):
    t0, nb = st["t"], h // batch
    for b in range(nb):
        if st["done"]:
            break
        i0 = b * batch
        t0b = t0 + F32(i0)
        end = (t0b + F32(batch)) - F32(1)
        if not ((F32(np.nan) if np.isnan(end) or np.isnan(lim) else min(end, lim)) <= cov):
            break
        bmin, barg, n_valid, nan_seen = F32(0), -1, 0, False
        for j in range(batch):
            inside = t0 + F32(i0 + j) <= lim
            x = s[i0 + j] if inside else BIG
            n_valid += inside
            if nan_seen:
                continue
            if np.isnan(x):
                nan_seen, bmin, barg = True, x, j
            elif barg < 0 or x < bmin:
                bmin, barg = x, j
        il = i0 + (n_valid - 1 if n_valid > 0 else 0)
        last = s[il] if t0 + F32(il) <= lim else BIG
        keep = not (bmin > st["prev"])
        if keep and bmin < st["best"]:
            st["best"], st["bmul"] = bmin, sign * (t0b + F32(barg))
        if keep:
            st["prev"] = bmin
        interior = keep and bmin < last
        exhausted = t0b + F32(batch) > lim
        st["done"] = not keep or interior or exhausted
    nb_dec = np.floor(((cov - t0) + F32(1)) / F32(batch))
    if not np.isnan(nb_dec):
        nb_dec = min(max(nb_dec, F32(0)), F32(nb))
    st["t"] = t0 + nb_dec * F32(batch)


def _mirror(scores, t_limit, tcov, state, sign, batch):
    """``csrc/walk.cu``'s ``decide_kernel``, one candidate at a time."""
    out = [np.array(x) for x in state]
    for c in range(scores.shape[0]):
        st = dict(prev=out[0][c], best=out[1][c], bmul=out[2][c],
                  done=bool(out[3][c]), t=out[4][c])
        args = (scores[c], scores.shape[1], t_limit[c], tcov[c], F32(sign))
        if batch:
            _batches(*args, batch, st)
        else:
            _greedy(*args, st)
        for i, key in enumerate(("prev", "best", "bmul", "done", "t")):
            out[i][c] = st[key]
    return tuple(torch.as_tensor(x) for x in out)


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("h", WIDTHS)
@pytest.mark.parametrize("batch", BATCHES)
def test_kernel_mirror_matches_plain(batch, h, sign):
    case = _decide_case(h * 101 + (batch or 0), 48, h)
    scores, t_limit, tcov, state = _tensors(case, "cpu")
    want = walk.decide_window(scores, t_limit, tcov, state, sign, batch=batch)
    with np.errstate(invalid="ignore"):
        got = _mirror(scores.numpy(), t_limit.numpy(), tcov.numpy(),
                      tuple(x.numpy() for x in state), sign, batch)
    _same(got, want)
    if batch is None or h >= batch:     # the window decided something
        assert not torch.equal(want[3], state[3])
        assert not torch.equal(want[1], state[1])


def test_decide_window_checks_its_inputs():
    scores, t_limit, tcov, state = _tensors(_decide_case(0, 6, 10), "cpu")
    with pytest.raises(ValueError, match="sign"):
        walk.decide_window(scores, t_limit, tcov, state, 0.5)
    with pytest.raises(ValueError, match="batch"):
        walk.decide_window(scores, t_limit, tcov, state, 1.0, batch=0)
    with pytest.raises(ValueError, match="tcov"):
        walk.decide_window(scores, t_limit, tcov[:5], state, 1.0)
    with pytest.raises(ValueError, match="done"):
        walk.decide_window(scores, t_limit, tcov, state[:3] + (state[4], state[4]), 1.0)
    with pytest.raises(ValueError, match="scores"):
        walk.decide_window(scores.double(), t_limit, tcov, state, 1.0)


def _lockstep_walks(values):
    """The windows of each lockstep walk, in order, from the walks' host-sync
    values: a live count before each extension pass, a live count entering
    the lockstep walk after a non-empty one, then one any-live read a
    window and a last false one."""
    walks, after_ext = [], False
    for v in values:
        if isinstance(v, bool):
            walks[-1] += v
        elif after_ext:
            after_ext = False
            if v:
                walks.append(0)
        else:
            after_ext = v > 0
    return walks


@pytest.mark.parametrize("mode,window", [("batch", 5), ("batch", 10),
                                         ("default", 32), ("indulgent", 32)])
def test_wide_lockstep_equals_per_window_lockstep(monkeypatch, mode, window):
    """Walks far beyond the extension pass: a lockstep window of
    ``_lockstep_width`` steps gives the results of one of ``window`` steps
    (one batch, or the greedy walk's window), in ``ceil(n / factor)``
    windows and host syncs where that takes ``n``."""
    monkeypatch.setattr(tok, "TC", 7)      # a short cover: long lockstep walks
    inputs = [torch.as_tensor(a) for a in _stair_case(21)]
    width = tok._lockstep_width(mode == "batch", window)
    factor = width // window
    assert factor == {5: 12, 10: 6, 32: 2}[window]
    real = topt.host_sync
    runs = {}
    for name, steps in (("wide", width), ("narrow", window)):
        values = []

        def logged(t):
            values.append(real(t))
            return values[-1]
        logged.count = real.count
        monkeypatch.setattr(topt, "host_sync", logged)
        monkeypatch.setattr(tok, "_lockstep_width", lambda batch, w, s=steps: s)
        before = profiling.counts()
        out = tok.optimize_candidates_batch_kernel(*inputs, mode=mode,
                                                   window=window)
        after = profiling.counts()
        real.count = logged.count
        runs[name] = (out, _lockstep_walks(values),
                      {k: after[k] - before[k]
                       for k in ("walks.windows", "host_sync.count")})
    (wide, wide_walks, wide_n), (narrow, narrow_walks, narrow_n) = \
        runs["wide"], runs["narrow"]
    _same(wide, narrow)
    assert narrow[1].abs().max() > 150            # the walks ran far
    assert max(narrow_walks) > factor             # and the lockstep took windows
    assert wide_walks == [math.ceil(n / factor) for n in narrow_walks]
    assert wide_n["walks.windows"] == sum(wide_walks)
    assert narrow_n["walks.windows"] == sum(narrow_walks)
    saved = sum(narrow_walks) - sum(wide_walks)
    assert wide_n["host_sync.count"] == narrow_n["host_sync.count"] - saved


# --- on the card ------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("h", WIDTHS)
@pytest.mark.parametrize("batch", BATCHES)
def test_decide_window_kernel_bit_equal(batch, h, sign):
    """The kernel on the card against the plain version on the CPU, at 0, 1
    and 30,720 candidates."""
    _need_cuda()
    for m in (0, 1, 30720):
        case = _decide_case(m + h * 101 + (batch or 0), m, h)
        before = walk.decide_window.launches
        got = walk.decide_window(*_tensors(case, "cuda"), sign, batch=batch)
        torch.cuda.synchronize()
        assert walk.decide_window.launches == before + (m > 0)
        _same(got, walk.decide_window(*_tensors(case, "cpu"), sign, batch=batch))


@pytest.mark.gpu
@pytest.mark.parametrize("version", [2, 3, 4])
@pytest.mark.parametrize("mode,window", [("batch", 5), ("batch", 10),
                                         ("default", 32), ("indulgent", 32)])
def test_optimizer_kernel_decisions_equal_plain_decisions(monkeypatch, mode,
                                                          window, version):
    """The optimizer on the card, forced stragglers, every generation: the
    kernel's decisions give what the plain decisions give on the card."""
    _need_cuda()
    monkeypatch.setenv("OPENFDCM_TPU_KERNEL_VERSION", str(version))
    monkeypatch.setattr(tok, "TC", 7)      # generation 4: long lockstep walks
    inputs = [torch.as_tensor(a, device="cuda") for a in _stair_case(22)]
    before = walk.decide_window.launches
    got = tok.optimize_candidates_batch_kernel(*inputs, mode=mode, window=window)
    assert walk.decide_window.launches > before + 4
    monkeypatch.setattr(walk, "decide_window", walk.decide_window_plain)
    want = tok.optimize_candidates_batch_kernel(*inputs, mode=mode, window=window)
    _same(got, want)
    assert want[1].abs().max() > 150
