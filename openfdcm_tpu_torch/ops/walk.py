"""The walk decisions over one scored window, in one launch.

The greedy walks (DefaultOptimize, IndulgentOptimize) and BatchOptimize's
batches decide, per candidate, where its walk stops and which step is its
best over window scores ``(M, H)`` at steps ``t0 .. t0 + H - 1``.  The plain
version is :func:`decide_window_plain` (vectorized mask algebra, the JAX
package's ``optimize_kernel._greedy_chain_cov`` / ``_batch_chain_cov``,
which the JAX-parity tests hold through
:mod:`~openfdcm_tpu_torch.matching.optimize_kernel`); the kernel is
bit-equal to it.

Replaces no TPU kernel: the JAX package decides a window inside one XLA
program, while the plain version dispatches 30 to 450 small eager operations
a window, each costing host time and no device work.  CUDA source:
``csrc/walk.cu`` (a thread a candidate, in step order).
"""
from __future__ import annotations

import torch

from . import build

BIG = 3.0e38    # a step outside the walk


def first_true(mask):
    """Index of the first ``True`` per row of ``mask (C, K)`` (``K`` where
    none): an explicit first-occurrence rule on every device."""
    k = mask.shape[1]
    idx = torch.arange(k, device=mask.device).expand_as(mask)
    return torch.where(mask, idx, k).amin(dim=1)


def _steps(t0, h):
    """Steps ``t0 + i``, ``i < h``, of a window: ``(C, h)`` f32."""
    return t0[:, None] + torch.arange(h, dtype=torch.float32, device=t0.device)[None, :]


def _chain_prefix(scores, prev_kept, valid):
    """Greedy-walk window logic, vectorized (JAX ``optimize._chain_prefix``).

    Given window ``scores (C, K)``, the previous kept score ``prev_kept
    (C,)`` and per-step validity, returns ``(k, wmin, wmin_idx, new_prev,
    any_stop)``: the kept prefix length (before the first ascent or invalid
    step), the first minimum over the kept prefix and its index, the last
    kept score, and whether the walk stopped inside this window.  The first
    stop and the first minimum are taken by index (:func:`first_true`),
    not left to ``argmax``/``argmin`` tie rules."""
    k_win = scores.shape[1]
    prev = torch.cat([prev_kept[:, None], scores[:, :-1]], dim=1)
    stop = (scores > prev) | ~valid
    k = first_true(stop)
    any_stop = k < k_win
    kept = torch.arange(k_win, device=scores.device)[None, :] < k[:, None]
    masked = torch.where(kept, scores, BIG)
    wmin = masked.amin(dim=1)
    wmin_idx = first_true(masked == wmin[:, None])
    last = torch.gather(masked, 1, torch.clamp_min(k - 1, 0)[:, None])[:, 0]
    new_prev = torch.where(k > 0, last, prev_kept)
    return k, wmin, wmin_idx, new_prev, any_stop


def _batch_step(carry, inp, *, sign, batch, t_limit):
    """One BatchOptimize batch decision (``batchoptimize.cpp:60-93``)."""
    prev, best, bmul, done = carry
    bmin, barg, last, t0b = inp
    active = ~done
    keep = active & ~(bmin > prev)          # break *before* keeping
    improve = keep & (bmin < best)
    best = torch.where(improve, bmin, best)
    bmul = torch.where(improve, sign * (t0b + barg), bmul)
    prev = torch.where(keep, bmin, prev)
    interior = keep & (bmin < last)         # break *after* keeping
    exhausted = (t0b + batch) > t_limit
    done = done | ~keep | interior | exhausted
    return prev, best, bmul, done


def _batch_stats(scores, t_limit, t0, batch):
    """Per-batch (min, argmin, last-valid, per-batch t0) over dense scores
    ``(C, H)`` starting at per-candidate multiplier ``t0``."""
    c, h = scores.shape
    nb = h // batch
    vv = _steps(t0, h) <= t_limit[:, None]
    masked = torch.where(vv, scores, BIG).reshape(c, nb, batch)
    bmin, barg = masked.min(dim=2)
    n_valid = vv.reshape(c, nb, batch).sum(dim=2)
    last = torch.gather(masked, 2, torch.clamp_min(n_valid - 1, 0)[..., None])[..., 0]
    t0s = t0[None, :] + (torch.arange(nb, dtype=torch.float32,
                                      device=scores.device) * batch)[:, None]
    return bmin, barg.to(torch.float32), last, t0s


def decide_window_plain(scores, t_limit, tcov, state, sign, batch=None):
    """:func:`decide_window` as vectorized mask algebra, on any device.

    Greedy (``batch`` None; JAX ``optimize_kernel._greedy_chain_cov``): the
    kept prefix runs up to the first ascent or invalid step; a stop caused
    by coverage alone leaves the candidate live with ``t_next`` at the first
    unevaluated step.  Batch (JAX ``_batch_chain_cov``): a batch is
    decidable only when all its legal steps were evaluated
    (``min(batch_end, t_limit) <= tcov``); the first undecidable batch
    freezes the candidate, which resumes at that batch."""
    prev, best, bmul, done, t0 = state
    h = scores.shape[1]
    if batch is None:
        idx = _steps(t0, h)
        valid = (idx <= tcov[:, None]) & (idx <= t_limit[:, None]) & ~done[:, None]
        k, wmin, wmin_idx, prev, stopped = _chain_prefix(scores, prev, valid)
        improve = wmin < best
        best = torch.where(improve, wmin, best)
        bmul = torch.where(improve, sign * (t0 + wmin_idx.to(torch.float32)), bmul)
        t_next = t0 + k.to(torch.float32)
        # the walk ends at an ascent (an evaluated step) or past its limit; a
        # stop at an unevaluated step within the limit leaves it live
        done = done | (stopped & ((t_next <= tcov) | (t_next > t_limit)))
        return prev, best, bmul, done, t_next
    nb = h // batch
    bmin, barg, last, t0s = _batch_stats(scores[:, :nb * batch], t_limit, t0,
                                         batch)
    st = (prev, best, bmul, done)
    frozen = torch.zeros_like(done)
    for b in range(nb):
        t0b = t0s[b]
        legal_end = torch.minimum(t0b + batch - 1, t_limit)
        decidable = (legal_end <= tcov) & ~frozen
        nst = _batch_step(st, (bmin[:, b], barg[:, b], last[:, b], t0b),
                          sign=sign, batch=batch, t_limit=t_limit)
        st = tuple(torch.where(decidable, n, o) for n, o in zip(nst, st))
        frozen = frozen | ~decidable
    prev, best, bmul, done = st
    nb_dec = torch.clamp(torch.floor((tcov - t0 + 1) / batch), 0, nb)
    return prev, best, bmul, done, t0 + nb_dec * batch


def decide_window(scores, t_limit, tcov, state, sign, batch=None):
    """New walk state ``(prev, best, bmul, done, t_next)`` after window
    ``scores (M, H)`` (a view with any row stride is read in place), where
    only steps ``<= tcov (M,)`` were evaluated and the walk ends past
    ``t_limit (M,)``.  ``state``: ``(prev, best, bmul, done, t0)``, float32
    but ``done`` bool, each ``(M,)``; ``sign``: +1.0 or -1.0; ``batch``:
    BatchOptimize's batch size, or None for the greedy walk.  CUDA kernel
    for CUDA tensors (counted in ``decide_window.launches``),
    :func:`decide_window_plain` for CPU tensors."""
    prev, best, bmul, done, t0 = state
    if sign not in (1.0, -1.0):
        raise ValueError(f"sign {sign!r}: need +1.0 or -1.0")
    if batch is not None and batch < 1:
        raise ValueError(f"batch {batch!r}: need a size of at least 1")
    if scores.dtype != torch.float32 or scores.ndim != 2:
        raise ValueError(f"scores: need a 2-d float32 tensor, got "
                         f"{tuple(scores.shape)} {scores.dtype}")
    m, h = scores.shape
    vectors = dict(t_limit=t_limit, tcov=tcov, prev=prev, best=best, bmul=bmul,
                   done=done, t0=t0)
    for name, x in vectors.items():
        want = torch.bool if name == "done" else torch.float32
        if x.dtype != want or tuple(x.shape) != (m,):
            raise ValueError(f"{name}: need a ({m},) {want} tensor, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if not build.use_kernel(scores, *vectors.values()):
        return decide_window_plain(scores, t_limit, tcov, state, sign, batch)
    if scores.stride(1) != 1:
        scores = scores.contiguous()
    out = torch.empty((4, m), dtype=torch.float32, device=scores.device)
    out_done = torch.empty(m, dtype=torch.bool, device=scores.device)
    if m:
        vec = [x.contiguous() for x in vectors.values()]
        ld = scores.stride(0) if m > 1 else h      # one row: any stride
        build.launch("fdcm_decide_window", scores.device, scores.data_ptr(),
                     ld, *(x.data_ptr() for x in vec),
                     out.data_ptr(), out_done.data_ptr(), m, h,
                     1 if sign > 0 else -1, batch or 0)
        decide_window.launches += 1
    return out[0], out[1], out[2], out_done, out[3]


decide_window.launches = 0
