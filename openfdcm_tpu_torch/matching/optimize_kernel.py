"""Kernel-backed BatchOptimize walks (port of
:mod:`openfdcm_tpu.matching.optimize_kernel`).

Kernel K1 (:mod:`openfdcm_tpu_torch.ops.window`) scores every candidate on
a 128-lane window around its aligned position (steps ``m = 0..63`` and
``m = -1..-64``).  Coverage is uniform: every candidate's decisions use
``TC = 63`` steps each way (the TPU's per-candidate ``tc`` caps came from
VMEM patch sizes and are dropped).  The reference's batch decisions then
run as mask algebra on those windows; walks that leave the covered window
finish in :func:`_straggler`: one one-sided K1 extension pass of 64 steps
from each live candidate's resume step, then a lockstep K1 walk.  Results
do not depend on ``TC`` (``tests/test_torch_window.py``).

Scene-batched: ``(S, C, ...)`` candidates against an ``(S, D, Q, Q)`` LI
stack.
"""
from __future__ import annotations

from functools import partial

import torch

from ..core import geometry as geo
from ..core import rasterize as ras
from ..ops import window as wk
from . import featuremap as fm
from . import optimize as opt

TC = 63     # covered steps per direction in the main and extension passes


def _batch_chain_cov(scores, t_limit, tcov, state, sign, batch):
    """BatchOptimize decisions over window ``scores (M, H)`` (steps
    ``t0..t0+H-1``).  A batch is decidable only when all its legal steps were
    evaluated (``min(batch_end, t_limit) <= tcov``); the first undecidable
    batch freezes the candidate, which resumes at that batch."""
    prev, best, bmul, done, t0 = state
    h = scores.shape[1]
    nb = h // batch
    bmin, barg, last, t0s = opt._batch_stats(scores[:, :nb * batch], t_limit,
                                             t0, batch)
    st = (prev, best, bmul, done)
    frozen = torch.zeros_like(done)
    for b in range(nb):
        t0b = t0s[b]
        legal_end = torch.minimum(t0b + batch - 1, t_limit)
        decidable = (legal_end <= tcov) & ~frozen
        nst = opt._batch_step(st, (bmin[:, b], barg[:, b], last[:, b], t0b),
                              sign=sign, batch=batch, t_limit=t_limit)
        st = tuple(torch.where(decidable, n, o) for n, o in zip(nst, st))
        frozen = frozen | ~decidable
    prev, best, bmul, done = st
    nb_dec = torch.clamp(torch.floor((tcov - t0 + 1) / batch), 0, nb)
    return prev, best, bmul, done, t0 + nb_dec * batch


def _compact_sel(done, b):
    """First ``b`` live candidate indices, in index order (stable argsort)."""
    return torch.argsort(done.to(torch.int32), stable=True)[:b]


def _straggler(state, sign, t_lim, chain_cov, eval_at, ext_eval, window):
    """Finish walks that left the covered window.  The live count is read
    on the host (the JAX package's ``lax.switch`` ladder becomes a host
    branch): an extension pass on exactly the live candidates, then a
    lockstep walk on those still live."""
    live = opt.host_sync((~state[3]).sum())
    if live == 0:
        return state
    sel = _compact_sel(state[3], live)
    sub = tuple(x[sel] for x in state)
    scores, cover = ext_eval(sel, ~sub[3], sign, sub[4])
    sub = chain_cov(scores, t_lim[sel], sub[4] + cover, sub, sign)
    state = tuple(x.index_put((sel,), v) for x, v in zip(state, sub))

    live = opt.host_sync((~state[3]).sum())
    if live == 0:
        return state
    sel = _compact_sel(state[3], live)
    sub = tuple(x[sel] for x in state)
    sub = opt._batch_walk(eval_at(sign, window, sel), t_lim[sel], sub, sign,
                          window)
    return tuple(x.index_put((sel,), v) for x, v in zip(state, sub))


def optimize_candidates_batch_kernel(li, angles, scene_tr, feature_size,
                                     cand_lines, cand_mask, cand_align, *,
                                     mode: str, window: int, cand_ok=None):
    """Scene-batched optimize on kernel K1.

    ``li``: ``(S, D, Q, Q)`` LI stack; ``angles``: ``(D,)``;
    ``cand_lines``: ``(S, C, L, 4)``; ``cand_mask``: ``(S, C, L)``;
    ``cand_align``: ``(S, C, 2)``; ``scene_tr`` / ``feature_size``:
    ``(S, 2)``.  ``cand_ok``: optional ``(S, C)`` candidates the caller
    masks anyway (kept out of the windows and walks).
    Returns ``(scores (S, C), translations (S, C, 2), valid (S, C))``."""
    opt.require_batch_mode(mode)
    s, d = li.shape[0], angles.shape[0]
    c, l = cand_mask.shape[1:]
    m = s * c
    dev = li.device

    null_align = geo.relatively_equal(cand_align.abs().sum(dim=-1), 0.0)
    rast = ras.rasterize_vector(cand_align)                       # (S, C, 2)
    neg, pos = fm.minmax_translation_raw(
        cand_lines, rast, feature_size[:, None, :], scene_tr[:, None, :],
        cand_mask)
    valid = torch.isfinite(neg) & torch.isfinite(pos) & ~null_align
    if cand_ok is not None:
        valid = valid & cand_ok
    slice_idx = fm.classify_lines(d, cand_lines)                  # (S, C, L)

    # --- flatten to one candidate axis ---------------------------------
    scene_of = torch.arange(s, device=dev).repeat_interleave(c)
    sid = (slice_idx.reshape(m, l) + (scene_of * d)[:, None]).to(torch.int32)
    ep = cand_lines.reshape(m, l, 4).contiguous()
    valid_f = valid.reshape(m)
    wt = (cand_mask.reshape(m, l) & valid_f[:, None]).to(torch.float32)
    tr = scene_tr.repeat_interleave(c, dim=0).contiguous()
    rast_f = rast.reshape(m, 2)
    safe_rast = torch.where(valid_f[:, None], rast_f, 0.0).contiguous()
    zero = torch.zeros(m, dtype=torch.float32, device=dev)
    t_pos = torch.where(valid_f, torch.trunc(torch.where(valid_f, pos.reshape(m), 0.0)), 0.0)
    t_neg = torch.where(valid_f, torch.trunc(torch.where(valid_f, -neg.reshape(m), 0.0)), 0.0)
    tc = torch.full((m,), float(TC), device=dev)

    win = wk.window_scores(li, ep, sid, wt, tr, safe_rast, zero,
                           count=wk.K_LANES, two_sided=True)
    s0 = win[:, 0]
    pos_scores = win[:, 1:wk.K_POS]
    neg_scores = win[:, wk.K_POS:]

    def eval_at(sign, count, sel):
        vdir = (sign * safe_rast[sel]).contiguous()

        def f(t0):
            return wk.window_scores(li, ep[sel], sid[sel], wt[sel], tr[sel],
                                    vdir, t0.contiguous(), count=count,
                                    two_sided=False)
        return f

    def ext_eval(sel, active, sign, t0):
        vdir = (sign * rast_f[sel]).contiguous()
        cover = torch.where(torch.isfinite(vdir).all(dim=-1) & active,
                            float(TC), 0.0)
        return wk.window_scores(li, ep[sel], sid[sel], wt[sel], tr[sel], vdir,
                                t0.contiguous(), count=wk.K_POS,
                                two_sided=False), cover

    chain_cov = partial(_batch_chain_cov, batch=window)
    ones = torch.ones(m, dtype=torch.float32, device=dev)

    state = (s0, s0, zero, t_pos < 1, ones)
    state = chain_cov(pos_scores, t_pos, tc, state, 1.0)
    state = _straggler(state, 1.0, t_pos, chain_cov, eval_at, ext_eval, window)
    prev, best, mul, _, _ = state

    nstate = (prev, best, mul, t_neg < 1, ones)
    nstate = chain_cov(neg_scores, t_neg, tc, nstate, -1.0)
    nstate = _straggler(nstate, -1.0, t_neg, chain_cov, eval_at, ext_eval, window)
    _, best, mul, _, _ = nstate

    translation = (mul[:, None] * safe_rast).reshape(s, c, 2)
    return best.reshape(s, c), translation, valid
