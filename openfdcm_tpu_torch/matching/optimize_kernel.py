"""Kernel-backed optimizer walks (port of
:mod:`openfdcm_tpu.matching.optimize_kernel`).

A window kernel scores every candidate on a 128-lane window around its
aligned position (steps ``m = 0..63`` and ``m = -1..-64``); the
reference's greedy or batch decisions then run on those windows, up to
each candidate's covered steps ``tc``.  Walks that leave
the covered window finish in :func:`_straggler`: one one-sided extension
pass of 64 steps from each live candidate's resume step (covering
``cover`` of them), then a lockstep walk on kernel K1, at least 64 steps a
window (:func:`_lockstep_width`).  Every window's decisions are one launch
of :func:`~openfdcm_tpu_torch.ops.walk.decide_window` on the card, its
plain version's mask algebra on the CPU.

The window kernel is chosen by ``OPENFDCM_TPU_KERNEL_VERSION``, the JAX
package's own switch (:func:`kernel_version`):

- 4 (default): kernel K1 (:mod:`openfdcm_tpu_torch.ops.window`), exact
  probes on every lane, uniform coverage ``TC = 63`` (the TPU generation
  4's per-candidate caps came from VMEM patch sizes and are dropped);
- 3: kernel K6 (:mod:`openfdcm_tpu_torch.ops.window_v3`), per-candidate
  ``tc`` from the row budget and the one-chunk column fit, with deviant
  candidates quarantined;
- 2: kernel K5 (:mod:`openfdcm_tpu_torch.ops.window_v2`), per-candidate
  ``tc`` from the patch's row budget.

A dispatch whose canvas the chosen generation cannot serve (generation
2: a square canvas of at least 256; generation 3: a square canvas whose
side is a multiple of 128) runs generation 4's windows instead, chosen by
shape before any launch as the JAX package's ``kernel_supported`` chooses
(:func:`window_generation`).

DenseOptimize runs on K1 at every generation (the JAX package has no
Pallas path for it): the aligned step from a one-lane call, then per
direction one-sided 64-lane calls from ``t0 = 1 + 64 i`` up to the
host-known step count, steps past each candidate's limit masked, the
first minimum kept.  It needs no host sync.

At every generation, every window-kernel call of a dispatch (K1, K5 or
K6) reads one tiled copy of the stack
(:func:`~openfdcm_tpu_torch.ops.window.tile_stack`).  Results do not
depend on the generation or on ``TC``
(``tests/test_torch_window.py``, ``tests/test_torch_greedy.py``).

Scene-batched: ``(S, C, ...)`` candidates against an ``(S, D, Q, Q)`` LI
stack.
"""
from __future__ import annotations

import os
from functools import partial

import torch

from ..core import geometry as geo
from ..core import rasterize as ras
from ..ops import walk as wkw
from ..ops import window as wk
from ..ops import window_v2 as wk2
from ..ops import window_v3 as wk3
from ..profiling import count, span
from . import featuremap as fm
from . import optimize as opt

TC = 63     # generation 4: covered steps per direction, main and extension pass


def kernel_version() -> int:
    """The window-kernel generation: ``OPENFDCM_TPU_KERNEL_VERSION``, read
    at call time, default 4.  As in the JAX package, 3 and 4 select their
    generation and any other integer generation 2; a value that is not an
    integer raises ``ValueError``."""
    raw = os.environ.get("OPENFDCM_TPU_KERNEL_VERSION", "4")
    try:
        version = int(raw)
    except ValueError:
        raise ValueError(f"OPENFDCM_TPU_KERNEL_VERSION={raw!r} is not an "
                         "integer (3 or 4 select their window generation, "
                         "any other integer generation 2)") from None
    return version if version in (3, 4) else 2


def window_generation(li_shape) -> int:
    """The window generation a dispatch on an ``(S, D, H, W)`` stack runs:
    :func:`kernel_version`, or 4 where that generation cannot serve the
    canvas (generation 2 needs a square canvas of at least
    ``window_v2.PATCH_W``, generation 3 a square canvas whose side is a
    multiple of 128; JAX ``optimize_kernel.kernel_supported``)."""
    version = kernel_version()
    h, w = li_shape[-2:]
    if version == 2 and not (h == w and w >= wk2.PATCH_W):
        return 4
    if version == 3 and not (h == w and w % 128 == 0):
        return 4
    return version


# the plain decisions over a covered window (JAX ``_greedy_chain_cov`` with
# ``batch`` None, ``_batch_chain_cov`` with a batch size), which the
# JAX-parity tests hold; the card runs ``wkw.decide_window``
_greedy_chain_cov = _batch_chain_cov = wkw.decide_window_plain


def _compact_sel(done, b):
    """First ``b`` live candidate indices, in index order (stable argsort)."""
    return torch.argsort(done.to(torch.int32), stable=True)[:b]


def _lockstep_width(batch: bool, window: int) -> int:
    """Steps a lockstep window of :func:`_straggler` scores: ``max(window,
    K_POS)``, in batch mode rounded down to whole batches of ``window``
    (at least one)."""
    width = max(window, wk.K_POS)
    return width // window * window if batch else width


def _straggler(state, sign, t_lim, batch, eval_at, ext_eval, width):
    """Finish walks that left the covered window.  The live count is read
    on the host (the JAX package's ``lax.switch`` ladder becomes a host
    branch): an extension pass on exactly the live candidates, then a
    lockstep walk (:func:`~.optimize._lockstep_walk`) on those still live,
    ``width`` steps a window.  ``batch``: BatchOptimize's batch size, or
    None for the greedy walk."""
    with span("walks.straggler"):
        live = opt.host_sync((~state[3]).sum())
        count("walks.ext_candidates", live)
        if live == 0:
            return state
        sel = _compact_sel(state[3], live)
        sub = tuple(x[sel] for x in state)
        scores, cover = ext_eval(sel, ~sub[3], sign, sub[4])
        # steps t0 .. t0 + cover are covered; a live candidate with cover 0
        # was quarantined (generation 3: weight 0 on every line) and has
        # none, not even t0, whose lane holds 0 (the JAX package takes that
        # lane as step t0's score: ROADMAP Queue 3)
        cover = cover.to(torch.float32)
        tcov = torch.where(cover > 0, sub[4] + cover, sub[4] - 1)
        sub = wkw.decide_window(scores, t_lim[sel], tcov, sub, sign, batch)
        state = tuple(x.index_put((sel,), v) for x, v in zip(state, sub))

        live = opt.host_sync((~state[3]).sum())
        count("walks.lockstep_candidates", live)
        if live == 0:
            return state
        sel = _compact_sel(state[3], live)
        sub = tuple(x[sel] for x in state)
        sub = opt._lockstep_walk(eval_at(sign, width, sel), t_lim[sel], sub,
                                 sign, batch)
        return tuple(x.index_put((sel,), v) for x, v in zip(state, sub))


def _dense(window, ep, sid, wt, tr, safe_rast, t_pos, t_neg, dense_steps):
    """DenseOptimize on ``window`` (K1; JAX ``optimize.optimize_candidates``, mode
    ``"dense"``): the aligned score, then per direction ``dense_steps / 64``
    one-sided windows from ``t0 = 1 + 64 i``; steps past the candidate's
    limit are masked, the first minimum of a window replaces the best only
    when strictly lower.  A candidate whose limit ends before a window
    starts gets weight 0 in it: K1 skips its lines and its lanes are
    masked anyway.  Returns ``(best (M,), step multiplier (M,))``."""
    m = wt.shape[0]
    dev = wt.device
    zero = torch.zeros(m, dtype=torch.float32, device=dev)
    best = window(ep, sid, wt, tr, safe_rast, zero, count=1,
                  two_sided=False)[:, 0]
    mul = zero
    lanes = torch.arange(wk.K_POS, dtype=torch.float32, device=dev)
    for sign, t_lim in ((1.0, t_pos), (-1.0, t_neg)):
        vdir = (sign * safe_rast).contiguous()
        for i in range(-(-dense_steps // wk.K_POS)):
            t0 = 1.0 + wk.K_POS * i
            wt_i = torch.where((t_lim >= t0)[:, None], wt, 0.0).contiguous()
            scores = window(ep, sid, wt_i, tr, vdir, torch.full_like(zero, t0),
                            count=wk.K_POS, two_sided=False)
            steps = t0 + lanes
            scores = torch.where(steps[None, :] <= t_lim[:, None], scores,
                                 wkw.BIG)
            wmin = scores.amin(dim=1)
            warg = wkw.first_true(scores == wmin[:, None]).to(torch.float32)
            better = wmin < best
            best = torch.where(better, wmin, best)
            mul = torch.where(better, sign * (t0 + warg), mul)
    return best, mul


def optimize_candidates_batch_kernel(li, angles, scene_tr, feature_size,
                                     cand_lines, cand_mask, cand_align, *,
                                     mode: str, window: int,
                                     dense_steps: int = 0, cand_ok=None,
                                     take=None):
    """Scene-batched optimize on the window kernel of
    :func:`window_generation` (main and extension pass) and kernel K1
    (lockstep walks and the dense sweep).

    ``li``: ``(S, D, H, W)`` LI stack; ``angles``: ``(D,)``;
    ``cand_lines``: ``(S, C, L, 4)``; ``cand_mask``: ``(S, C, L)``;
    ``cand_align``: ``(S, C, 2)``; ``scene_tr`` / ``feature_size``:
    ``(S, 2)``.  ``mode``: ``"default"``, ``"indulgent"``, ``"batch"`` or
    ``"dense"``; ``window``: the greedy walks' window (a lockstep window
    scores :func:`_lockstep_width` steps), or the batch size; ``dense_steps``: the dense sweep's steps per
    direction (:func:`~.optimize.dense_step_count`).  ``cand_ok``: optional
    ``(S, C)`` candidates the caller masks anyway (kept out of the windows
    and walks).  ``take``: a reader of the stack's probe values (JAX
    ``take_fn``, the row-sharded search's gather): every window then runs
    :func:`~openfdcm_tpu_torch.ops.window.window_scores_plain`'s arithmetic
    (K1's line order) through it, and ``li`` stands for the stack through
    its ``shape`` and ``device`` only.
    Returns ``(scores (S, C), translations (S, C, 2), valid (S, C))``."""
    if mode not in ("default", "indulgent", "batch", "dense"):
        raise ValueError(f"unknown optimizer mode {mode!r}")
    version = window_generation(li.shape) if take is None else 4
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
    slice_idx = fm.classify_lines(angles, cand_lines)             # (S, C, L)

    # --- flatten to one candidate axis ---------------------------------
    scene_of = torch.arange(s, device=dev).repeat_interleave(c)
    si_raw = slice_idx.reshape(m, l)
    sid = wk2.global_slice(si_raw, scene_of, d)
    ep = cand_lines.reshape(m, l, 4).contiguous()
    cm_flat = cand_mask.reshape(m, l)
    valid_f = valid.reshape(m)
    wt = (cm_flat & valid_f[:, None]).to(torch.float32)
    tr = scene_tr.repeat_interleave(c, dim=0).contiguous()
    rast_f = rast.reshape(m, 2)
    safe_rast = torch.where(valid_f[:, None], rast_f, 0.0).contiguous()
    zero = torch.zeros(m, dtype=torch.float32, device=dev)
    t_pos = torch.where(valid_f, torch.trunc(torch.where(valid_f, pos.reshape(m), 0.0)), 0.0)
    t_neg = torch.where(valid_f, torch.trunc(torch.where(valid_f, -neg.reshape(m), 0.0)), 0.0)

    if take is None:
        # every window-kernel call of the dispatch reads the tiled copy
        tiles = wk.tile_stack(li)
        window_fn = partial(wk.window_scores, li, tiles=tiles)
    else:
        window_fn = partial(wk.window_scores_plain, li, take=take)
    if mode == "dense":
        best, mul = _dense(window_fn, ep, sid, wt, tr, safe_rast, t_pos, t_neg,
                           dense_steps)
        translation = (mul[:, None] * safe_rast).reshape(s, c, 2)
        return best.reshape(s, c), translation, valid
    if version == 4:
        win = window_fn(ep, sid, wt, tr, safe_rast, zero, count=wk.K_LANES,
                        two_sided=True)
        tc = torch.full((m,), float(TC), device=dev)
    else:
        entry = wk3.window_scores_v3 if version == 3 else wk2.window_scores_v2
        win, tc = entry(li, scene_tr, cand_lines, cand_mask, rast, valid,
                        slice_idx, tiles=tiles)
        win, tc = win.reshape(m, wk.K_LANES), tc.reshape(m).to(torch.float32)
    s0 = win[:, 0]
    if version == 3:
        # a quarantined candidate (tc = 0, weight 0 on every line) has no
        # trusted lane, not even m = 0: its aligned score comes from K1 (the
        # JAX package keeps the lane's 0, a false perfect match: Queue 3)
        exact0 = window_fn(ep, sid, wt, tr, safe_rast, zero, count=1,
                           two_sided=False)[:, 0]
        s0 = torch.where(tc == 0, exact0, s0)
    pos_scores = win[:, 1:wk.K_POS]
    neg_scores = win[:, wk.K_POS:]

    def eval_at(sign, count, sel):
        vdir = (sign * safe_rast[sel]).contiguous()

        def f(t0):
            return window_fn(ep[sel], sid[sel], wt[sel], tr[sel], vdir,
                             t0.contiguous(), count=count, two_sided=False)
        return f

    def ext_eval(sel, active, sign, t0):
        vdir = (sign * rast_f[sel]).contiguous()
        if version == 4:
            cover = torch.where(torch.isfinite(vdir).all(dim=-1) & active,
                                float(TC), 0.0)
            return window_fn(ep[sel], sid[sel], wt[sel], tr[sel], vdir,
                             t0.contiguous(), count=wk.K_POS,
                             two_sided=False), cover
        entry = wk3.window_scores_v3_ext if version == 3 \
            else wk2.window_scores_v2_ext
        return entry(li, ep[sel], cm_flat[sel], vdir, active, si_raw[sel],
                     scene_of[sel], scene_tr, t0, tiles=tiles)

    batch = window if mode == "batch" else None
    width = _lockstep_width(batch is not None, window)
    ones = torch.ones(m, dtype=torch.float32, device=dev)

    state = (s0, s0, zero, t_pos < 1, ones)
    state = wkw.decide_window(pos_scores, t_pos, tc, state, 1.0, batch)
    state = _straggler(state, 1.0, t_pos, batch, eval_at, ext_eval, width)
    prev, best, mul, _, _ = state

    # indulgent: the negative walk's chain restarts from the aligned score
    # (indulgentoptimize.cpp:56-58)
    nstate = (s0 if mode == "indulgent" else prev, best, mul, t_neg < 1, ones)
    nstate = wkw.decide_window(neg_scores, t_neg, tc, nstate, -1.0, batch)
    nstate = _straggler(nstate, -1.0, t_neg, batch, eval_at, ext_eval, width)
    _, best, mul, _, _ = nstate

    translation = (mul[:, None] * safe_rast).reshape(s, c, 2)
    return best.reshape(s, c), translation, valid
