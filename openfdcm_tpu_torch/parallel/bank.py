"""Template-bank sharding (port of :mod:`openfdcm_tpu.parallel.bank`).

At 10k-1M templates the bank's candidate tensor, and at 1M the bank's line
tensor itself (``(T, lmax, 4)`` f32, about 0.5 GB at ``lmax`` 32), no
longer fits one device, so the bank is split along a ``"bank"`` mesh axis:

- the padded template tables stay host numpy until each shard's upload,
  so every entry holds only its ``T / n_bank`` templates;
- (template, scene-line) pairs are made per shard with shard-local
  template ids, so every candidate is scored where its template lies;
- each shard searches, penalizes and keeps its top-k; the shards' rows are
  gathered and re-ranked by (score, global candidate index).  Only ``(S,
  k)`` rows leave a shard.

A ``"scene"`` axis beside it splits the scenes of each chunk, built and
searched per block.  Scores equal the unsharded ``match_many(...,
top_k=k)``'s bit for bit; equal scores rank by this path's global candidate
index.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import geometry as geo
from ..matching import optimize as opt
from ..matching.match import (Match, _bucket, _gather_rerank, _penalized_topk,
                              _search_device_batch)
from ..matching.penalty import DefaultPenalty, ExponentialPenalty
from ..matching.pipeline import build_featuremap_batch
from ..matching.search import (ConcentricRangeStrategy, DefaultSearch,
                               bank_pairs, establish_search_strategy)
from .mesh import Mesh

__all__ = ["prepare_bank_shards", "match_many_bank_sharded"]


def prepare_bank_shards(templates, n_bank: int):
    """Pad templates to ``n_bank`` equal shards of host arrays: a dict of
    ``lines (T_pad, lmax, 4)``, ``mask (T_pad, lmax)``, ``line_lengths
    (T_pad, lmax)``, ``counts (T_pad,)``, ``tmpl_lengths (T_pad,)``, with
    ``t_shard``, the real count ``t_real``, ``host`` (the templates) and
    ``lmax``.  Shard ``b`` owns rows ``[b * t_shard, (b + 1) * t_shard)``;
    padding templates are empty and make no pairs.  Nothing is uploaded: a
    1M-template bank never lies whole on one device."""
    tmpls = [geo.as_lines_np(t) if np.asarray(t).size else
             np.zeros((0, 4), np.float32) for t in templates]
    t_real = len(tmpls)
    t_shard = max(1, -(-t_real // n_bank))
    t_pad = t_shard * n_bank
    lmax = max(1, max((t.shape[0] for t in tmpls), default=1))
    lines = np.zeros((t_pad, lmax, 4), np.float32)
    mask = np.zeros((t_pad, lmax), bool)
    for i, t in enumerate(tmpls):
        lines[i, : t.shape[0]] = t
        mask[i, : t.shape[0]] = True
    d = lines[:, :, 2:4] - lines[:, :, 0:2]
    line_lengths = np.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2).astype(np.float32)
    line_lengths[~mask] = 0.0
    return dict(lines=lines, mask=mask, line_lengths=line_lengths,
                counts=mask.sum(axis=1).astype(np.int64),
                tmpl_lengths=line_lengths.sum(axis=1).astype(np.float32),
                t_shard=t_shard, t_real=t_real, host=tmpls, lmax=lmax)


def _shard_pairs(searcher, shards, scene_arr, b: int) -> np.ndarray:
    """Pairs of bank shard ``b`` against one scene, template ids local to
    the shard, in reference emplace order within the shard."""
    t_shard = shards["t_shard"]
    lo, hi = b * t_shard, (b + 1) * t_shard
    if isinstance(searcher, (DefaultSearch, ConcentricRangeStrategy)):
        return bank_pairs(searcher, shards["line_lengths"][lo:hi],
                          shards["counts"][lo:hi], scene_arr)
    pairs = []
    for ti in range(lo, min(hi, shards["t_real"])):
        t = shards["host"][ti]
        if t.shape[0] == 0:
            continue
        for tl, sl in establish_search_strategy(searcher, t, scene_arr):
            pairs.append((ti - lo, tl, sl))
    return np.asarray(pairs, np.int64).reshape(-1, 3)


def match_many_bank_sharded(scenes, templates, params, searcher, optimizer,
                            *, mesh: Mesh, top_k: int, penalty=None,
                            template_lengths=None, pad_to: int = 128,
                            scene_chunk: int | None = None,
                            scene_axis: str = "scene",
                            bank_axis: str = "bank") -> list:
    """``match_many(..., top_k=k)`` with the template bank split along
    ``mesh[bank_axis]`` and each chunk's scenes along ``mesh[scene_axis]``
    (``scene_chunk`` scenes per chunk, default 8 per scene block).  The
    penalty must have the reference's power form (None, ``DefaultPenalty``,
    ``ExponentialPenalty``).  Returns ``list[list[Match]]`` per scene, the
    k best ascending, gathered onto the mesh's first entry."""
    mesh.require_local("match_many_bank_sharded")
    n_bank = mesh.axis_size(bank_axis)
    n_sc = mesh.axis_size(scene_axis)
    shards = prepare_bank_shards(templates, n_bank)
    t_shard = shards["t_shard"]
    if template_lengths is not None:
        tl = np.zeros((t_shard * n_bank,), np.float32)
        tl[: len(template_lengths)] = np.asarray(template_lengths, np.float32)
        shards = dict(shards, tmpl_lengths=tl)
    if penalty is None:
        tau = float("nan")
    elif type(penalty) is DefaultPenalty:
        tau = 1.0
    elif type(penalty) is ExponentialPenalty:
        tau = float(penalty.tau)
    else:
        raise ValueError("the bank-sharded path needs a power-form penalty")

    uploads = {}

    def tables(b, dev):
        """Bank shard ``b``'s lines, mask and lengths on ``dev``, uploaded
        once per (shard, device)."""
        if (b, dev) not in uploads:
            rows = slice(b * t_shard, (b + 1) * t_shard)
            uploads[b, dev] = tuple(torch.as_tensor(shards[k][rows], device=dev)
                                    for k in ("lines", "mask", "tmpl_lengths"))
        return uploads[b, dev]

    arrs = [geo.as_lines_np(s) for s in scenes]
    if scene_chunk is None:
        scene_chunk = 8 * n_sc
    scene_chunk = max(n_sc, (scene_chunk // n_sc) * n_sc)
    out = [[] for _ in scenes]        # a scene without lines has no matches
    live = [i for i, a in enumerate(arrs) if a.shape[0] > 0]
    for lo in range(0, len(live), scene_chunk):
        idx = live[lo: lo + scene_chunk]
        pad_idx = idx + [idx[0]] * (-len(idx) % n_sc)
        res = _dispatch_chunk([arrs[i] for i in pad_idx], searcher, optimizer,
                              params, mesh, shards, tables, tau, top_k, pad_to,
                              scene_axis, bank_axis)
        for i, matches in zip(idx, res):
            out[i] = matches
    return out


def _dispatch_chunk(arrs, searcher, optimizer, params, mesh, shards, tables,
                    tau, top_k, pad_to, scene_axis, bank_axis):
    """One scene chunk: the build (scene-sharded where the mesh has a
    ``"scene"`` axis), the per-shard pairs, and per (scene block, bank
    shard) a search, penalize and top-k on that entry, then the re-rank
    across the bank shards."""
    s_count = len(arrs)
    n_bank = mesh.axis_size(bank_axis)
    n_sc = mesh.axis_size(scene_axis)
    t_shard = shards["t_shard"]
    out_dev = mesh.resolve()
    fms = build_featuremap_batch(arrs, params, pad_to=pad_to, device=out_dev,
                                 mesh=mesh)
    fs = torch.tensor([[float(w), float(h)] for (w, h) in fms.feature_sizes],
                      device=out_dev)
    per = [[_shard_pairs(searcher, shards, a, b) for b in range(n_bank)]
           for a in arrs]
    pb = _bucket(max((p.shape[0] for row in per for p in row), default=1), 64)
    pair_arr = np.zeros((s_count, n_bank * pb, 3), np.int64)
    pair_valid = np.zeros((s_count, n_bank * pb), bool)
    for i, row in enumerate(per):
        for b, p in enumerate(row):
            pair_arr[i, b * pb: b * pb + p.shape[0]] = p
            pair_valid[i, b * pb: b * pb + p.shape[0]] = True
    scene_arr = np.zeros((s_count, _bucket(max(a.shape[0] for a in arrs), 128), 4),
                         np.float32)
    for i, a in enumerate(arrs):
        scene_arr[i, : a.shape[0]] = a

    mode, window = opt.optimizer_mode(optimizer)
    dense_steps = opt.dense_step_count(optimizer, int(fs.max()))
    kk = min(top_k, 2 * pb)
    s_blk = s_count // n_sc
    rows_out = []
    for i in range(n_sc):
        rows = slice(i * s_blk, (i + 1) * s_blk)
        shard_rows = []
        for b in range(n_bank):
            dev = mesh.device(**{scene_axis: i, bank_axis: b})
            lines, mask, lengths = tables(b, dev)
            cols = slice(b * pb, (b + 1) * pb)
            pt, ptl, psl = (torch.as_tensor(pair_arr[rows, cols, j], device=dev)
                            for j in range(3))
            ok = torch.as_tensor(pair_valid[rows, cols],
                                 device=dev).repeat_interleave(2, dim=1)
            scores, mats, valid = _search_device_batch(
                lines, mask, pt, ptl, psl,
                torch.as_tensor(scene_arr[rows], device=dev),
                fms.dt3[rows].to(dev), fms.angles.to(dev),
                fms.scene_translations[rows].to(dev), fs[rows].to(dev),
                mode=mode, window=max(window, 1), dense_steps=dense_steps,
                cand_ok=ok)
            tof = pt.repeat_interleave(2, dim=1)              # local ids
            sk, mk, idx, _ = _penalized_topk(scores, mats, valid, ok, tof,
                                             lengths, tau, kk)
            shard_rows.append((sk, torch.gather(tof, 1, idx) + b * t_shard,
                               idx + b * (2 * pb), mk))
        sk, tk, gk, mk = zip(*shard_rows)
        if n_bank > 1:
            sk, _, mk, tk = _gather_rerank(out_dev, min(top_k, n_bank * kk),
                                           sk, gk, mk, tk)
        else:
            sk, mk, tk = sk[0], mk[0], tk[0]
        rows_out.append((sk, mk, tk))
    sk, mk, tk = (Mesh.all_gather(x, out_dev).cpu().numpy() for x in zip(*rows_out))
    return [[Match(int(tk[i, j]), float(sk[i, j]), mk[i, j].copy())
             for j in range(sk.shape[1]) if np.isfinite(sk[i, j])][:top_k]
            for i in range(s_count)]
