"""Scene-batched matching pipeline (port of :mod:`openfdcm_tpu.matching.pipeline`).

``build_featuremap_batch`` builds a whole ``[S, depth, PH, PW]`` DT3 stack
(kernels K2, K3, K4); ``match_many`` groups scenes by canvas bucket, builds
each group, and searches it with on-device pair generation, the window
kernels (K1, or K5/K6 under window generation 2/3) and a device-side
penalize + top-k.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import geometry as geo
from ..core import integral
from ..core.dt import dt_from_indicator
from ..core.types import resolve_device
from ..ops.window import tile_shape
from ..profiling import maybe_stage
from . import featuremap as fm
from . import optimize as opt
from .match import (Match, TemplateBank, _bucket,
                    _search_device_batch_topk_genpairs, prepare_templates)
from .optimize_kernel import kernel_version
from .penalty import DefaultPenalty, ExponentialPenalty
from .search import DefaultSearch, bank_line_table, scene_length_mask


@dataclasses.dataclass
class Dt3FeaturemapBatch:
    """A batch of DT3 feature maps on a shared physical canvas."""
    dt3: torch.Tensor                 # (S, depth, PH, PW)
    angles: torch.Tensor              # (depth,)
    scene_translations: torch.Tensor  # (S, 2)
    feature_sizes: tuple              # per-scene logical (w, h)
    params: fm.Dt3Params

    def __len__(self):
        return self.dt3.shape[0]


def build_featuremap_batch(scenes, params: fm.Dt3Params = fm.Dt3Params(),
                           pad_to: int = 128, device="cuda") -> Dt3FeaturemapBatch:
    """Build the DT3 feature maps of a list of scenes on ``device``.

    All scenes share a physical canvas (the max logical size rounded up to
    ``pad_to``); each scene's logical region is reference-exact and its
    padding is zero.  Reference ``dt3cpu.h:174-234``."""
    device = resolve_device(device)
    arrs = [geo.as_lines_np(s) for s in scenes]
    metas = [fm.scene_centered_translation(a, params.padding) for a in arrs]
    phys = max(max(w, h) for _, (w, h) in metas)
    phys = -(-phys // pad_to) * pad_to
    nb = max(max(a.shape[0] for a in arrs), 1)

    s_count = len(arrs)
    lines = np.zeros((s_count, nb, 4), np.float32)
    mask = np.zeros((s_count, nb), bool)
    lhw = np.zeros((s_count, 2), np.int64)
    trs = np.zeros((s_count, 2), np.float32)
    span = 0.0
    for i, (a, (tr, (w, h))) in enumerate(zip(arrs, metas)):
        lines[i, : a.shape[0]] = a + np.concatenate([tr, tr]).astype(np.float32)
        mask[i, : a.shape[0]] = True
        lhw[i] = (h, w)
        trs[i] = tr
        if a.shape[0]:
            d = np.maximum(np.abs(a[:, 2] - a[:, 0]), np.abs(a[:, 3] - a[:, 1]))
            span = max(span, float(np.max(d)))
    # rasterized points per line: trunc(span) + 1 bounds every line (clipping
    # only shrinks spans); bucketed to 64 as in the JAX package
    max_points = min(phys, -(-(int(span) + 2) // 64) * 64)

    angles = fm.make_angles(params.depth)
    lhw_dev = torch.as_tensor(lhw, device=device)
    ind = fm._indicator_batch(
        torch.as_tensor(lines, device=device), torch.as_tensor(mask, device=device),
        lhw_dev, depth=params.depth, phys_h=phys, phys_w=phys,
        max_points=max_points)
    dt3 = dt_from_indicator(ind, metric=params.distance)
    del ind
    dt3 = torch.where(fm._logical_mask(lhw_dev, phys, phys)[:, None], dt3,
                      torch.zeros((), dtype=dt3.dtype, device=dt3.device))
    dt3 = fm.propagate_orientation_relax(
        dt3, fm.propagation_steps(angles, params.dt3_coeff))
    dt3 = integral.line_integral_stack(dt3, angles, lhw)
    return Dt3FeaturemapBatch(
        dt3=dt3, angles=torch.as_tensor(angles, device=device),
        scene_translations=torch.as_tensor(trs, device=device),
        feature_sizes=tuple((w, h) for _, (w, h) in metas), params=params)


def _scene_chunk(c_per_scene: int, lmax: int, tile_bytes: int,
                 device: torch.device) -> int:
    """Scenes per search dispatch, sized by device memory: about 16 bytes
    per candidate line for each of ~8 live candidate tensors plus the
    128-lane window, and the scene's part of the tiled stack copy that
    the window kernels read (``tile_bytes``), against a quarter of free
    device memory (1 GiB on the CPU)."""
    per_cand = 8 * 16 * lmax + 4 * 1024
    if device.type == "cuda":
        budget = torch.cuda.mem_get_info(device)[0] // 4
    else:
        budget = 1 << 30
    return max(1, budget // max(per_cand * c_per_scene + tile_bytes, 1))


def match_many(scenes, templates, params: fm.Dt3Params, searcher, optimizer,
               penalty=None, template_lengths=None, pad_to: int = 128,
               scene_chunk: int | None = None, top_k: int | None = None,
               device="cuda", timer=None) -> list:
    """End-to-end matching of a list of scenes on ``device``.

    Scenes are grouped by canvas bucket; each group is built and searched,
    and results come back in input order: per scene the ``top_k`` best
    matches, penalized when a ``penalty`` is given, sorted ascending.
    ``timer``: optional :class:`~openfdcm_tpu_torch.profiling.StageTimer`."""
    return match_many_async(scenes, templates, params, searcher, optimizer,
                            penalty=penalty, template_lengths=template_lengths,
                            pad_to=pad_to, scene_chunk=scene_chunk,
                            top_k=top_k, device=device, timer=timer)()


def match_many_async(scenes, templates, params: fm.Dt3Params, searcher,
                     optimizer, penalty=None, template_lengths=None,
                     pad_to: int = 128, scene_chunk: int | None = None,
                     top_k: int | None = None, device="cuda", timer=None):
    """:func:`match_many` split into dispatch + collection: runs every build
    and search, and returns a zero-argument ``collect()`` that fetches the
    top-k rows (one device-to-host copy per scene chunk) and returns
    ``list[list[Match]]``."""
    device = resolve_device(device)
    if top_k is None:
        raise NotImplementedError(
            "match_many without top_k (the host ranking path) is not ported "
            "yet: ROADMAP Queue 1 #5")
    if type(searcher) is not DefaultSearch:
        raise NotImplementedError(
            f"search strategy {type(searcher).__name__} is not ported yet "
            "(ROADMAP Queue 1 #5)")
    opt.require_walk_mode(opt.optimizer_mode(optimizer)[0])
    kernel_version()                   # a non-integer generation raises here
    bank = templates if isinstance(templates, TemplateBank) \
        else prepare_templates(templates, device=device)
    if bank.device != device:
        raise ValueError(f"template bank on {bank.device}, search on {device}")

    if penalty is None:
        lengths, tau = np.ones(max(len(bank.host), 1), np.float32), float("nan")
    elif type(penalty) in (DefaultPenalty, ExponentialPenalty):
        lengths = np.asarray(template_lengths if template_lengths is not None
                             else geo.get_template_lengths(bank.host), np.float32)
        tau = 1.0 if type(penalty) is DefaultPenalty else float(penalty.tau)
        if lengths.shape[0] < len(bank.host):   # a device gather would assert
            raise IndexError("In penalize, the size of templatelengths is not "
                             "consistent with match template indices")
    else:
        raise NotImplementedError(f"penalty {type(penalty).__name__} is not ported")
    post = (torch.as_tensor(lengths, device=device), tau, top_k)

    arrs = [geo.as_lines_np(s) for s in scenes]
    buckets = {}
    for i, a in enumerate(arrs):
        if a.shape[0] == 0:
            continue                       # zero-line scene: no matches
        _, (w, h) = fm.scene_centered_translation(a, params.padding)
        buckets.setdefault(-(-max(w, h) // pad_to) * pad_to, []).append(i)

    mt, ms = searcher.get_max_tmpl_lines(), searcher.get_max_scene_lines()
    c_per_scene = 2 * len(bank.host) * min(mt, bank.lmax) * ms
    if scene_chunk is None and buckets:
        phys = max(buckets)
        tile_bytes = 4 * int(np.prod(tile_shape((1, params.depth, phys, phys))))
        scene_chunk = _scene_chunk(c_per_scene, bank.lmax, tile_bytes, device)

    out = [[] for _ in scenes]
    deferred = []
    for key in sorted(buckets):
        idxs = buckets[key]
        with maybe_stage(timer, "build_featuremap", device):
            fms = build_featuremap_batch([scenes[i] for i in idxs], params,
                                         pad_to=pad_to, device=device)
        with maybe_stage(timer, "search_topk_devpairs", device):
            fin = _genpairs_batch_dispatch(searcher, optimizer, fms, bank,
                                           [arrs[i] for i in idxs], post,
                                           scene_chunk)
        deferred.append((idxs, fin))

    def collect() -> list:
        for idxs, fin in deferred:
            for i, rows in zip(idxs, fin()):
                out[i] = [Match(t, s, m.copy()) for (s, t, m) in rows[:top_k]]
        return out

    return collect


def _genpairs_batch_dispatch(searcher, optimizer, featuremaps, bank, arrs,
                             post, scene_chunk: int):
    """Top-k search with on-device pair generation over scene chunks.

    Returns a ``collect()`` closure that copies the packed top-k rows to the
    host and returns, per scene, the ranked ``(penalized_score, tmpl_idx,
    mat (2, 3))`` rows of the valid, finite candidates."""
    lengths_dev, tau, top_k = post
    s_total = len(featuremaps)
    device = featuremaps.dt3.device
    lmax = bank.lmax
    counts = bank.counts_np.astype(np.int64)
    t_count = len(bank.host)
    mt = min(searcher.get_max_tmpl_lines(), lmax)
    ms = searcher.get_max_scene_lines()
    if mt == 0 or ms == 0 or t_count == 0:
        return lambda: [[] for _ in range(s_total)]
    ord_t, k_t = bank_line_table(bank.lengths_np, counts, mt)
    lens_m = np.where(np.arange(lmax)[None, :] < counts[:, None],
                      bank.lengths_np, -np.inf)
    top_vals = np.take_along_axis(lens_m, ord_t.astype(np.int64), axis=1) \
        .astype(np.float32)
    rank_ok = np.arange(mt)[None, :] < k_t[:, None]
    mode, window = opt.optimizer_mode(optimizer)

    nb = _bucket(max((a.shape[0] for a in arrs), default=1), 128)
    scene_arr = np.zeros((s_total, nb, 4), np.float32)
    slen_arr = np.zeros((s_total, nb), np.float32)
    svalid_arr = np.zeros((s_total, nb), bool)
    for i, a in enumerate(arrs):
        scene_arr[i, : a.shape[0]] = a
        slen_arr[i], svalid_arr[i] = scene_length_mask(a, nb)
    fs = np.asarray([[float(w), float(h)] for (w, h) in featuremaps.feature_sizes],
                    np.float32)

    as_dev = lambda a: torch.as_tensor(a, device=device)
    bank_args = (bank.lines, bank.mask, as_dev(top_vals), as_dev(ord_t),
                 as_dev(rank_ok))
    kk = min(top_k, 2 * t_count * mt * ms)
    n_chunks = -(-s_total // max(scene_chunk, 1))
    s_chunk = -(-s_total // n_chunks)
    packed = []
    for lo in range(0, s_total, s_chunk):
        sel = slice(lo, min(lo + s_chunk, s_total))
        sk, mk, tk, vk = _search_device_batch_topk_genpairs(
            *bank_args, as_dev(scene_arr[sel]), as_dev(slen_arr[sel]),
            as_dev(svalid_arr[sel]), featuremaps.dt3[sel], featuremaps.angles,
            featuremaps.scene_translations[sel], as_dev(fs[sel]), lengths_dev,
            tau, mode=mode, window=max(window, 1), k=kk, ms=ms)
        # one (S, k, 9) tensor [score, tmpl, valid, mat(6)] per chunk: one copy
        packed.append(torch.cat([sk[..., None], tk.to(torch.float32)[..., None],
                                 vk.to(torch.float32)[..., None],
                                 mk.reshape(*mk.shape[:2], 6)], dim=-1))

    def collect() -> list:
        out = []
        for p in packed:
            arr = p.cpu().numpy()
            for row in arr:
                out.append([(float(r[0]), int(r[1]), r[3:9].reshape(2, 3))
                            for r in row if r[2] > 0.5 and np.isfinite(r[0])])
        return out
    return collect
