"""Scene-batched matching pipeline (port of :mod:`openfdcm_tpu.matching.pipeline`).

``build_featuremap_batch`` builds a whole ``[S, depth, PH, PW]`` DT3 stack
(kernels K2, K3, K4); ``match_many`` groups scenes by canvas bucket, builds
each group, and searches it on the window kernels (K1, or K5/K6 under
window generation 2/3) along one of two paths, routed as the JAX package
routes them:

- the top-k path: ``top_k`` given, a ``DefaultSearch`` or
  ``ConcentricRangeStrategy`` and no penalty or a ``DefaultPenalty`` /
  ``ExponentialPenalty``: pairs generated on the device, then a
  device-side penalize + top-k (:func:`_genpairs_batch_dispatch`);
- the host ranking path, for everything else (no ``top_k``, a subclassed
  searcher, a user penalty): host pair tables (:func:`search_batch`),
  every valid candidate back in emplace order, penalized on the host.

Both split a dispatch that would exceed the device budget along the
template (or pair) axis, and merge the parts so the result equals the
unsplit one.
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
from .match import (Match, TemplateBank, _bucket, _genpairs_topk_sharded,
                    _search_device_batch, _search_device_batch_sharded,
                    _search_device_batch_topk, _search_device_batch_topk_genpairs,
                    _search_device_batch_topk_sharded, prepare_templates)
from .optimize_kernel import kernel_version
from .penalty import DefaultPenalty, ExponentialPenalty
from .search import (ConcentricRangeStrategy, DefaultSearch, bank_line_table,
                     bank_pairs, establish_search_strategy, scene_length_mask)

# Device memory a search dispatch may plan for: a quarter of the free
# memory on a card, this many bytes on the CPU.
CPU_BUDGET = 1 << 30


def _bank_pairs_for_scene(searcher, bank, scene_arr) -> np.ndarray:
    """``(tmpl_id, tmpl_line, scene_line)`` pairs of the whole bank against
    one scene, in reference emplace order; vectorized for the built-in
    strategies and their subclasses, per template otherwise."""
    if isinstance(searcher, (DefaultSearch, ConcentricRangeStrategy)):
        return bank_pairs(searcher, bank.lengths_np, bank.counts_np, scene_arr)
    pairs = []
    for ti, t in enumerate(bank.host):
        if t.shape[0] == 0:
            continue
        for tl, sl in establish_search_strategy(searcher, t, scene_arr):
            pairs.append((ti, tl, sl))
    return np.asarray(pairs, np.int32).reshape(-1, 3)


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

    def featuremap(self, i: int) -> fm.Dt3Featuremap:
        """One scene's feature map (a view of the batch's stack)."""
        return fm.Dt3Featuremap(
            dt3=self.dt3[i], angles=self.angles,
            scene_translation=self.scene_translations[i],
            feature_size=self.feature_sizes[i], params=self.params)


def build_featuremap_batch(scenes, params: fm.Dt3Params = fm.Dt3Params(),
                           pad_to: int = 128, mesh=None, *,
                           device=None) -> Dt3FeaturemapBatch:
    """Build the DT3 feature maps of a list of scenes on ``device`` (default
    the card).

    All scenes share a physical canvas (the max logical size rounded up to
    ``pad_to``); each scene's logical region is reference-exact and its
    padding is zero.  Reference ``dt3cpu.h:174-234``.

    ``mesh``: an optional :class:`~openfdcm_tpu_torch.parallel.Mesh` with a
    ``"scene"`` axis: the batch is padded to a multiple of the axis size
    with copies of the first scene, each block is built on its entry's
    device, and the blocks are gathered (the padding trimmed) onto
    ``device``, which the mesh decides when it is None.  Every scene's
    stack is the unsharded build's, bit for bit."""
    device = _call_device(mesh, device, "build_featuremap_batch")
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
    build = lambda rows, dev: _build_stack(lines[rows], mask[rows], lhw[rows],
                                           params, angles, phys, max_points, dev)
    n_dp = 1 if mesh is None else mesh.axis_size("scene")
    if n_dp > 1:
        rows = np.concatenate([np.arange(s_count),
                               np.zeros(-s_count % n_dp, np.int64)])
        blk = rows.size // n_dp
        dt3 = mesh.all_gather([build(rows[i * blk:(i + 1) * blk], dev)
                               for i, dev in enumerate(mesh.along("scene"))],
                              device)[:s_count]
    else:
        dt3 = build(slice(None), device)
    return Dt3FeaturemapBatch(
        dt3=dt3, angles=torch.as_tensor(angles, device=device),
        scene_translations=torch.as_tensor(trs, device=device),
        feature_sizes=tuple((w, h) for _, (w, h) in metas), params=params)


def _build_stack(lines, mask, lhw, params, angles, phys, max_points, device):
    """The ``(S, D, phys, phys)`` DT3 stack of host line tables on
    ``device``: seed scatter, column pass, K2, logical mask, K3, K4."""
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
    return integral.line_integral_stack_batch_(dt3, angles, lhw)


def _call_device(mesh, device, what: str) -> torch.device:
    """The device entry point ``what`` gathers its results on: ``device``
    (the card when None) without a mesh; with one, which must hold only
    this process's devices, the mesh's first entry when ``device`` is
    None, else ``device``, which must be in the mesh."""
    if mesh is None:
        return resolve_device("cuda" if device is None else device)
    mesh.require_local(what)
    return mesh.resolve(device)


def _budget(device: torch.device) -> int:
    """Bytes a search dispatch may plan for on ``device``: a quarter of
    the card's free memory, :data:`CPU_BUDGET` on the CPU.  Free counts
    the blocks PyTorch's caching allocator holds but no tensor uses: an
    earlier dispatch's cached memory is reused, so it must not shrink (and
    split) the next one."""
    if device.type == "cuda":
        cached = (torch.cuda.memory_reserved(device)
                  - torch.cuda.memory_allocated(device))
        return (torch.cuda.mem_get_info(device)[0] + cached) // 4
    return CPU_BUDGET


def _cand_bytes(lmax: int) -> int:
    """Device bytes one candidate takes in a dispatch: about 16 bytes per
    candidate line for each of ~8 live candidate tensors plus the 128-lane
    window."""
    return 8 * 16 * lmax + 4 * 1024


def _tile_bytes(stack_shape) -> int:
    """Bytes of one scene's part of the tiled stack copy, for a scene's
    ``(D, H, W)`` stack."""
    return 4 * int(np.prod(tile_shape((1, *stack_shape))))


def _scene_chunk(c_per_scene: int, lmax: int, tile_bytes: int,
                 device: torch.device) -> int:
    """Scenes per search dispatch, sized by device memory: each scene's
    candidates (:func:`_cand_bytes`) and its part of the tiled stack copy
    that the window kernels read (``tile_bytes``), against
    :func:`_budget`; at least one."""
    return max(1, _budget(device)
               // max(_cand_bytes(lmax) * c_per_scene + tile_bytes, 1))


def _cands_per_dispatch(s_chunk: int, lmax: int, tile_bytes: int,
                        device: torch.device) -> int:
    """Candidates per scene that a dispatch of ``s_chunk`` scenes can hold
    within :func:`_budget` beside their tiled stack copy; at least one."""
    room = _budget(device) // max(s_chunk, 1) - tile_bytes
    return max(1, room // _cand_bytes(lmax))


def _even_chunks(n: int, chunk: int, multiple: int = 1):
    """``[lo, hi)`` ranges covering ``n`` items in equal chunks of at most
    ``chunk``, their size rounded up to a multiple of ``multiple`` (a mesh's
    scene blocks; JAX ``pipeline._search_batch_arrays``)."""
    n_chunks = max(1, -(-n // max(chunk, 1)))
    size = -(-max(1, -(-n // n_chunks)) // multiple) * multiple
    return [(lo, min(lo + size, n)) for lo in range(0, n, size)]


def _chunk_rows(lo: int, hi: int, n_dp: int):
    """The rows of scene chunk ``[lo, hi)``, padded with repeats of ``lo`` to
    a multiple of ``n_dp`` (the padding's results are dropped): a slice
    when no padding is needed, else an index array."""
    pad = -(hi - lo) % n_dp
    if not pad:
        return slice(lo, hi)
    return np.concatenate([np.arange(lo, hi), np.full(pad, lo)])


def _rows(t, rows):
    """``t[rows]`` for a slice or an index array (a host array or a tensor on
    any device)."""
    if isinstance(rows, slice) or isinstance(t, np.ndarray):
        return t[rows]
    return t[torch.as_tensor(rows, device=t.device)]


def match_many(scenes, templates, params: fm.Dt3Params, searcher, optimizer,
               penalty=None, template_lengths=None, pad_to: int = 128,
               scene_chunk: int | None = None, top_k: int | None = None,
               mesh=None, *, device=None, timer=None) -> list:
    """End-to-end matching of a list of scenes on ``device`` (default the
    card).

    Scenes are grouped by canvas bucket; each group is built and searched,
    and results come back in input order, penalized when a ``penalty`` is
    given: with ``top_k``, per scene the ``top_k`` best matches sorted
    ascending; without, every valid match in reference emplace order
    (unsorted).  ``timer``: optional
    :class:`~openfdcm_tpu_torch.profiling.StageTimer`.

    ``mesh``: an optional :class:`~openfdcm_tpu_torch.parallel.Mesh`.  Its
    ``"scene"`` axis splits each scene chunk (``scene_chunk`` scenes per
    entry) into blocks built and searched on their entries; a ``"cand"``
    axis splits each scene's candidates, on the host ranking path (the
    device pairs serve a scene-only mesh, as in the JAX package).  Results
    are gathered onto ``device``, which the mesh decides when it is None,
    and equal the unsharded call's."""
    if mesh is not None:
        mesh.require_local("match_many")
    return match_many_async(scenes, templates, params, searcher, optimizer,
                            penalty=penalty, template_lengths=template_lengths,
                            pad_to=pad_to, scene_chunk=scene_chunk,
                            top_k=top_k, device=device, timer=timer,
                            mesh=mesh)()


def match_many_async(scenes, templates, params: fm.Dt3Params, searcher,
                     optimizer, penalty=None, template_lengths=None,
                     pad_to: int = 128, scene_chunk: int | None = None,
                     top_k: int | None = None, mesh=None, *, device=None,
                     timer=None):
    """:func:`match_many` split into dispatch + collection: runs every build
    and search, and returns a zero-argument ``collect()`` that fetches the
    results (on the top-k path one device-to-host copy per dispatch) and
    returns ``list[list[Match]]``."""
    device = _call_device(mesh, device, "match_many_async")
    opt.optimizer_mode(optimizer)      # an unknown optimizer raises here
    kernel_version()                   # a non-integer generation raises here
    bank = templates if isinstance(templates, TemplateBank) \
        else prepare_templates(templates, device=device)
    if bank.device != device:
        raise ValueError(f"template bank on {bank.device}, search on {device}")

    lengths = None
    if penalty is not None:
        lengths = np.asarray(template_lengths if template_lengths is not None
                             else geo.get_template_lengths(bank.host), np.float32)
        if lengths.shape[0] < len(bank.host):   # a device gather would assert
            raise IndexError("In penalize, the size of templatelengths is not "
                             "consistent with match template indices")
    # the device penalizes and ranks when the penalty has the reference's
    # power form (or is absent); any other penalty ranks on the host
    post = None
    if top_k is not None:
        if penalty is None:
            post = (torch.ones(max(len(bank.host), 1), device=device),
                    float("nan"), top_k)
        elif type(penalty) in (DefaultPenalty, ExponentialPenalty):
            tau = 1.0 if type(penalty) is DefaultPenalty else float(penalty.tau)
            post = (torch.as_tensor(lengths, device=device), tau, top_k)
    use_devpairs = (post is not None and len(bank.host) > 0
                    and type(searcher) in (DefaultSearch, ConcentricRangeStrategy)
                    and (mesh is None or set(mesh.axis_names) <= {"scene"}))
    n_dp = 1 if mesh is None else mesh.axis_size("scene")

    arrs = [geo.as_lines_np(s) for s in scenes]
    buckets = {}
    for i, a in enumerate(arrs):
        if a.shape[0] == 0:
            continue                       # zero-line scene: no matches
        _, (w, h) = fm.scene_centered_translation(a, params.padding)
        buckets.setdefault(-(-max(w, h) // pad_to) * pad_to, []).append(i)

    if scene_chunk is None and buckets:
        side = max(buckets)
        scene_chunk = _scene_chunk(_cands_per_scene(searcher, bank), bank.lmax,
                                   _tile_bytes((params.depth, side, side)),
                                   device)
    if scene_chunk is not None:
        scene_chunk *= n_dp            # scene_chunk scenes per scene block

    out = [[] for _ in scenes]
    deferred, host_results = [], []
    for key in sorted(buckets):
        idxs = buckets[key]
        with maybe_stage(timer, "build_featuremap", device):
            fms = build_featuremap_batch([scenes[i] for i in idxs], params,
                                         pad_to=pad_to, device=device,
                                         mesh=mesh)
        group = [arrs[i] for i in idxs]
        if use_devpairs:
            with maybe_stage(timer, "search_topk_devpairs", device):
                fin = _genpairs_batch_dispatch(searcher, optimizer, fms, bank,
                                               group, post, scene_chunk,
                                               mesh=mesh)
            deferred.append((idxs, fin))
        else:
            with maybe_stage(timer, "search_host_pairs", device):
                host_results.append((idxs, _search_batch_arrays(
                    searcher, optimizer, fms, bank, group,
                    scene_chunk=scene_chunk, post=post, mesh=mesh)))

    def collect() -> list:
        for idxs, fin in deferred:
            for i, rows in zip(idxs, fin()):
                out[i] = [Match(t, s, m.copy()) for (s, t, m) in rows[:top_k]]
        for idxs, res in host_results:
            for i, item in zip(idxs, res):
                out[i] = _host_matches(item, penalty, lengths, top_k)
        return out

    return collect


def _cands_per_scene(searcher, bank) -> int:
    """A scene's candidate count under ``searcher`` (an upper bound), for
    :func:`_scene_chunk`."""
    try:
        mt, ms = searcher.get_max_tmpl_lines(), searcher.get_max_scene_lines()
    except AttributeError:
        mt, ms = bank.lmax, 1
    return 2 * int(np.minimum(bank.counts_np, mt).sum()) * ms


def _host_matches(item, penalty, lengths, top_k) -> list:
    """One scene's matches from the host ranking path: its ``("topk",
    rows)`` from the device top-k, or its full ``(pairs, scores, mats,
    valid)``, penalized on the host and either kept whole in emplace order
    (no ``top_k``) or ranked by (score, candidate index)."""
    if isinstance(item[0], str):               # ("topk", rows)
        return [Match(t, s, m.copy()) for (s, _, t, m) in item[1][:top_k]]
    pairs, scores, mats, valid = item
    tmpl_idx = np.repeat(pairs[:, 0], 2)
    pscores = scores.astype(np.float32)
    if penalty is not None:
        pscores = np.asarray(penalty.apply(pscores, lengths[tmpl_idx]),
                             np.float32)
    if top_k is None:
        sel = np.nonzero(valid)[0]
    else:
        masked = np.where(valid, pscores, np.inf)
        sel = np.lexsort((np.arange(len(masked)), masked))[:top_k]
        sel = sel[np.isfinite(masked[sel])]
    return [Match(int(tmpl_idx[j]), float(pscores[j]), mats[j].copy())
            for j in sel]


def _genpairs_batch_dispatch(searcher, optimizer, featuremaps, bank, arrs,
                             post, scene_chunk: int, mesh=None):
    """Top-k search with on-device pair generation over scene chunks, and
    over template chunks where one scene chunk's candidates exceed the
    device budget.  With a ``mesh``, each scene chunk (a multiple of its
    ``"scene"`` axis, padded with repeats of its first scene) is searched in
    blocks, one on each entry along that axis
    (:func:`~.match._genpairs_topk_sharded`).

    Returns a ``collect()`` closure that copies the packed top-k rows to the
    host and returns, per scene, the ranked ``(penalized_score, tmpl_idx,
    mat (2, 3))`` rows of the valid, finite candidates, merged across
    template chunks by (score, chunk, rank) as the JAX package merges them,
    which equals the unchunked order."""
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
    annulus = ((*searcher.center_position, searcher.low_boundary,
                searcher.high_boundary)
               if isinstance(searcher, ConcentricRangeStrategy) else None)
    mode, window = opt.optimizer_mode(optimizer)

    nb = _bucket(max((a.shape[0] for a in arrs), default=1), 128)
    scene_arr = np.zeros((s_total, nb, 4), np.float32)
    slen_arr = np.zeros((s_total, nb), np.float32)
    svalid_arr = np.zeros((s_total, nb), bool)
    for i, a in enumerate(arrs):
        scene_arr[i, : a.shape[0]] = a
        slen_arr[i], svalid_arr[i] = scene_length_mask(a, nb, annulus)
    fs = np.asarray([[float(w), float(h)] for (w, h) in featuremaps.feature_sizes],
                    np.float32)
    dense_steps = opt.dense_step_count(optimizer, int(fs.max()))

    as_dev = lambda a: torch.as_tensor(a, device=device)
    tables = (as_dev(top_vals), as_dev(ord_t), as_dev(rank_ok))
    n_dp = 1 if mesh is None else mesh.axis_size("scene")
    chunks = _even_chunks(s_total, scene_chunk, n_dp)
    tile_bytes = _tile_bytes(featuremaps.dt3.shape[1:])
    # sized for one scene block: the blocks of a chunk run one after another
    t_chunk = max(1, _cands_per_dispatch(
        -(-max(hi - lo for lo, hi in chunks) // n_dp), lmax, tile_bytes,
        device) // (2 * mt * ms))
    # each template chunk's tables, sliced once (a mesh copies them once
    # per distinct device; one chunk keeps the bank's own tensors)
    t_ranges = _even_chunks(t_count, t_chunk)
    t_parts = [(t0, t1, [x if len(t_ranges) == 1 else x[t0:t1]
                         for x in (bank.lines, bank.mask, *tables, lengths_dev)])
               for t0, t1 in t_ranges]
    packed = []
    for lo, hi in chunks:
        rows = _chunk_rows(lo, hi, n_dp)
        parts = []
        for t0, t1, (t_lines, t_mask, *t_tables, t_lengths) in t_parts:
            kk = min(top_k, 2 * (t1 - t0) * mt * ms)
            args = (t_lines, t_mask, *t_tables,
                    *(as_dev(_rows(a, rows)) for a in (scene_arr, slen_arr,
                                                       svalid_arr)),
                    _rows(featuremaps.dt3, rows), featuremaps.angles,
                    _rows(featuremaps.scene_translations, rows),
                    as_dev(_rows(fs, rows)), t_lengths, tau)
            kw = dict(mode=mode, window=max(window, 1), dense_steps=dense_steps,
                      k=kk, ms=ms)
            sk, mk, tk, vk = (_genpairs_topk_sharded(mesh, *args, **kw)
                              if n_dp > 1 else
                              _search_device_batch_topk_genpairs(*args, **kw))
            # one (S, k, 9) tensor [score, tmpl, valid, mat(6)] per part: one copy
            parts.append((t0, torch.cat(
                [sk[..., None], tk.to(torch.float32)[..., None],
                 vk.to(torch.float32)[..., None],
                 mk.reshape(*mk.shape[:2], 6)], dim=-1)))
        packed.append((hi - lo, parts))

    def collect() -> list:
        out = []
        for n_scenes, parts in packed:
            merged = [[] for _ in range(n_scenes)]
            for ci, (t0, p) in enumerate(parts):
                for row, rows in zip(p.cpu().numpy(), merged):
                    rows.extend((float(r[0]), ci, j, int(r[1]) + t0,
                                 r[3:9].reshape(2, 3))
                                for j, r in enumerate(row)
                                if r[2] > 0.5 and np.isfinite(r[0]))
            for rows in merged:
                rows.sort(key=lambda r: r[:3])
                out.append([(sc, t, m) for (sc, _, _, t, m) in rows])
        return out
    return collect


def search_batch(matcher, searcher, optimizer, featuremaps: Dt3FeaturemapBatch,
                 templates, scenes, scene_chunk: int | None = None,
                 mesh=None) -> list:
    """Per-scene :func:`~.match.search` over a scene batch, on the feature
    maps' device: ``list[list[Match]]``, per scene unsorted in reference
    emplace order (``defaultmatch.cpp:62-70``).  ``templates``: host line
    arrays, or a :class:`TemplateBank` on that device; ``scene_chunk``:
    scenes per dispatch (None: sized by device memory); ``mesh``: as in
    :func:`match_many`, with the same result."""
    del matcher
    dev = featuremaps.dt3.device
    if mesh is not None:
        mesh.require_local("search_batch")
        mesh.resolve(dev)           # the feature maps' device is in the mesh
    bank = templates if isinstance(templates, TemplateBank) \
        else prepare_templates(templates, device=dev)
    if bank.device != dev:
        raise ValueError(f"template bank on {bank.device}, feature maps on {dev}")
    out = []
    for pairs, scores, mats, valid in _search_batch_arrays(
            searcher, optimizer, featuremaps, bank,
            [geo.as_lines_np(s) for s in scenes], scene_chunk=scene_chunk,
            mesh=mesh):
        out.append([Match(int(pairs[j // 2, 0]), float(scores[j]),
                          mats[j].copy())
                    for j in range(2 * pairs.shape[0]) if valid[j]])
    return out


def _search_batch_arrays(searcher, optimizer, featuremaps, bank, arrs,
                         scene_chunk: int | None = None, post=None,
                         mesh=None) -> list:
    """Array-level batched search on host pair tables: per scene ``(pairs
    (P, 3), scores (2P,), mats (2P, 2, 3), valid (2P,))`` in reference
    emplace order (pair-major, polarity-minor), or with ``post = (lengths,
    tau, k)`` its device top-k ``("topk", [(score, cand_idx, tmpl_idx,
    mat), ...])``.  ``arrs``: the scenes' ``(N, 4)`` line arrays.  With a
    ``mesh``, chunks are a multiple of its ``"scene"`` axis (padded with
    repeats of their first scene) and each is searched on the mesh
    (:func:`_search_chunk_dispatch`)."""
    s_total = len(featuremaps)
    device = featuremaps.dt3.device
    n_dp = 1 if mesh is None else mesh.axis_size("scene")
    tile_bytes = _tile_bytes(featuremaps.dt3.shape[1:])
    if scene_chunk is None:
        scene_chunk = n_dp * _scene_chunk(_cands_per_scene(searcher, bank),
                                          bank.lmax, tile_bytes, device)
    out = []
    for lo, hi in _even_chunks(s_total, scene_chunk, n_dp):
        rows = _chunk_rows(lo, hi, n_dp)
        idx = range(lo, hi) if isinstance(rows, slice) else rows
        sub = Dt3FeaturemapBatch(
            dt3=_rows(featuremaps.dt3, rows), angles=featuremaps.angles,
            scene_translations=_rows(featuremaps.scene_translations, rows),
            feature_sizes=tuple(featuremaps.feature_sizes[i] for i in idx),
            params=featuremaps.params)
        out.extend(_search_chunk_convert(*_search_chunk_dispatch(
            searcher, optimizer, sub, bank, [arrs[i] for i in idx], post,
            tile_bytes, mesh))[:hi - lo])
    return out


def _search_chunk_dispatch(searcher, optimizer, featuremaps, bank, arrs,
                           post, tile_bytes, mesh=None):
    """The device work of one scene chunk on host pair tables: pairs from
    :func:`_bank_pairs_for_scene`, padded per scene to a common bucket
    (the padding masked through ``cand_ok``) and split along the pair axis
    where the chunk's candidates exceed the device budget.  With a
    ``mesh``, the scenes split along its ``"scene"`` axis and each scene's
    pairs (their bucket a multiple of ``lcm(64, n_cand)``) along its
    ``"cand"`` axis (:func:`~.match._search_device_batch_topk_sharded`,
    :func:`~.match._search_device_batch_sharded`).  Returns
    ``(per_scene_pairs, parts, with_topk)``."""
    s_count = len(featuremaps)
    device = featuremaps.dt3.device
    per_scene_pairs = [_bank_pairs_for_scene(searcher, bank, a) for a in arrs]
    pmax = max((p.shape[0] for p in per_scene_pairs), default=0)
    if pmax == 0:
        return per_scene_pairs, [], post is not None
    nb = _bucket(max(a.shape[0] for a in arrs), 128)
    scene_arr = np.zeros((s_count, nb, 4), np.float32)
    for i, a in enumerate(arrs):
        scene_arr[i, : a.shape[0]] = a
    mode, window = opt.optimizer_mode(optimizer)
    fs = np.asarray([[float(w), float(h)] for (w, h) in featuremaps.feature_sizes],
                    np.float32)
    dense_steps = opt.dense_step_count(optimizer, int(fs.max()))
    as_dev = lambda a: torch.as_tensor(a, device=device)
    common = (as_dev(scene_arr), featuremaps.dt3, featuremaps.angles,
              featuremaps.scene_translations, as_dev(fs))
    kw = dict(mode=mode, window=max(window, 1), dense_steps=dense_steps)
    n_dp = 1 if mesh is None else mesh.axis_size("scene")
    quantum = 64 if mesh is None else int(np.lcm(64, mesh.axis_size("cand")))
    p_chunk = max(64, _cands_per_dispatch(s_count // n_dp, bank.lmax,
                                          tile_bytes, device) // 2 // 64 * 64)
    parts = []
    for lo in range(0, pmax, p_chunk):
        sel = [np.arange(lo, min(lo + p_chunk, p.shape[0])) for p in per_scene_pairs]
        pb = _bucket(max(len(x) for x in sel), quantum)
        pair_arr = np.zeros((s_count, pb, 3), np.int64)
        pv = np.zeros((s_count, pb), bool)
        for i, (p, x) in enumerate(zip(per_scene_pairs, sel)):
            pair_arr[i, : len(x)] = p[x]
            pv[i, : len(x)] = True
        pairs_dev = [as_dev(np.ascontiguousarray(pair_arr[..., j])) for j in range(3)]
        if post is not None:
            lengths_dev, tau, k = post
            args = (bank.lines, bank.mask, *pairs_dev, *common, lengths_dev,
                    tau, as_dev(pv))
            parts.append((sel, _search_device_batch_topk(
                *args, k=min(k, 2 * pb), **kw) if mesh is None else
                _search_device_batch_topk_sharded(mesh, *args,
                                                  k=min(k, 2 * pb), **kw)))
        else:
            args = (bank.lines, bank.mask, *pairs_dev, *common)
            ok = as_dev(pv).repeat_interleave(2, dim=1)
            parts.append((sel, _search_device_batch(*args, cand_ok=ok, **kw)
                          if mesh is None else
                          _search_device_batch_sharded(mesh, *args, cand_ok=ok,
                                                       **kw)))
    return per_scene_pairs, parts, post is not None


def _convert_topk(per_scene_pairs, parts):
    """Merge per-part device top-k results into per-scene ranked lists
    ``("topk", [(score, global_cand_idx, tmpl_idx, mat), ...])``, ordered
    by (score, candidate index in emplace order)."""
    parts = [(sel, tuple(x.cpu().numpy() for x in dev)) for sel, dev in parts]
    out = []
    for i, pairs in enumerate(per_scene_pairs):
        rows = []
        for sel, (sk, mk, ik, vk) in parts:
            s = sel[i]
            for j in range(sk.shape[1]):
                if not vk[i, j] or not np.isfinite(sk[i, j]):
                    continue
                local = int(ik[i, j])
                pair_pos = local // 2
                if pair_pos >= len(s):
                    continue            # padded pair slot
                gidx = 2 * int(s[pair_pos]) + local % 2
                rows.append((float(sk[i, j]), gidx,
                             int(pairs[s[pair_pos], 0]), mk[i, j]))
        rows.sort(key=lambda r: (r[0], r[1]))
        out.append(("topk", rows))
    return out


def _search_chunk_convert(per_scene_pairs, parts, with_topk):
    """Host arrays of one scene chunk from :func:`_search_chunk_dispatch`:
    the parts scattered back into each scene's emplace order (one copy per
    device tensor), or :func:`_convert_topk`."""
    if with_topk:
        return _convert_topk(per_scene_pairs, parts)
    parts = [(sel, *(x.cpu().numpy() for x in dev)) for sel, dev in parts]
    out = []
    for i, pairs in enumerate(per_scene_pairs):
        n = 2 * pairs.shape[0]
        scores = np.zeros((n,), np.float32)
        mats = np.zeros((n, 2, 3), np.float32)
        valid = np.zeros((n,), bool)
        for sel, s_np, m_np, v_np in parts:
            s = sel[i]
            # pair j maps to candidates 2j and 2j+1 (polarity-minor order)
            cidx = np.stack([2 * s, 2 * s + 1], axis=1).reshape(-1)
            k = 2 * len(s)
            scores[cidx] = s_np[i, :k]
            mats[cidx] = m_np[i, :k]
            valid[cidx] = v_np[i, :k]
        out.append((pairs, scores, mats, valid))
    return out
