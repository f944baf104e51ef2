"""Drive the PyTorch port's main path once on an NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Needs one CUDA device, ``nvcc`` and ``nvidia-smi``; exits non-zero, without
the final ``{"ok": true, ...}`` line, on any failure (including no GPU, or
a directory without the ``openfdcm_tpu_torch`` package).  Phases:

1. device: the card's name and power limit, torch, CUDA and nvcc versions;
2. build: compiles the kernels (``openfdcm_tpu_torch/csrc``: K1-K6 and K1's
   tile copy) for sm_90a, one nvcc per source, all started together;
3. kernel vs plain: each kernel on the inputs it gets from a real build or
   dispatch of the workload below, against its plain PyTorch version on the
   same inputs — bit-equal; the build kernels K2, K3 and K4 on a 10-scene
   build (the main path's batch; their plain versions are exact integer or
   add sequences and run on the card), the window kernels on CPU copies of
   the two-sided main pass, the one-sided extension pass and the one-sided
   pattern on the whole main-pass set from seeded resume steps (K1 from a
   BatchOptimize dispatch, K5 and K6 from DefaultOptimize dispatches under
   window generations 2 and 3, each reading its dispatch's tiled stack
   copy, whose kernel runs against its plain version on the card); each
   kernel's time beside its bound (bytes over 3.35 TB/s or operations over
   67 TFLOP/s, whichever is larger); the main pass of K1, K5 and K6 split
   into its x-major and y-major candidates, each on the tiled copy and on
   the row-major stack; plus CUDA ``/`` and sqrt against numpy on 1M random
   f32 pairs, and the penalty's ``pow_f32`` against numpy's f64 power on
   1M lengths;
4. small reference: the slice on CUDA against the slice on the CPU on a
   small input, BatchOptimize, DefaultOptimize under each generation,
   DenseOptimize, and the host ranking path — scores equal;
5. slice: ``match_many(..., top_k=10, device="cuda")`` on a seeded synthetic
   workload with the pose workload's sizes — 4 banks of 105 templates
   (23-33 lines, 10-150 px), 10 scenes per bank (one planted template under
   a rigid transform plus 120 clutter lines on a 640² canvas),
   ``Dt3Params(30, 5.0, 1.0, L2)``, ``DefaultSearch(4, 10)``,
   ``BatchOptimize(10)``, ``ExponentialPenalty(1.5)``, window generation 4
   — with every kernel's launch count, finite and repeatable top-10s, stage
   times, scenes/s and each kernel's time beside its plain version's;
6. generations: the same workload with ``DefaultOptimize()`` under window
   generations 2, 3 and 4 (two runs each), then ``IndulgentOptimize()`` and
   ``BatchOptimize(10)`` on bank 0 under each generation — launch counts,
   host syncs, stage times, planted hits, and per mode the top-10s of the
   three generations against each other;
7. dense: ``DenseOptimize()`` over the whole workload at generation 4,
   twice — K1 launches per run and no K5/K6, finite and repeatable
   top-10s, per scene the dense top-1 at most the slice's BatchOptimize
   top-1 (exact: the same K1 probes, a superset of the steps), wall time
   and scenes/s;
8. concentric: ``ConcentricRangeStrategy(4, 10, c, 0, r)`` around the
   scenes' common center, ``r`` keeping about half of the lines (the share
   printed), over the whole workload; an annulus covering every line gives
   the slice's top-10s exactly;
9. host ranking: bank 0 without ``top_k`` (every valid match, penalized on
   the host): its sorted head equals the slice's top-10 rows exactly; a
   DefaultSearch subclass with a user penalty computing the same function
   gives the same lists; generations 2 and 3 with their K5/K6 launches;
10. single scene: bank 0's scenes through ``build_featuremap`` -> ``search``
   -> ``penalize`` -> ``sort_matches`` (K2/K3/K4 launches counted), whose
   top-10s equal the slice's; ``build_featuremap(pad_to=None)`` on the card
   bit-equal to the CPU build, its K2/K3/K4 calls bit-equal to their plain
   versions, its ``search`` at generations 2, 3 and 4; ``evaluate`` on the
   card equal to the CPU; a save/load round trip bit-equal;
11. template chunks: bank 0 under a forced small device budget (several
   template chunks per dispatch) equals the slice's top-10s;
12. profile: one more slice run (phase 5's) under ``torch.profiler`` —
   device time by kernel, the device's busy share of the run, and K3's
   time per launch beside its CUDA-event time from phase 3; then one
   DefaultOptimize run each under generations 2 and 3, for K5's and K6's
   device time per run beside K1's and the tile copy's; then one dense run
   and bank 0 through the single-scene path, each with its device busy
   share and its kernels' launches and device time;
13. files: the whole bank (the 420 templates of the four banks) as
   ``.tmpl`` files and the 40 scenes as ``.scene`` files (``io.write``,
   zero-padded names), read back bit-equal one by one and with
   ``read_batch``;
14. whole bank: ``match_many`` of the 40 scenes against the 420 templates,
   twice — repeatable rows, launches, scenes/s and templates x scenes per
   second; the reference of phases 15-17;
15. serving: a ``MatcherService`` on the whole bank (``max_batch=16``),
   warmed up on 2 scenes, the 40 scenes from 4 client threads at once —
   every answer equal to its phase-14 row; requests/s, latency, dispatches,
   launches; ``submit`` after ``close()`` raises;
16. sweep: ``resumable_sweep`` over the ``.tmpl`` paths in chunks of 105,
   killed on its third chunk (the checkpoint holds 2), resumed with the
   default matcher (chunks 0-1 do not run again) — equal to phase 14;
17. CLI: ``python3 -m openfdcm_tpu_torch match`` (scene 0, its defaults)
   equal to phase 14's row at the CLI's rounding, ``sweep --chunk-size
   105`` with each scene's best template and score, ``info``;
18. pose: a bank-0 template on the plane z = 0 in 4 calibrated views with
   clutter, matched on the card, ``multiview_detections`` on the card: a
   4-vote detection at the true point, ``six_dof_pose``'s in-plane angle,
   ``plane_pose``; ``multiview_vote`` on the card against the CPU;
19. compat: the reference's integration test through
   ``openfdcm_tpu_torch.compat`` on the card (L2, L1, L2²), its sorted
   matches equal to the CPU's;
20. profile: one more phase-15 serving run under ``torch.profiler`` —
   device busy share, launches, device time by kernel;
21-27. the sharded paths (``openfdcm_tpu_torch.parallel``), each on a mesh
   whose entry ``i`` is visible card ``i`` modulo their count (on one card
   every entry names it and the shards run in turn: the sharding is
   checked, its scaling is not measured), each printing its wall beside
   the unsharded call's and its launches: 21 ``("scene", 4)``:
   bank 0's build bit-equal, ``match_many`` over the 4 banks equal to phase
   5's rows, DefaultOptimize under generations 2 and 3 (K5, K6) equal to
   unsharded; 22 ``("cand", 4)``: one scene's ``search`` equal to
   unsharded; 23 ``("scene", 2) x ("cand", 2)``:
   ``optimize_candidates_sharded_batch`` on two scenes' candidates and
   ``topk_candidates`` equal to the unsharded kernel call; 24 ``("scene",
   2) x ("bank", 2)``: ``match_many_bank_sharded`` on the whole bank equal
   to phase 14's rows by (score, template); 25 ``("rows", 4)``: one scene's
   ``build_featuremap_spatial`` bit-equal, ``search_spatial`` equal to
   ``search``; 26 ``MatcherService(mesh=)`` and a killed and resumed
   ``resumable_sweep(mesh=)`` equal to phase 14's rows; 27 ``global_topk``
   equal to ``topk_candidates``;
28. native: the 460 line files of phase 13 through the native runtime's
   ``read_batch`` (8 threads) equal to the plain reader file by file, a
   native write -> read round trip exact, DefaultSearch pairs of every
   template of the whole bank against every scene equal to the plain ones,
   native and plain walls;
29. core API: ``distance_transform`` (L1, L2, L2²) of bank 0's scene 0 on
   640 x 640 and of a seeded 1920 x 1080 scene of 400 lines, bit-equal to
   the CPU with one K2 launch per L2/L2² call; ``line_integral`` of the 30
   DT3 angles over the 640² DT and of 4 edge angles over the 1920 x 1080
   one, each bit-equal to the CPU with one K4 launch and its input
   unchanged; ``closest_orientation_idx`` on 1M thetas (NaN among them)
   identical to the CPU; ``propagate_orientation(dt3, wmat)`` on scene 0's
   30 x 640² per-orientation DTs bit-equal to the CPU, its largest
   difference from K3's relaxation printed; walls per call;
30. optimize API: ``optimize_candidates`` on bank-0 scene 0's 8,448
   candidates under Default, Indulgent, Batch(10) and DenseOptimize at
   generation 4 and DefaultOptimize under generations 2 and 3, each run's
   valid rows equal to ``search``'s for the scene bit for bit, with K1, K5
   or K6 launched under its generation; walls;
31. (run after 27) a mesh over two processes on one card: phase 23's
   two-scene optimize on a ``("scene", 2) x ("cand", 2)`` mesh whose row
   ``r`` belongs to rank ``r`` of two spawned gloo ranks (each imports
   only torch and the port, two ``cuda:0`` entries each), under
   generations 4, 2 and 3: each rank's shards bit-equal to the unsharded
   kernel call's rows, K1 and the tile copy (K5, K6) launched in each
   rank's process, ``global_topk`` on a ``("cand", 4)`` mesh over the
   ranks equal to phase 27's on every rank; each rank's wall beside the
   single-process meshed wall.

Phase 3 also holds one dense 64-lane K1 call against the plain version,
and phase 4 adds DenseOptimize and the host ranking path; every CUDA
score there equals the CPU's.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import openfdcm_tpu_torch as of  # noqa: E402
from openfdcm_tpu_torch.core import dt as dt_mod  # noqa: E402
from openfdcm_tpu_torch.core import integral as integral_mod  # noqa: E402
from openfdcm_tpu_torch.core.geometry import pow_f32, sqrt_f32  # noqa: E402
from openfdcm_tpu_torch.matching import featuremap as fm_mod  # noqa: E402
from openfdcm_tpu_torch.matching import optimize as opt_mod  # noqa: E402
from openfdcm_tpu_torch.matching import pipeline as pipeline_mod  # noqa: E402
from openfdcm_tpu_torch.matching.optimize_kernel import window_generation  # noqa: E402
from openfdcm_tpu_torch.ops import build  # noqa: E402
from openfdcm_tpu_torch.ops import integral as ops_integral  # noqa: E402
from openfdcm_tpu_torch.ops import minplus as ops_minplus  # noqa: E402
from openfdcm_tpu_torch.ops import prop as ops_prop  # noqa: E402
from openfdcm_tpu_torch.ops import window as ops_window  # noqa: E402
from openfdcm_tpu_torch.ops import window_v2 as ops_window_v2  # noqa: E402
from openfdcm_tpu_torch.ops import window_v3 as ops_window_v3  # noqa: E402

N_BANKS, N_TEMPLATES, N_SCENES, N_CLUTTER, CANVAS = 4, 105, 10, 120, 620
TOP_K = 10

# name -> (wrapper, plain version, CUDA source, TPU kernel it replaces)
KERNELS = {
    "K1_window_scores": (ops_window.window_scores, ops_window.window_scores_plain,
                         "openfdcm_tpu_torch/csrc/window.cu",
                         "openfdcm_tpu/ops/window_kernel.py:1080"),
    "K1_tile_stack": (ops_window.tile_stack, ops_window.tile_stack_plain,
                      "openfdcm_tpu_torch/csrc/window.cu",
                      "openfdcm_tpu/ops/window_kernel.py:1080"),
    "K2_minplus_rows": (ops_minplus.minplus_rows, ops_minplus.minplus_rows_plain,
                        "openfdcm_tpu_torch/csrc/minplus.cu",
                        "openfdcm_tpu/ops/minplus_kernel.py:121"),
    "K3_propagate_orientation": (ops_prop.propagate_orientation,
                                 ops_prop.propagate_orientation_plain,
                                 "openfdcm_tpu_torch/csrc/prop.cu",
                                 "openfdcm_tpu/ops/prop_kernel.py:47"),
    "K4_sweep_stack": (ops_integral.sweep_stack, ops_integral.sweep_stack_plain,
                       "openfdcm_tpu_torch/csrc/integral.cu",
                       "openfdcm_tpu/ops/integral_kernel.py:81"),
    "K5_window_v2": (ops_window_v2.window_v2, ops_window_v2.window_v2_plain,
                     "openfdcm_tpu_torch/csrc/window_v2.cu",
                     "openfdcm_tpu/ops/window_kernel.py:210"),
    "K6_window_v3": (ops_window_v3.window_v3, ops_window_v3.window_v3_plain,
                     "openfdcm_tpu_torch/csrc/window_v3.cu",
                     "openfdcm_tpu/ops/window_kernel.py:438"),
}
BUILD_KERNELS = ("K2_minplus_rows", "K3_propagate_orientation", "K4_sweep_stack")
# kernels whose plain version is exact and runs on the card
PLAIN_ON_CARD = BUILD_KERNELS + ("K1_tile_stack",)
# the card's published peaks (H100 SXM data sheet, 700 W): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
# the window kernel of each generation's main and extension pass
WINDOW_KERNEL = {2: "K5_window_v2", 3: "K6_window_v3", 4: "K1_window_scores"}
# the kernels each generation's search must launch
SEARCH_KERNELS = {2: ("K5_window_v2", "K1_tile_stack"),
                  3: ("K6_window_v3", "K1_tile_stack"),
                  4: ("K1_window_scores", "K1_tile_stack")}
# the kernels' names in a profile (K1's "window_kernel" is no substring of
# K5's or K6's name)
PROFILE_NAMES = ("edt_rows_kernel", "prop_fixed", "prop_any",
                 "sweep_paths_kernel", "window_kernel", "tile_kernel",
                 "window_v2_kernel", "window_v3_kernel")
# generation -> (module, main-pass entry, extension-pass entry, kernel wrapper)
GEN_ENTRIES = {2: (ops_window_v2, "window_scores_v2", "window_scores_v2_ext",
                   "window_v2"),
               3: (ops_window_v3, "window_scores_v3", "window_scores_v3_ext",
                   "window_v3")}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# workload
# ---------------------------------------------------------------------------

def _random_lines(rng, n, center_box, lmin=10.0, lmax=150.0):
    c = rng.uniform(center_box[0], center_box[1], (n, 2))
    ang = rng.uniform(0, np.pi, n)
    half = rng.uniform(lmin, lmax, n)[:, None] / 2
    d = np.stack([np.cos(ang), np.sin(ang)], -1) * half
    return np.concatenate([c - d, c + d], -1).astype(np.float32)


def make_workload(seed, n_banks=N_BANKS, n_templates=N_TEMPLATES,
                  n_scenes=N_SCENES, n_clutter=N_CLUTTER, canvas=CANVAS):
    """Seeded synthetic pose-shaped workload: per bank ``(templates, scenes,
    planted template index per scene)``."""
    rng = np.random.default_rng(seed)
    banks = []
    for _ in range(n_banks):
        templates = [_random_lines(rng, int(rng.integers(23, 34)), (-100, 100))
                     for _ in range(n_templates)]
        scenes, planted = [], []
        for _ in range(n_scenes):
            j = int(rng.integers(n_templates))
            th = rng.uniform(-np.pi, np.pi)
            rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
            # template points lie within 100*sqrt(2) + 75 < 216 of its origin
            shift = rng.uniform(216, canvas - 216, 2)
            t = templates[j].reshape(-1, 2) @ rot.T + shift
            clutter = _random_lines(rng, n_clutter, (75, canvas - 75))
            lines = np.concatenate([t.reshape(-1, 4).astype(np.float32), clutter])
            scenes.append(lines[rng.permutation(len(lines))])
            planted.append(j)
        banks.append((templates, scenes, planted))
    return banks


# ---------------------------------------------------------------------------
# kernel inputs from a real run
# ---------------------------------------------------------------------------

class Recorder:
    """Wraps module attributes so each call's arguments are recorded (tensors
    as copies taken before the call: K4 overwrites its input)."""

    def __init__(self, targets):
        self.targets = targets          # {name: (module, attribute)}
        self.calls = {name: [] for name in targets}

    def __enter__(self):
        self.saved = {}
        for name, (mod, attr) in self.targets.items():
            fn = getattr(mod, attr)
            self.saved[name] = fn

            # wraps() copies the launch counter attribute, which the wrapper
            # body increments through its module-global name
            @functools.wraps(fn)
            def wrapped(*args, _fn=fn, _name=name, **kw):
                self.calls[_name].append((fresh(args), kw))
                return _fn(*args, **kw)
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for name, (mod, attr) in self.targets.items():
            setattr(mod, attr, self.saved[name])


@contextlib.contextmanager
def generation(version):
    """Run under ``OPENFDCM_TPU_KERNEL_VERSION=version``."""
    saved = os.environ.get("OPENFDCM_TPU_KERNEL_VERSION")
    os.environ["OPENFDCM_TPU_KERNEL_VERSION"] = str(version)
    try:
        yield
    finally:
        if saved is None:
            del os.environ["OPENFDCM_TPU_KERNEL_VERSION"]
        else:
            os.environ["OPENFDCM_TPU_KERNEL_VERSION"] = saved


def mismatches(a, b):
    """Elements that differ, NaN equal to NaN."""
    a, b = a.cpu(), b.cpu()
    both_nan = a.isnan() & b.isnan()
    return int(((a != b) & ~both_nan).sum())


def max_abs_err(a, b):
    a, b = a.cpu().double(), b.cpu().double()
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def to_cpu(args):
    return tuple(a.cpu() if torch.is_tensor(a) else a for a in args)


def plain_kw(kw):
    """A kernel call's keywords for its plain version (which reads the
    row-major stack, not K1's tiled copy)."""
    return {k: v for k, v in kw.items() if k != "tiles"}


def fresh(args):
    return tuple(a.clone() if torch.is_tensor(a) else a for a in args)


def nbytes(*xs):
    return sum(x.numel() * x.element_size() if torch.is_tensor(x) else x.nbytes
               for x in xs if torch.is_tensor(x) or isinstance(x, np.ndarray))


# position of the line weights among each window kernel's arguments
WINDOW_WEIGHTS = {"K1_window_scores": 3, "K5_window_v2": 4, "K6_window_v3": 3}


def probed_cells(plain, args, kw):
    """Cells of a window kernel's stack ``args[0]`` that its output depends
    on: the nonzero entries of the stack's gradient through the plain
    version, taken on random stack values with a random output gradient so
    that no two probes cancel (where a call probes does not depend on the
    stack's values; a weight-0 line contributes no gradient)."""
    li = args[0]
    gen = torch.Generator(device=li.device).manual_seed(0)
    x = torch.rand(li.shape, generator=gen, device=li.device).requires_grad_()
    out = plain(x, *args[1:], **plain_kw(kw))
    out.backward(torch.rand(out.shape, generator=gen, device=out.device) + 0.5)
    return int((x.grad != 0).sum())


def work(name, args, kw):
    """``(bytes, operations)`` one call needs: each input read once and each
    output written once — of a window kernel's stack, only the cells its
    output depends on; operations as the kernel counts them on these
    inputs — a window probe pair about 12 (two coordinates and a flat index
    each, difference, abs, weighted add) per lane and line of nonzero
    weight, K2 about 24 integer and float ops per pixel (envelope push, pops,
    pointer walk, the value, the root), K3 an add and a min per step and
    pixel, K4 one add per cell, K1's tile copy none."""
    if name in WINDOW_WEIGHTS:
        wt = args[WINDOW_WEIGHTS[name]]
        lanes = kw.get("count", 128 if kw["two_sided"] else 64)
        cells = probed_cells(KERNELS[name][1], args, kw)
        return (cells * args[0].element_size() + nbytes(*args[1:])
                + wt.shape[0] * lanes * 4, 12 * lanes * int((wt != 0).sum()))
    x = args[0]
    if name == "K1_tile_stack":
        return nbytes(x) + 4 * int(np.prod(ops_window.tile_shape(x.shape))), 0
    if name == "K2_minplus_rows":
        return 2 * nbytes(x), 24 * x.numel()
    if name == "K3_propagate_orientation":
        return 2 * nbytes(x), 2 * len(args[1]) * x.numel() // x.shape[-3]
    return 2 * nbytes(x) + nbytes(*args[1:]), x.numel()


def bound(name, calls):
    """The least time the card could take for ``calls``, ms, what binds it
    (bytes over the HBM rate or operations over the f32 peak), and the
    bytes and operations of each call."""
    each = [work(name, args, kw) for args, kw in calls]
    b, o = sum(w[0] for w in each), sum(w[1] for w in each)
    t_bytes, t_ops = b / HBM_BYTES_PER_S * 1e3, o / F32_OPS_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")) + (each,)


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] nvidia-smi: {card}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices {torch.cuda.device_count()} "
          f"name {torch.cuda.get_device_name(0)}")
    nvcc = build.find_nvcc()
    check(nvcc is not None, "nvcc not found")
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    print(f"[device] nvcc: {ver[-1] if ver else '?'}")
    return card


def phase_build():
    t0 = time.perf_counter()
    path = build.build()
    build.library()
    dt = time.perf_counter() - t0
    print(f"[build] {path.name} in {dt:.2f} s")
    log = path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] {line.strip()}")
    return dt


def record_generation(version, bank, scenes, params, searcher, penalty,
                      device, lengths):
    """K5 or K6 calls of a three-scene DefaultOptimize dispatch under
    ``version``: the first main pass, the first extension pass, and the
    extension entry on the whole main-pass set from seeded resume steps."""
    mod, main_name, ext_name, kernel_name = GEN_ENTRIES[version]
    name = WINDOW_KERNEL[version]
    with generation(version), Recorder({name: (mod, kernel_name),
                                        "main": (mod, main_name)}) as rec:
        of.match_many(scenes[:3], bank, params, searcher, of.DefaultOptimize(),
                      penalty=penalty, template_lengths=lengths, top_k=TOP_K,
                      device=device, scene_chunk=3)
        check(rec.calls["main"], f"no generation-{version} main pass was recorded")
        (li, scene_tr, cand_lines, cand_mask, rast, valid, slice_idx), main_kw = \
            rec.calls["main"][0]
        check(main_kw.get("tiles") is not None,
              f"the generation-{version} main pass read no tiled copy")
        n_ext = len([c for c in rec.calls[name] if not c[1]["two_sided"]])
        s, c, l = cand_mask.shape

        gen = torch.Generator(device="cpu").manual_seed(version)
        t0r = torch.randint(1, 60, (s * c,), generator=gen).float().to(device)
        getattr(mod, ext_name)(
            li, cand_lines.reshape(s * c, l, 4), cand_mask.reshape(s * c, l),
            (-rast.reshape(s * c, 2)).contiguous(), valid.reshape(s * c),
            slice_idx.reshape(s * c, l),
            torch.arange(s, device=device).repeat_interleave(c), scene_tr, t0r,
            tiles=main_kw["tiles"])
    _, tc = getattr(mod, main_name)(*rec.calls["main"][0][0], **main_kw)
    print(f"[kernel] generation {version}, 3-scene dispatch: "
          f"{int(((tc == 0) & valid).sum())} of {int(valid.sum())} valid "
          f"candidates with tc = 0 (quarantined), tc median "
          f"{float(tc[valid].float().median())}")
    calls = rec.calls[name]
    main_pass = [c for c in calls if c[1]["two_sided"]][:1]
    ext_pass = [c for c in calls[:-1] if not c[1]["two_sided"]][:1]
    check(main_pass and ext_pass and n_ext,
          f"{name}: main pass {len(main_pass)}, extension passes {n_ext} recorded")
    return main_pass + ext_pass + calls[-1:]


def build_memory(scenes, params, device):
    """Device memory of one build of ``scenes``: the peak above what was
    allocated before it, the peak so far when K2 and when K3 start, its
    output, and K2's scratch."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    at = {}

    def peak_at(name, fn):
        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            at[name] = (torch.cuda.max_memory_allocated() - base) / 1e6
            return fn(*args, **kw)
        return wrapped
    saved = dt_mod.minplus_rows, fm_mod.k3_relax
    dt_mod.minplus_rows = peak_at("K2", saved[0])
    fm_mod.k3_relax = peak_at("K3", saved[1])
    try:
        fmb = of.build_featuremap_batch(scenes, params, device=device)
    finally:
        dt_mod.minplus_rows, fm_mod.k3_relax = saved
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    n, w = fmb.dt3.numel() // fmb.dt3.shape[-1], fmb.dt3.shape[-1]
    scratch = ops_minplus.scratch_blocks(n, fmb.dt3.device) * 32 * w * 4
    print(f"[memory] {len(scenes)}-scene build: peak {peak / 1e6:.1f} MB above "
          f"the {base / 1e6:.1f} MB allocated before it, its output "
          f"{held / 1e6:.1f} MB ({tuple(fmb.dt3.shape)} stack "
          f"{nbytes(fmb.dt3) / 1e6:.1f} MB), K2 scratch {scratch / 1e6:.1f} MB; "
          f"peak so far when K2 starts {at['K2']:.1f} MB, when K3 starts "
          f"{at['K3']:.1f} MB")


def phase_kernels(banks, params, searcher, optimizer, penalty, device):
    """Record every kernel's inputs from bank 0's 10-scene build (the main
    path's batch) and three-scene searches of bank 0 (generation 4 with
    ``optimizer``, generations 2 and 3 with DefaultOptimize), compare each
    kernel with its plain version (build kernels on the card, window
    kernels on CPU copies), and time both on the card."""
    templates, scenes, _ = banks[0]
    with Recorder({"K2_minplus_rows": (dt_mod, "minplus_rows"),
                   "K3_propagate_orientation": (fm_mod, "k3_relax"),
                   "K4_sweep_stack": (integral_mod, "sweep_stack")}) as build_rec:
        of.build_featuremap_batch(scenes, params, device=device)
    build_memory(scenes, params, device)
    with generation(4), Recorder({
            "K1_window_scores": (ops_window, "window_scores"),
            "K1_tile_stack": (ops_window, "tile_stack")}) as search_rec:
        bank, lengths = make_bank(templates, device)
        of.match_many(scenes[:3], bank, params, searcher, optimizer,
                      penalty=penalty, template_lengths=lengths, top_k=TOP_K,
                      device=device, scene_chunk=3)
    with generation(4), Recorder({
            "K1_window_scores": (ops_window, "window_scores")}) as dense_rec:
        of.match_many(scenes[:3], bank, params, searcher, of.DenseOptimize(),
                      penalty=penalty, template_lengths=lengths, top_k=TOP_K,
                      device=device, scene_chunk=3)
    torch.cuda.synchronize()
    # the dense sweep's first 64-lane window (t0 = 1 for every candidate)
    dense = [c for c in dense_rec.calls["K1_window_scores"]
             if c[1]["count"] == ops_window.K_POS and bool((c[0][6] == 1).all())]
    check(dense, "no dense 64-lane K1 call was recorded")

    window_calls = search_rec.calls["K1_window_scores"]
    main_pass = [c for c in window_calls if c[1]["two_sided"]][:1]
    ext_pass = [c for c in window_calls if not c[1]["two_sided"]
                and c[1]["count"] == ops_window.K_POS][:1]
    check(main_pass, "no two-sided window call was recorded")
    # the one-sided pattern on the whole main-pass candidate set too: random
    # resume steps, negative direction
    (li, ep, sid, wt, tr, v, t0), main_kw = main_pass[0]
    gen = torch.Generator(device="cpu").manual_seed(1)
    t0r = torch.randint(1, 60, (t0.shape[0],), generator=gen).float().to(device)
    one_sided = [((li, ep, sid, wt, tr, (-v).contiguous(), t0r),
                  dict(count=ops_window.K_POS, two_sided=False,
                       tiles=main_kw["tiles"]))]
    cases = dict(build_rec.calls)
    cases["K1_window_scores"] = main_pass + ext_pass + one_sided + dense[:1]
    cases["K1_tile_stack"] = search_rec.calls["K1_tile_stack"][:1]
    for version in (2, 3):
        cases[WINDOW_KERNEL[version]] = record_generation(
            version, bank, scenes, params, searcher, penalty, device, lengths)

    report = {}
    for name, (kernel, plain, _, _) in KERNELS.items():
        calls = cases[name]
        check(calls, f"no {name} call was recorded")
        n_bad, err, shapes = 0, 0.0, []
        for args, kw in calls:
            got = kernel(*fresh(args), **kw)
            want = plain(*(fresh(args) if name in PLAIN_ON_CARD else to_cpu(args)),
                         **plain_kw(kw))
            torch.cuda.synchronize()
            n_bad += mismatches(got, want)
            err = max(err, max_abs_err(got, want))
            shapes.append((tuple(args[1].shape), kw.get("count", kw.get("two_sided")))
                          if name in WINDOW_WEIGHTS else tuple(args[0].shape))
            del got, want
        # K4 works in place: each timing loop runs on its own copy
        k_each = [cuda_ms(lambda a=fresh(a), k=k: kernel(*a, **k), 10) for a, k in calls]
        p_each = [cuda_ms(lambda a=fresh(a), k=plain_kw(k): plain(*a, **k), 2)
                  for a, k in calls]
        k_ms, p_ms = sum(k_each), sum(p_each)
        b_ms, b_by, b_each = bound(name, calls)
        print(f"[kernel] {name}: {len(calls)} call(s) {shapes}: mismatches "
              f"{n_bad}, max_abs_err {err}, kernel {k_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}; {100 * b_ms / k_ms:.1f} % of it "
              f"reached), plain {p_ms:.4f} ms (sums over the calls, on the "
              f"card; per call {[round(t, 4) for t in k_each]} vs "
              f"{[round(t, 4) for t in p_each]}; bytes, operations per call "
              f"{b_each})")
        check(n_bad == 0, f"{name}: {n_bad} elements differ from the plain version")
        report[name] = dict(mismatches=n_bad, max_abs_err=err, ms=k_ms,
                            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                            library_ms=library_ms(name, calls))
    for name in WINDOW_KERNEL.values():
        major_split(name, cases[name][0])
    return report, cases


def library_ms(name, calls):
    """The time of one PyTorch call computing the kernel's function on the
    same inputs, summed over the calls, where there is one: for K1's tile
    copy on a canvas of whole tiles, one permuting copy; else None."""
    if name != "K1_tile_stack":
        return None
    total = 0.0
    for (li,), _ in calls:
        n, th, tw, _ = ops_window.tile_shape(li.shape)
        if li.shape[-2:] != (th * 4, tw * 8):
            return None
        view = li.reshape(n, th, 2, 2, tw, 2, 4).permute(0, 1, 4, 2, 5, 3, 6)
        check(mismatches(view.contiguous().reshape(n, th, tw, 32),
                         ops_window.tile_stack(li)) == 0,
              "K1_tile_stack: the permuting copy differs")
        total += cuda_ms(view.contiguous, 10)
    return total


def major_split(name, call):
    """A window kernel's main pass on its x-major and y-major candidates
    apart, on the tiled copy and on the row-major stack: mismatches against
    the plain version, time, bound.  K1's candidates split by their step
    vector (|v.x| = 1, else |v.y| = 1; null steps apart), K5's and K6's by
    their ``x_major`` input."""
    kernel, plain = KERNELS[name][:2]
    args, kw = call
    if name == "K1_window_scores":
        v = args[5]
        x_major = v[:, 0].abs() == 1
        y_major = (v[:, 1].abs() == 1) & ~x_major
    else:
        x_major = args[-1] != 0
        y_major = ~x_major
    rest = ~x_major & ~y_major
    live = (args[WINDOW_WEIGHTS[name]] != 0).any(dim=1)
    counts = [f"{int(sel.sum())} {label} ({int((sel & live).sum())} with a "
              f"line of nonzero weight)" for label, sel in (
                  ("x-major", x_major), ("y-major", y_major), ("others", rest))]
    print(f"[kernel] {name} main pass split: {', '.join(counts)} of "
          f"{x_major.numel()} candidates")
    for label, sel in (("x-major", x_major), ("y-major", y_major)):
        idx = sel.nonzero()[:, 0]
        sub = (args[0],) + tuple(a[idx].contiguous() for a in args[1:])
        want = plain(*to_cpu(sub), **plain_kw(kw))
        line = []
        for layout, k in (("tiles", kw), ("rows", plain_kw(kw))):
            n_bad = mismatches(kernel(*sub, **k), want)
            check(n_bad == 0, f"{name} {label} ({layout}): {n_bad} elements differ")
            ms = cuda_ms(lambda k=k: kernel(*sub, **k), 10)
            line.append(f"{layout} {ms:.4f} ms")
        b_ms, b_by, _ = bound(name, [(sub, kw)])
        print(f"[kernel] {name} main pass, {label}: {idx.numel()} candidates, "
              f"mismatches 0 on both layouts, {', '.join(line)}, bound "
              f"{b_ms:.4f} ms ({b_by})")


def make_bank(templates, device):
    """The bank padded to one shared (count, lmax) bucket for every object,
    as ``bench.py`` pads the pose banks, with its template lengths."""
    bank = of.prepare_templates(templates, lmax_to=40, count_to=128, device=device)
    lengths = np.zeros(128, np.float32)
    lengths[:len(templates)] = of.get_template_lengths(templates)
    return bank, lengths


def phase_ieee(device):
    """CUDA ``/`` and sqrt against numpy's IEEE results."""
    rng = np.random.default_rng(2)
    n = 1_000_000
    mag = lambda: 10.0 ** rng.uniform(-30, 38, n)
    a = (rng.choice([-1, 1], n) * mag()).astype(np.float32)
    b = (rng.choice([-1, 1], n) * mag()).astype(np.float32)
    a[:1000] = rng.uniform(1e36, 3e38, 1000).astype(np.float32)   # huge quotients
    b[:1000] = rng.uniform(1.0, 4.0, 1000).astype(np.float32)
    with np.errstate(all="ignore"):
        q_ref, s_ref = a / b, np.sqrt(np.abs(a))
    ta, tb = torch.as_tensor(a, device=device), torch.as_tensor(b, device=device)
    n_div = mismatches(ta / tb, torch.as_tensor(q_ref))
    n_sqrt = mismatches(sqrt_f32(ta.abs()), torch.as_tensor(s_ref))
    n_sqrt_raw = mismatches(torch.sqrt(ta.abs()), torch.as_tensor(s_ref))
    n_huge = int((np.abs(q_ref) > 8.3e34).sum())
    print(f"[ieee] {n} pairs ({n_huge} quotients above 8.3e34): divide "
          f"mismatches {n_div}, sqrt (port) mismatches {n_sqrt}, "
          f"torch.sqrt f32 mismatches {n_sqrt_raw}")
    check(n_div == 0 and n_sqrt == 0, "CUDA divide or sqrt is not IEEE-rounded")
    # the penalty's power: pow_f32 against numpy's f64 power rounded to f32
    x = rng.uniform(1, 5000, n).astype(np.float32)
    want = torch.as_tensor(np.power(x.astype(np.float64), 1.5).astype(np.float32))
    tx = torch.as_tensor(x, device=device)
    n_pow = mismatches(pow_f32(tx, 1.5), want)
    n_pow_raw = mismatches(torch.pow(tx, 1.5), want)
    print(f"[ieee] {n} lengths in [1, 5000] at tau 1.5: pow_f32 mismatches "
          f"{n_pow}, torch.pow f32 mismatches {n_pow_raw}")
    check(n_pow == 0, "pow_f32 differs from the f64 power rounded to f32")


def run_slice(banks, params, searcher, optimizer, penalty, device, timer,
              top_k=TOP_K, mesh=None):
    results = []
    for templates, scenes, _ in banks:
        bank, lengths = make_bank(templates, device)
        results.append(of.match_many(scenes, bank, params, searcher, optimizer,
                                     penalty=penalty, template_lengths=lengths,
                                     top_k=top_k, device=device, timer=timer,
                                     mesh=mesh))
    torch.cuda.synchronize()
    return results


def phase_small_reference(banks, params, searcher, optimizer, penalty, device):
    """The slice on CUDA against the same slice on the CPU (all plain
    versions) on a small input (8 templates, 2 scenes, a 256² canvas):
    ``optimizer`` under generation 4, DefaultOptimize under 2, 3 and 4,
    DenseOptimize, and ``optimizer`` on the host ranking path."""
    for version, opt, top_k in ((4, optimizer, TOP_K),
                                (2, of.DefaultOptimize(), TOP_K),
                                (3, of.DefaultOptimize(), TOP_K),
                                (4, of.DefaultOptimize(), TOP_K),
                                (4, of.DenseOptimize(), TOP_K),
                                (4, optimizer, None)):
        label = f"generation {version}, {type(opt).__name__}" + (
            "" if top_k else ", host ranking (no top_k)")
        with generation(version):
            small_reference(banks, params, searcher, opt, penalty, device,
                            label, top_k)


def small_reference(banks, params, searcher, optimizer, penalty, device, label,
                    top_k=TOP_K):
    templates, scenes, _ = banks[0]
    small = templates[:8]
    scene_list = [np.concatenate([templates[0] + 150.0, scenes[0][:20] * 0.4]),
                  np.concatenate([templates[3] + 120.0, scenes[1][:20] * 0.4])]
    lengths = of.get_template_lengths(small)
    out = {}
    for dev in (device, "cpu"):
        out[dev] = of.match_many(scene_list, small, params, searcher, optimizer,
                                 penalty=penalty, template_lengths=lengths,
                                 top_k=top_k, device=dev)
    n_rows = 0
    for a_list, b_list in zip(out[device], out["cpu"]):
        check(len(a_list) == len(b_list) > 0, "small input: list lengths differ")
        for a, b in zip(a_list, b_list):
            check(a.tmpl_idx == b.tmpl_idx, "small input: template ids differ")
            # the penalty's power is pow_f32 on both devices
            check(a.score == b.score, f"small input: score {a.score} vs {b.score}")
            check(np.allclose(a.transform, b.transform, rtol=1e-6, atol=1e-5),
                  "small input: transforms differ")
            n_rows += 1
    print(f"[reference] small input, {label}, CUDA vs CPU: {n_rows} rows "
          f"agree (ids equal, scores equal, transforms atol 1e-5)")


def reset_counts():
    torch.cuda.synchronize()
    for kernel, *_ in KERNELS.values():
        kernel.launches = 0
    opt_mod.host_sync.count = 0


def read_counts():
    torch.cuda.synchronize()
    return ({name: k[0].launches for name, k in KERNELS.items()},
            opt_mod.host_sync.count)


def straggler_counts(values):
    """From the values the walks' host syncs read, in order: candidates
    entering extension passes (the live count before each), candidates
    entering lockstep walks (the live count after a non-empty extension
    pass), and lockstep windows evaluated (the walks' true any-live reads)."""
    ext_in = walk_in = windows = 0
    after_ext = False
    for v in values:
        if isinstance(v, bool):
            windows += v
        elif after_ext:
            walk_in, after_ext = walk_in + v, False
        else:
            ext_in, after_ext = ext_in + v, v > 0
    return dict(ext_pass=ext_in, walk=walk_in, walk_windows=windows)


@contextlib.contextmanager
def logged_host_syncs():
    """Record what every host sync of the walks returns (the count on the
    function stays live: its body increments it through the module name)."""
    real, values = opt_mod.host_sync, []

    @functools.wraps(real)
    def logged(t):
        values.append(real(t))
        return values[-1]
    opt_mod.host_sync = logged
    try:
        yield values
    finally:
        real.count = logged.count
        opt_mod.host_sync = real


def timed_run(banks, params, searcher, optimizer, penalty, device,
              top_k=TOP_K):
    """One run of the path with the counts set to 0 just before it and read
    just after: ``(results, launches, host syncs, stage totals, wall s,
    straggler counts)``."""
    timer = of.StageTimer()
    with logged_host_syncs() as values:
        reset_counts()
        t0 = time.perf_counter()
        results = run_slice(banks, params, searcher, optimizer, penalty,
                            device, timer, top_k)
        wall = time.perf_counter() - t0
        launches, syncs = read_counts()
    return results, launches, syncs, timer.totals, wall, straggler_counts(values)


def check_path_launches(launches, version, label):
    for name in SEARCH_KERNELS[version] + BUILD_KERNELS:
        check(launches[name] > 0, f"{label}: kernel {name} was not launched")


def check_topk(banks, first, second=None):
    """Non-empty, finite top-k per scene (and equal to ``second``);
    returns the count of scenes whose planted template is in the top-k."""
    hits = 0
    for i, ((_, _, planted), r1) in enumerate(zip(banks, first)):
        for s_i, (matches, j) in enumerate(zip(r1, planted)):
            check(len(matches) > 0, "a scene has an empty top-k")
            for m in matches:
                check(np.isfinite(m.score) and np.isfinite(m.transform).all()
                      and m.transform.shape == (2, 3), "non-finite match")
            if second is not None:
                again = second[i][s_i]
                check(len(matches) == len(again) and all(
                    a.tmpl_idx == b.tmpl_idx and a.score == b.score
                    and np.array_equal(a.transform, b.transform)
                    for a, b in zip(matches, again)),
                    "two runs gave different top-k")
            hits += any(m.tmpl_idx == j for m in matches)
    return hits


def stage_line(stages):
    return {k: round(v, 4) for k, v in stages.items()}


def phase_slice(banks, params, searcher, optimizer, penalty, device):
    """The PR-1 path (generation 4, ``optimizer``) twice; returns its
    launch counts and the first run's results."""
    with generation(4):
        first, launches, syncs, st1, wall, strag = timed_run(
            banks, params, searcher, optimizer, penalty, device)
        second, _, _, st2, wall2, _ = timed_run(
            banks, params, searcher, optimizer, penalty, device)
    print(f"[slice] launches {launches} host syncs {syncs} stragglers {strag}")
    check_path_launches(launches, 4, "slice")
    n_scenes = sum(len(s) for _, s, _ in banks)
    hits = check_topk(banks, first, second)
    print(f"[slice] {n_scenes} scenes, top-{TOP_K} non-empty, finite, repeatable; "
          f"planted template in the top-{TOP_K}: {hits}/{n_scenes} "
          f"({hits / n_scenes:.3f})")
    for name, st, w in (("run 1", st1, wall), ("run 2", st2, wall2)):
        print(f"[slice] {name}: {w:.4f} s, {n_scenes / w:.3f} scenes/s, "
              f"stages (s) {stage_line(st)}")
    return launches, first


def compare_generations(mode, runs):
    """Top-k of each generation against generation 4's: scores rtol 1e-6;
    ids equal except where the entries exchanged at a rank have scores
    within rel 1e-6 of each other (counted and printed)."""
    ref = runs[4]
    for version, res in runs.items():
        if version == 4:
            continue
        n_ex = n_rows = 0
        for bank_a, bank_b in zip(res, ref):
            for a_list, b_list in zip(bank_a, bank_b):
                check(len(a_list) == len(b_list),
                      f"{mode}: generation {version} vs 4: top-k lengths differ")
                for a, b in zip(a_list, b_list):
                    check(np.isclose(a.score, b.score, rtol=1e-6, atol=0),
                          f"{mode}: generation {version} vs 4: score "
                          f"{a.score} vs {b.score}")
                    n_ex += a.tmpl_idx != b.tmpl_idx
                    n_rows += 1
        print(f"[generations] {mode}: generation {version} vs 4: {n_rows} top-"
              f"{TOP_K} rows, scores rtol 1e-6, {n_ex} id exchanges between "
              f"entries within rel 1e-6")


def phase_generations(banks, params, searcher, penalty, device, batch_ref):
    """DefaultOptimize over the whole workload under generations 2, 3 and
    4, twice each; IndulgentOptimize and BatchOptimize(10) on bank 0 under
    each generation (BatchOptimize's generation 4 from ``batch_ref``, the
    slice phase's run).  Returns the launch counts of each generation's
    first DefaultOptimize run."""
    n_scenes = sum(len(s) for _, s, _ in banks)
    default_runs, launches_by_gen = {}, {}
    for version in (2, 3, 4):
        with generation(version):
            first, launches, syncs, st1, wall, strag = timed_run(
                banks, params, searcher, of.DefaultOptimize(), penalty, device)
            second, _, syncs2, st2, wall2, _ = timed_run(
                banks, params, searcher, of.DefaultOptimize(), penalty, device)
        check_path_launches(launches, version, f"DefaultOptimize, generation {version}")
        hits = check_topk(banks, first, second)
        window = {WINDOW_KERNEL[v]: launches[WINDOW_KERNEL[v]] for v in (2, 3, 4)}
        print(f"[generations] DefaultOptimize, generation {version}: window "
              f"launches {window}, host syncs {syncs} / {syncs2}, stragglers "
              f"{strag}, planted "
              f"{hits}/{n_scenes}, run 1 {wall:.4f} s, run 2 {wall2:.4f} s "
              f"({n_scenes / wall2:.3f} scenes/s), stages run 2 (s) "
              f"{stage_line(st2)}")
        default_runs[version] = first
        launches_by_gen[version] = launches
    compare_generations("DefaultOptimize", default_runs)

    bank0 = banks[:1]
    for mode, optimizer, versions in (
            ("IndulgentOptimize", of.IndulgentOptimize(), (2, 3, 4)),
            ("BatchOptimize(10)", of.BatchOptimize(10), (2, 3))):
        runs = {4: batch_ref[:1]} if 4 not in versions else {}
        for version in versions:
            with generation(version):
                res, launches, syncs, st, wall, strag = timed_run(
                    bank0, params, searcher, optimizer, penalty, device)
            check_path_launches(launches, version, f"{mode}, generation {version}")
            hits = check_topk(bank0, res)
            print(f"[generations] {mode}, generation {version}, bank 0: "
                  f"{WINDOW_KERNEL[version]} launches "
                  f"{launches[WINDOW_KERNEL[version]]}, K1 {launches['K1_window_scores']}, "
                  f"host syncs {syncs}, stragglers {strag}, planted "
                  f"{hits}/{len(bank0[0][1])}, "
                  f"{wall:.4f} s, stages (s) {stage_line(st)}")
            runs[version] = res
        compare_generations(mode, runs)
    return launches_by_gen


def same_lists(got, want, label):
    """Per bank and scene, equal match lists: ids, scores and transforms."""
    n = 0
    for bank_a, bank_b in zip(got, want, strict=True):
        for a_list, b_list in zip(bank_a, bank_b, strict=True):
            check(len(a_list) == len(b_list), f"{label}: list lengths differ")
            for a, b in zip(a_list, b_list):
                check(a.tmpl_idx == b.tmpl_idx and a.score == b.score
                      and np.array_equal(a.transform, b.transform),
                      f"{label}: ({a.tmpl_idx}, {a.score}) vs "
                      f"({b.tmpl_idx}, {b.score})")
                n += 1
    return n


def phase_dense(banks, params, searcher, penalty, device, batch_ref):
    """DenseOptimize over the whole workload at generation 4, twice: K1
    launches, finite repeatable top-10s, and per scene a top-1 at most the
    slice's BatchOptimize top-1 (``batch_ref``)."""
    n_scenes = sum(len(s) for _, s, _ in banks)
    with generation(4):
        first, launches, syncs, _, wall, _ = timed_run(
            banks, params, searcher, of.DenseOptimize(), penalty, device)
        second, launches2, _, st2, wall2, _ = timed_run(
            banks, params, searcher, of.DenseOptimize(), penalty, device)
    check_path_launches(launches, 4, "dense")
    check(launches["K5_window_v2"] == launches["K6_window_v3"] == 0,
          "dense: a generation-2/3 window kernel was launched")
    hits = check_topk(banks, first, second)
    lower = 0
    for bank_d, bank_b in zip(first, batch_ref):
        for d, b in zip(bank_d, bank_b):
            check(d[0].score <= b[0].score,
                  f"dense top-1 {d[0].score} above BatchOptimize's {b[0].score}")
            lower += d[0].score < b[0].score
    print(f"[dense] K1 launches per run {launches['K1_window_scores']} / "
          f"{launches2['K1_window_scores']}, tile copies "
          f"{launches['K1_tile_stack']}, K5/K6 0, host syncs {syncs}; "
          f"top-{TOP_K} non-empty, finite, repeatable; planted "
          f"{hits}/{n_scenes}; top-1 <= BatchOptimize(10)'s on "
          f"{n_scenes}/{n_scenes} scenes ({lower} strictly lower)")
    print(f"[dense] run 1 {wall:.4f} s, run 2 {wall2:.4f} s "
          f"({n_scenes / wall2:.3f} scenes/s), stages run 2 (s) {stage_line(st2)}")
    return launches


def phase_concentric(banks, params, penalty, device, batch_ref):
    """ConcentricRangeStrategy around the scenes' common center, its outer
    radius the median line-center radius, over the whole workload; then an
    annulus covering every line against the slice's top-10s."""
    from openfdcm_tpu_torch.matching.search import filter_in_range
    all_scenes = [s for _, scenes, _ in banks for s in scenes]
    mids = np.concatenate([(s[:, :2] + s[:, 2:]) / 2 for s in all_scenes])
    center = tuple(float(c) for c in mids.mean(axis=0))
    radius = float(np.median(np.linalg.norm(mids - np.asarray(center), axis=1)))
    strat = of.ConcentricRangeStrategy(4, 10, center, 0.0, radius)
    shares = [len(filter_in_range(s, center, 0.0, radius)) / len(s)
              for s in all_scenes]
    with generation(4):
        res, launches, syncs, st, wall, _ = timed_run(
            banks, params, strat, of.BatchOptimize(10), penalty, device)
    check_path_launches(launches, 4, "concentric")
    hits = check_topk(banks, res)
    print(f"[concentric] center ({center[0]:.2f}, {center[1]:.2f}), radius "
          f"(0, {radius:.2f}): lines kept per scene {min(shares):.3f}-"
          f"{max(shares):.3f} (mean {np.mean(shares):.3f}); launches "
          f"{launches}, host syncs {syncs}, planted {hits}/{len(all_scenes)}, "
          f"{wall:.4f} s ({len(all_scenes) / wall:.3f} scenes/s)")
    cover = of.ConcentricRangeStrategy(4, 10, (0.0, 0.0), 0.0, 1e9)
    with generation(4):
        every = run_slice(banks, params, cover, of.BatchOptimize(10), penalty,
                          device, None)
    n = same_lists(every, batch_ref, "covering annulus vs DefaultSearch")
    print(f"[concentric] an annulus covering every line: {n} top-{TOP_K} rows "
          f"equal DefaultSearch(4, 10)'s exactly")


def phase_host_ranking(banks, params, searcher, penalty, device, batch_ref):
    """Bank 0 without ``top_k``: every valid match in emplace order,
    penalized on the host.  Its sorted head equals the slice's top-10 rows;
    a DefaultSearch subclass with a user penalty of the same function gives
    the same lists; generations 2 and 3 with their K5/K6 launches."""
    bank0 = banks[:1]
    n_scenes = len(bank0[0][1])
    opt = of.BatchOptimize(10)
    with generation(4):
        full, launches, syncs, st, wall, _ = timed_run(
            bank0, params, searcher, opt, penalty, device, top_k=None)
    check_path_launches(launches, 4, "host ranking")
    heads = [[of.sort_matches(m)[:TOP_K] for m in full[0]]]
    n_rows = same_lists(heads, batch_ref[:1], "host ranking head vs top-k")
    n_all = sum(len(m) for m in full[0])
    print(f"[host] bank 0 without top_k: {n_all} matches over {n_scenes} "
          f"scenes, sorted heads equal the top-{TOP_K} rows exactly ({n_rows} "
          f"rows); launches {launches}, host syncs {syncs}, {wall:.4f} s "
          f"({n_scenes / wall:.3f} scenes/s), stages (s) {stage_line(st)}")

    class Subclass(of.DefaultSearch):
        pass

    class SamePenalty:
        def apply(self, score, length):
            return of.ExponentialPenalty(penalty.tau).apply(score, length)
    with generation(4):
        sub = run_slice(bank0, params, Subclass(4, 10), opt, SamePenalty(),
                        device, None, top_k=None)
    n = same_lists(sub, full, "subclassed searcher, user penalty")
    print(f"[host] a DefaultSearch subclass with a user penalty: {n} matches "
          f"equal")
    for version in (2, 3):
        with generation(version):
            res, launches_v, syncs_v, _, wall_v, _ = timed_run(
                bank0, params, searcher, opt, penalty, device, top_k=None)
        check_path_launches(launches_v, version, f"host ranking, generation {version}")
        check([len(m) for m in res[0]] == [len(m) for m in full[0]],
              f"host ranking, generation {version}: match counts differ")
        print(f"[host] generation {version}: {WINDOW_KERNEL[version]} launches "
              f"{launches_v[WINDOW_KERNEL[version]]}, K1 "
              f"{launches_v['K1_window_scores']}, host syncs {syncs_v}, "
              f"{wall_v:.4f} s")
        compare_generations(f"host ranking heads", {
            4: heads, version: [[of.sort_matches(m)[:TOP_K] for m in res[0]]]})


def hold_plain(name, calls):
    """Recorded calls of a build kernel against its plain version on the
    card: the mismatch count."""
    kernel, plain = KERNELS[name][:2]
    n_bad = 0
    for args, kw in calls:
        n_bad += mismatches(kernel(*fresh(args), **kw), plain(*fresh(args), **kw))
    return n_bad


def phase_single_scene(banks, params, searcher, penalty, device, batch_ref):
    """Bank 0's scenes one at a time through the reference's entry path;
    then one scene's ``pad_to=None`` build and its search under each
    generation, ``evaluate`` and a save/load round trip."""
    import tempfile
    templates, scenes, _ = banks[0]
    bank, lengths = make_bank(templates, device)
    opt = of.BatchOptimize(10)
    with generation(4):
        reset_counts()
        t0 = time.perf_counter()
        tops = []
        for scene in scenes:
            fm = of.build_featuremap(scene, params, device=device)
            found = of.search(of.DefaultMatch(), searcher, opt, fm, bank, scene)
            tops.append(of.sort_matches(of.penalize(penalty, found, lengths))[:TOP_K])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, syncs = read_counts()
    for name in BUILD_KERNELS:
        check(launches[name] == len(scenes),
              f"single scene: {name} launched {launches[name]} times")
    check_path_launches(launches, 4, "single scene")
    n = same_lists([tops], batch_ref[:1], "single-scene top-k vs match_many")
    print(f"[single] bank 0, {len(scenes)} scenes through build_featuremap -> "
          f"search -> penalize -> sort_matches: top-{TOP_K}s equal match_many's "
          f"({n} rows); launches {launches}, host syncs {syncs}, {wall:.4f} s "
          f"({len(scenes) / wall:.3f} scenes/s)")

    scene = scenes[0]
    with Recorder({"K2_minplus_rows": (dt_mod, "minplus_rows"),
                   "K3_propagate_orientation": (fm_mod, "k3_relax"),
                   "K4_sweep_stack": (integral_mod, "sweep_stack")}) as rec:
        fm = of.build_featuremap(scene, params, pad_to=None, device=device)
    ref = of.build_featuremap(scene, params, pad_to=None, device="cpu")
    n_bad = mismatches(fm.dt3, ref.dt3)
    check(n_bad == 0, f"pad_to=None build: {n_bad} cells differ from the CPU")
    held = {name: hold_plain(name, calls) for name, calls in rec.calls.items()}
    check(all(v == 0 for v in held.values()),
          f"pad_to=None build: kernel vs plain mismatches {held}")
    print(f"[single] pad_to=None build {tuple(fm.dt3.shape)}: bit-equal to the "
          f"CPU build; K2/K3/K4 calls vs plain on the card, mismatches {held}")
    found = {}
    for version in (4, 3, 2):
        with generation(version):
            reset_counts()
            found[version] = of.search(of.DefaultMatch(), searcher, opt, fm,
                                       bank, scene)
            launches, _ = read_counts()
            own = launches[WINDOW_KERNEL[version]] > 0
            gated = window_generation(fm.dt3[None].shape) != version
        check(own != gated, f"pad_to=None search, generation {version}: "
              f"window launches {launches} against the canvas gate")
        if gated:
            same_lists([[found[version]]], [[found[4]]],
                       f"pad_to=None search, generation {version}")
        elif version != 4:
            check(len(found[version]) == len(found[4]),
                  f"pad_to=None search, generation {version}: match count differs")
            compare_generations("pad_to=None search heads", {
                v: [[of.sort_matches(of.penalize(penalty, found[v], lengths))[:TOP_K]]]
                for v in (4, version)})
        print(f"[single] pad_to=None search, generation {version}: launches "
              f"K1 {launches['K1_window_scores']}, K5 {launches['K5_window_v2']}, "
              f"K6 {launches['K6_window_v3']}, {len(found[version])} matches"
              + (", equal to generation 4's (the canvas gate)" if gated else ""))
    steps = ((0, 0), (3, -2), (-40, 7))
    trs = [[np.asarray([dx, dy], np.float32) for dx, dy in steps]] * 8
    got = of.evaluate(fm, templates[:8], trs)
    want = of.evaluate(ref, templates[:8], trs)
    check(got == want, "evaluate on the card differs from the CPU")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fm.npz")
        of.save_featuremap(path, fm)
        back = of.load_featuremap(path, device=device)
    check(mismatches(back.dt3, fm.dt3) == 0 and back.feature_size == fm.feature_size,
          "save/load round trip differs")
    print(f"[single] evaluate on the card equals the CPU ({sum(map(len, got))} "
          f"scores, line-order sums); save/load round trip bit-equal")


def phase_template_chunks(banks, params, searcher, penalty, device, batch_ref):
    """Bank 0 with a device budget forced so small that a dispatch of five
    scenes takes 32 templates (fewer scenes take more), against the
    slice's top-10s."""
    templates, scenes, _ = banks[0]
    bank, lengths = make_bank(templates, device)
    scene_chunk, mt, ms, per = 5, 4, 10, 32
    canvas = max(-(-max(fm_mod.scene_centered_translation(s, params.padding)[1])
                   // 128) * 128 for s in scenes)
    budget = scene_chunk * (
        pipeline_mod._tile_bytes((params.depth, canvas, canvas))
        + pipeline_mod._cand_bytes(bank.lmax) * 2 * mt * ms * per)
    calls = []
    saved = pipeline_mod._budget, pipeline_mod._search_device_batch_topk_genpairs

    def counted(*args, **kw):
        calls.append(args[0].shape[0])
        return saved[1](*args, **kw)
    pipeline_mod._budget = lambda dev: budget
    pipeline_mod._search_device_batch_topk_genpairs = counted
    try:
        with generation(4):
            res = of.match_many(scenes, bank, params, searcher,
                                of.BatchOptimize(10), penalty=penalty,
                                template_lengths=lengths, top_k=TOP_K,
                                scene_chunk=scene_chunk, device=device)
    finally:
        pipeline_mod._budget, pipeline_mod._search_device_batch_topk_genpairs = saved
    check(max(calls) < len(bank.host),
          f"template chunks: dispatches of {calls} templates")
    n = same_lists([res], batch_ref[:1], "template chunks vs unchunked")
    print(f"[chunks] bank 0 under a {budget / 1e6:.1f} MB budget: {len(calls)} "
          f"dispatches of {sorted(set(calls))} templates; {n} top-{TOP_K} rows "
          f"equal the unchunked run's")


def profiled(fn):
    """Run ``fn`` under ``torch.profiler``: ``(rows, wall s)``, rows
    ``(kernel name, launches, device ms)`` by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    # device-side events only: the ops that launched them report the same time
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[2]), wall


def phase_profile(banks, params, searcher, optimizer, penalty, device, report,
                  top=20):
    """One more slice run under ``torch.profiler``: device time by kernel
    name, the device's busy share of the run's wall time, the share of
    device time in the port's kernels, and K3's time per launch beside its
    CUDA-event time in ``report``; then one DefaultOptimize run under
    window generations 2 and 3 each: their window kernels' device time;
    then one DenseOptimize run and bank 0 one scene at a time: device busy
    and the kernels' device time."""
    rows, wall = profiled(lambda: run_slice(banks, params, searcher, optimizer,
                                            penalty, device, None))
    busy = sum(r[2] for r in rows)
    ours = sum(r[2] for r in rows if any(k in r[0] for k in PROFILE_NAMES))
    print(f"[profile] wall {wall * 1e3:.3f} ms (profiled), device busy "
          f"{busy:.3f} ms ({busy / (wall * 1e3):.3f} of wall), the port's "
          f"kernels {ours:.3f} ms ({ours / max(busy, 1e-9):.3f} of device time)")
    for name, count, ms in rows[:top]:
        print(f"[profile] {ms:10.3f} ms {count:7d}x  {name[:110]}")
    k3 = [r for r in rows if "prop_fixed" in r[0] or "prop_any" in r[0]]
    check(k3, "the profile shows no K3 launch")
    n3, ms3 = sum(r[1] for r in k3), sum(r[2] for r in k3)
    ev = report["K3_propagate_orientation"]["ms"]
    print(f"[profile] K3 per 10-scene launch: {ms3 / n3:.4f} ms in the profile "
          f"({n3} launches, {[r[0][:60] for r in k3]}), {ev:.4f} ms by CUDA "
          f"events on the recorded build (phase 3)")
    for version, kernel in ((2, "window_v2_kernel"), (3, "window_v3_kernel")):
        with generation(version):
            rows, wall = profiled(lambda: run_slice(
                banks, params, searcher, of.DefaultOptimize(), penalty, device,
                None))
        mine = [r for r in rows if kernel in r[0]]
        k1 = [r for r in rows if "window_kernel" in r[0]]
        copy = [r for r in rows if "tile_kernel" in r[0]]
        check(mine, f"the generation-{version} profile shows no {kernel}")
        print(f"[profile] DefaultOptimize, generation {version}: {kernel} "
              f"{sum(r[2] for r in mine):.3f} ms over {sum(r[1] for r in mine)} "
              f"launches, K1 {sum(r[2] for r in k1):.3f} ms over "
              f"{sum(r[1] for r in k1)}, tile copy "
              f"{sum(r[2] for r in copy):.3f} ms over {sum(r[1] for r in copy)}, "
              f"device busy {sum(r[2] for r in rows):.3f} ms, wall "
              f"{wall * 1e3:.3f} ms")
    # this slice's new paths: the dense sweep over the workload, and bank 0
    # one scene at a time through build_featuremap and search
    templates, scenes, _ = banks[0]
    bank, _ = make_bank(templates, device)

    def single():
        for scene in scenes:
            of.search(of.DefaultMatch(), searcher, optimizer,
                      of.build_featuremap(scene, params, device=device), bank,
                      scene)
        torch.cuda.synchronize()
    for label, fn in (
            ("DenseOptimize, 40 scenes", lambda: run_slice(
                banks, params, searcher, of.DenseOptimize(), penalty, device,
                None)),
            ("single scene, bank 0", single)):
        rows, wall = profiled(fn)
        busy = sum(r[2] for r in rows)
        mine = {n: (sum(r[1] for r in rows if n in r[0]),
                    sum(r[2] for r in rows if n in r[0]))
                for n in PROFILE_NAMES if any(n in r[0] for r in rows)}
        print(f"[profile] {label}: wall {wall * 1e3:.3f} ms (profiled), device "
              f"busy {busy:.3f} ms ({busy / (wall * 1e3):.3f} of wall); "
              f"launches and ms by kernel name "
              f"{ {n: (c, round(ms, 3)) for n, (c, ms) in mine.items()} }")


# ---------------------------------------------------------------------------
# the whole bank through the deployment paths (phases 13-20)
# ---------------------------------------------------------------------------

KERNEL_SHORT = {"K1_window_scores": "K1", "K1_tile_stack": "copy",
                "K2_minplus_rows": "K2", "K3_propagate_orientation": "K3",
                "K4_sweep_stack": "K4", "K5_window_v2": "K5", "K6_window_v3": "K6"}


def short(launches):
    return {KERNEL_SHORT[k]: v for k, v in launches.items() if v}


def whole_bank(banks):
    """The 420 templates of the four banks as one bank, the 40 scenes, and
    each scene's planted template index in that bank."""
    templates = [t for tmpls, _, _ in banks for t in tmpls]
    scenes = [s for _, scns, _ in banks for s in scns]
    planted = [b * len(tmpls) + j for b, (tmpls, _, pl) in enumerate(banks)
               for j in pl]
    return templates, scenes, planted


def phase_files(banks, root):
    """Write the whole bank as ``.tmpl`` files and the scenes as ``.scene``
    files with the port's ``io.write`` (zero-padded names, so the sorted
    names are the bank's and the scenes' order), and read them back
    bit-equal, one by one and with ``read_batch``."""
    templates, scenes, _ = whole_bank(banks)
    tdir, sdir = os.path.join(root, "templates"), os.path.join(root, "scenes")
    os.makedirs(tdir)
    os.makedirs(sdir)
    tmpl_paths = [os.path.join(tdir, f"t{i:03d}.tmpl") for i in range(len(templates))]
    scene_paths = [os.path.join(sdir, f"s{i:02d}.scene") for i in range(len(scenes))]
    t0 = time.perf_counter()
    for path, arr in zip(tmpl_paths + scene_paths, templates + scenes):
        of.write(path, arr)
    wrote = time.perf_counter() - t0
    check(sorted(os.listdir(tdir)) == [os.path.basename(p) for p in tmpl_paths]
          and sorted(os.listdir(sdir)) == [os.path.basename(p) for p in scene_paths],
          "files: sorted names are not the bank's order")
    t0 = time.perf_counter()
    batch = of.io.read_batch(tmpl_paths + scene_paths, num_threads=8)
    read = time.perf_counter() - t0
    for path, arr, got in zip(tmpl_paths + scene_paths, templates + scenes, batch):
        check(of.read(path).tobytes() == arr.tobytes() == got.tobytes(),
              f"files: {path} does not read back bit-equal")
    size = sum(os.path.getsize(p) for p in tmpl_paths + scene_paths)
    print(f"[files] {len(tmpl_paths)} .tmpl and {len(scene_paths)} .scene files "
          f"({size / 1e6:.3f} MB, zlib) written in {wrote:.4f} s, read back "
          f"bit-equal one by one and with read_batch (8 threads, {read:.4f} s)")
    return tdir, sdir, tmpl_paths, scene_paths


def phase_whole_bank(banks, params, searcher, optimizer, penalty, device):
    """``match_many`` of the 40 scenes against the 420-template bank, twice:
    repeatable results; the reference rows of phases 15-17."""
    templates, scenes, planted = whole_bank(banks)
    lengths = of.get_template_lengths(templates)
    runs = []
    for _ in range(2):
        reset_counts()
        t0 = time.perf_counter()
        res = of.match_many(scenes, templates, params, searcher, optimizer,
                            penalty=penalty, template_lengths=lengths,
                            top_k=TOP_K, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append((res, read_counts()[0], wall))
    (ref, launches, wall1), (again, launches2, wall2) = runs
    check_path_launches(launches, 4, "whole bank")
    n = same_lists([again], [ref], "whole bank, run 2 vs run 1")
    hits = sum(any(m.tmpl_idx == j for m in ms) for ms, j in zip(ref, planted))
    for ms in ref:
        check(len(ms) == TOP_K and all(np.isfinite(m.score) for m in ms),
              "whole bank: a top-k is short or not finite")
    pairs = len(templates) * len(scenes)
    print(f"[bank] {len(scenes)} scenes x {len(templates)} templates, top-{TOP_K}: "
          f"run 2 equals run 1 ({n} rows), planted {hits}/{len(scenes)}; "
          f"launches {short(launches)} / {short(launches2)}")
    for name, w in (("run 1", wall1), ("run 2", wall2)):
        print(f"[bank] {name}: {w:.4f} s, {len(scenes) / w:.3f} scenes/s, "
              f"{pairs / w:.1f} templates x scenes per s")
    return ref, wall2


def serve_once(svc, scenes, n_clients=4):
    """Submit ``scenes`` from ``n_clients`` threads at once; returns the
    results in scene order and each request's latency from submit to
    result, and the wall time from the first submit to the last result."""
    results, lat = [None] * len(scenes), [None] * len(scenes)
    start = threading.Barrier(n_clients)
    t_first = []

    def client(c):
        start.wait()
        t_first.append(time.perf_counter())
        futs = []
        for i in range(c, len(scenes), n_clients):
            t_sub = time.perf_counter()
            fut = svc.submit(scenes[i])
            fut.add_done_callback(lambda f, i=i, t=t_sub: lat.__setitem__(
                i, time.perf_counter() - t))
            futs.append((i, fut))
        for i, fut in futs:
            results[i] = fut.result(timeout=600)
    threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - min(t_first)
    check(all(r is not None for r in results) and all(x is not None for x in lat),
          "serving: a request got no answer")
    return results, lat, wall


def phase_serving(banks, params, searcher, optimizer, penalty, device, ref):
    """A MatcherService on the whole bank: warmup on 2 scenes, the 40 scenes
    from 4 client threads at once, each answer equal to the whole-bank row;
    then close, after which submit raises."""
    templates, scenes, _ = whole_bank(banks)
    svc = of.MatcherService(templates, params, searcher, optimizer, top_k=TOP_K,
                            penalty=penalty,
                            template_lengths=of.get_template_lengths(templates),
                            max_batch=16, device=device)
    svc.warmup(scenes[:2])
    d0 = svc.dispatches
    reset_counts()
    results, lat, wall = serve_once(svc, scenes)
    launches, syncs = read_counts()
    n_disp = svc.dispatches - d0
    svc.close()
    try:
        svc.submit(scenes[0])
        closed = False
    except RuntimeError:
        closed = True
    check(closed, "serving: submit after close did not raise")
    check_path_launches(launches, 4, "serving")
    n = same_lists([results], [ref], "serving vs whole-bank match_many")
    print(f"[serving] {len(scenes)} requests from 4 threads, max_batch 16: every "
          f"answer equals the whole-bank row ({n} rows); {len(scenes) / wall:.3f} "
          f"requests/s, latency median {np.median(lat) * 1e3:.1f} ms, max "
          f"{max(lat) * 1e3:.1f} ms, {n_disp} dispatches, launches "
          f"{short(launches)}, host syncs {syncs}; submit after close raises")
    return wall


def phase_sweep(banks, params, searcher, optimizer, penalty, device, ref,
                tmpl_paths, root):
    """``resumable_sweep`` over the 420 ``.tmpl`` paths in chunks of a bank
    (105), killed on its third chunk, then resumed with the default matcher: the
    checkpoint holds 2 chunks, chunks 0-1 do not run again, and the result
    equals the whole-bank rows."""
    from openfdcm_tpu_torch import sweep as sweep_mod
    templates, scenes, _ = whole_bank(banks)
    lengths = of.get_template_lengths(templates)
    state_dir = os.path.join(root, "sweep_state")
    kw = dict(top_k=TOP_K, state_dir=state_dir, penalty=penalty,
              template_lengths=lengths, chunk_size=len(banks[0][0]), device=device)

    class Killed(RuntimeError):
        pass
    chunks = []

    def dying(scene_list, chunk_templates, chunk_lengths):
        chunks.append(len(chunk_templates))
        if len(chunks) == 3:
            raise Killed("killed on the third chunk")
        return of.match_many(scene_list, chunk_templates, params, searcher,
                             optimizer, penalty=penalty,
                             template_lengths=chunk_lengths, top_k=TOP_K,
                             device=device)
    try:
        of.resumable_sweep(scenes, tmpl_paths, params, searcher, optimizer,
                           match_fn=dying, **kw)
        killed = False
    except Killed:
        killed = True
    state = of.SweepState.load(state_dir)
    check(killed and state is not None and state.done_chunks == 2,
          f"sweep: killed {killed}, checkpoint "
          f"{None if state is None else state.done_chunks} chunks")
    ran = []
    real = sweep_mod.match_many

    def counted(scene_list, chunk_templates, *a, **k):
        ran.append(len(chunk_templates))
        return real(scene_list, chunk_templates, *a, **k)
    sweep_mod.match_many = counted
    try:
        reset_counts()
        t0 = time.perf_counter()
        res = of.resumable_sweep(scenes, tmpl_paths, params, searcher, optimizer,
                                 **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, syncs = read_counts()
    finally:
        sweep_mod.match_many = real
    check(ran == [len(banks[0][0])] * 2, f"sweep: the resumed run matched chunks of {ran}")
    check_path_launches(launches, 4, "sweep")
    n = same_lists([res], [ref], "resumed sweep vs whole-bank match_many")
    print(f"[sweep] killed on chunk 3 of 4 (chunks {chunks}), checkpoint 2 chunks; "
          f"resumed: chunks {ran} only, result equals the whole-bank rows ({n} "
          f"rows); resumed run {wall:.4f} s (lazy .tmpl reads included), "
          f"{sum(ran) * len(scenes) / wall:.1f} templates x scenes per s, "
          f"launches {short(launches)}, host syncs {syncs}")
    return wall


def run_cli(args, timeout=600):
    """``python3 -m openfdcm_tpu_torch ARGS`` from the repository's root:
    ``(JSON records, wall s)``."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "openfdcm_tpu_torch", *args],
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    check(res.returncode == 0, f"CLI {args[0]} failed: {res.stderr[-2000:]}")
    return [json.loads(line) for line in res.stdout.splitlines()
            if line.startswith("{")], wall


def cli_row(m):
    return {"template": f"t{m.tmpl_idx:03d}.tmpl", "tmpl_idx": m.tmpl_idx,
            "score": round(float(m.score), 6),
            "transform": [[round(float(v), 4) for v in row] for row in m.transform]}


def phase_cli(banks, ref, tdir, sdir, scene_paths, root, device):
    """The CLI in subprocesses with its defaults (the workload's
    parameters; ``--device`` only off the card): ``match`` on scene 0
    equals its whole-bank row at the CLI's rounding; ``sweep`` in chunks of
    a bank (105) gives each scene's best template and score; ``info`` one
    file's line count.  ``match`` once more in this process, for its
    launches."""
    from openfdcm_tpu_torch.__main__ import main as cli_main
    templates, _, _ = whole_bank(banks)
    dev_args = [] if device == "cuda" else ["--device", device]
    match_args = ["match", "--templates", tdir, "--scene", scene_paths[0],
                  "--top-k", str(TOP_K)] + dev_args
    got, wall_m = run_cli(match_args)
    check(got == [cli_row(m) for m in ref[0]],
          "CLI match: lines differ from the whole-bank row of scene 0")
    buf = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(buf):
        cli_main(match_args)
    launches, _ = read_counts()
    check([json.loads(x) for x in buf.getvalue().splitlines()] == got,
          "CLI match in this process differs from the subprocess")
    check_path_launches(launches, 4, "CLI match")
    swept, wall_s = run_cli(["sweep", "--templates", tdir, "--scenes",
                             os.path.join(sdir, "*.scene"), "--state",
                             os.path.join(root, "cli_state"), "--chunk-size",
                             str(len(banks[0][0]))] + dev_args)
    check(len(swept) == len(ref), f"CLI sweep: {len(swept)} lines")
    for rec, path, ms in zip(swept, scene_paths, ref):
        check(rec["scene"] == path and rec["best_template"] == f"t{ms[0].tmpl_idx:03d}.tmpl"
              and rec["best_score"] == round(float(ms[0].score), 6)
              and rec["n_matches"] == len(ms),
              f"CLI sweep: {rec} vs the whole-bank row")
    info, wall_i = run_cli(["info", os.path.join(tdir, "t000.tmpl")])
    check(info[0]["lines"] == templates[0].shape[0], f"CLI info: {info}")
    print(f"[cli] match (scene 0, {len(templates)} templates): {len(got)} lines "
          f"equal the whole-bank row at the CLI's rounding, {wall_m:.3f} s wall "
          f"(process start, imports and the kernels' load included); in this "
          f"process launches {short(launches)}")
    print(f"[cli] sweep --chunk-size {len(banks[0][0])} ({len(swept)} scenes): best template and "
          f"score equal the whole-bank rows, {wall_s:.3f} s wall; info "
          f"{info[0]['lines']} lines, {wall_i:.3f} s wall")


def pose_views(template, theta, p_gt, n_views, rng, device, canvas=640,
               baseline=60.0, depth=100.0):
    """``template`` on the world plane z = 0 (rotated by ``theta``, moved to
    ``p_gt``) seen by ``n_views`` cameras ``baseline`` apart along x,
    centered on the origin, at ``depth``, focal length ``depth`` (scale 1),
    principal point the canvas center; each view's scene is the projected
    template plus 120 seeded clutter lines.  Returns ``(cameras, scenes,
    true centroid (3,))``.

    FDCM places a match to about a pixel (its probes truncate), and a pixel
    moves a two-view point by ``depth / baseline`` in depth: 25 units for
    ``tests/test_pose.py``'s 20-unit baseline at depth 500, under 2 here."""
    from openfdcm_tpu_torch import pose
    rot = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    world = (template.reshape(-1, 2) @ rot.T + p_gt).reshape(-1, 4)
    lines3d = np.zeros((world.shape[0], 6), np.float32)
    lines3d[:, 0:2], lines3d[:, 3:5] = world[:, 0:2], world[:, 2:4]
    c = canvas / 2
    k = np.asarray([[depth, 0, c], [0, depth, c], [0, 0, 1]], np.float32)
    xs = baseline * (np.arange(n_views) - (n_views - 1) / 2)
    cams = [pose.Camera(k, np.eye(3, dtype=np.float32),
                        np.asarray([-x, 0.0, depth], np.float32)) for x in xs]
    scenes = []
    for cam in cams:
        proj = pose.project_lines(lines3d, cam, device=device)
        clutter = _random_lines(rng, N_CLUTTER, (75, canvas - 75))
        lines = np.concatenate([proj, clutter]).astype(np.float32)
        scenes.append(lines[rng.permutation(len(lines))])
    centroid = (template[:, 0:2] + template[:, 2:4]).sum(axis=0) / (2.0 * len(template))
    truth = np.append(rot @ centroid + p_gt, 0.0)
    return cams, scenes, truth


def phase_pose(banks, params, searcher, optimizer, penalty, device, seed):
    """One bank-0 template on the plane z = 0 in 4 views with clutter,
    matched against bank 0 on the card, then ``multiview_detections``: a
    4-vote detection of the planted template at the true point, the
    in-plane angle of ``six_dof_pose``, ``plane_pose`` of view 0; and
    ``multiview_vote`` on the card against the CPU."""
    from openfdcm_tpu_torch import pose
    templates, _, _ = banks[0]
    rng = np.random.default_rng(seed + 7)
    j0 = int(rng.integers(len(templates)))
    theta, p_gt = 0.4, np.asarray([20.0, 10.0])
    cams, scenes, truth = pose_views(templates[j0], theta, p_gt, 4, rng, device)
    lengths = of.get_template_lengths(templates)
    reset_counts()
    t0 = time.perf_counter()
    matches = of.match_many(scenes, templates, params, searcher, optimizer,
                            penalty=penalty, template_lengths=lengths,
                            top_k=TOP_K, device=device)
    dets = pose.multiview_detections(matches, templates, cams, k=TOP_K,
                                     device=device)
    wall = time.perf_counter() - t0
    launches, _ = read_counts()
    check_path_launches(launches, 4, "pose")
    found = [d for d in dets if d.tmpl_idx == j0 and d.votes == 4]
    check(found, f"pose: no 4-vote detection of template {j0} "
          f"({[(d.tmpl_idx, d.votes) for d in dets[:5]]})")
    best = found[0]
    err = np.abs(best.point - truth)
    check(err[0] < 2.5 and err[1] < 2.5 and abs(best.point[2]) < 2.5,
          f"pose: point {best.point} vs truth {truth}")
    p6 = pose.six_dof_pose(best, matches, [np.eye(3)] * len(templates), cams)
    ang = np.arctan2(p6[1, 0], p6[0, 0])
    d_ang = min(abs(ang - theta), abs(abs(ang - theta) - np.pi))
    check(d_ang < 0.15, f"pose: in-plane angle {ang} vs {theta}")
    m0 = [m for m in matches[0] if m.tmpl_idx == j0][0]
    pp = pose.plane_pose(m0, templates, [np.eye(3)] * len(templates), cams[0],
                         np.asarray([0, 0, 1, 0], np.float32), device=device)
    check(np.abs(pp[:2, 3] - truth[:2]).max() < 2.5 and abs(pp[2, 3]) < 1e-3,
          f"pose: plane_pose point {pp[:3, 3]} vs {truth}")
    # the vote on the card against the CPU, on the detections' own inputs
    centers = np.zeros((4, TOP_K, 2), np.float32)
    tidx = np.full((4, TOP_K), -1, np.int32)
    valid = np.zeros((4, TOP_K), bool)
    for vi, ms in enumerate(matches):
        centers[vi, : len(ms)] = pose.match_centers(ms[:TOP_K], templates)
        tidx[vi, : len(ms)] = [m.tmpl_idx for m in ms[:TOP_K]]
        valid[vi, : len(ms)] = True
    cam_np = [np.stack([getattr(c, n) for c in cams]) for n in ("k", "r", "t")]
    out = {dev: [x.cpu().numpy() for x in pose.multiview_vote(
        *(torch.as_tensor(a, device=dev) for a in (centers, tidx, valid, *cam_np)),
        eps_px=8.0)] for dev in (device, "cpu")}
    g, w = out[device], out["cpu"]
    voted = w[1] > 0
    check(np.array_equal(g[1], w[1]) and np.array_equal(g[3], w[3]),
          "pose: votes or pair_idx differ between the card and the CPU")
    pt_err = float(np.abs(g[0][voted] - w[0][voted]).max())
    check(pt_err <= 1e-3, f"pose: vote points differ by {pt_err}")
    print(f"[pose] template {j0} of bank 0 in 4 views (theta {theta}, at "
          f"{truth[:2].tolist()}): {len(dets)} detections, the planted one "
          f"with 4 votes at {np.round(best.point, 3).tolist()} (error "
          f"{np.round(err, 3).tolist()}), rms {best.rms:.3f} px; six_dof_pose "
          f"in-plane angle {ang:.4f} (off {d_ang:.4f}); plane_pose view 0 "
          f"{np.round(pp[:3, 3], 3).tolist()}; vote card vs CPU: "
          f"{int(voted.sum())} voted hypotheses, votes and pair_idx equal, "
          f"points within {pt_err:.2e}; match + detections {wall:.4f} s, "
          f"launches {short(launches)}")


def compat_reference(device):
    """The reference's integration test (``tests/test_compat.py:42-110``)
    through ``openfdcm_tpu_torch.compat`` on ``device``, its assertions as
    checks; returns every sorted match list it made."""
    import openfdcm_tpu_torch.compat as openfdcm

    def create_lines(n, length):
        out = np.zeros((4, n))
        for i, a in enumerate(np.logspace(np.log10(2 * np.pi), np.log10(4 * np.pi), n)):
            out[:, i] = [0, 0, length * np.cos(a), length * np.sin(a)]
        return out

    def apply(lines, mat):
        return (mat[:2, :2] @ lines.reshape(2, -1) + mat[:2, 2:3]).reshape(4, -1)

    close = lambda a, b, atol=1e-5: np.allclose(a, b, atol=atol)
    pool = openfdcm.ThreadPool(4)
    searcher, matcher = openfdcm.DefaultSearch(4, 10), openfdcm.DefaultMatch()
    optimizer = openfdcm.DefaultOptimize(pool)
    tmpl = create_lines(10, 100)
    scene_tr = np.array([[-1, 0, 100], [0, -1, 100]])
    scene = apply(tmpl, scene_tr)
    lists = []
    for distance in (openfdcm.distance.L2, openfdcm.distance.L1,
                     openfdcm.distance.L2_SQUARED):
        params = openfdcm.Dt3CpuParameters(depth=30, dt3Coeff=5.0, padding=2.2,
                                           distance=distance)
        fm = openfdcm.build_cpu_featuremap(scene, params, pool, device=device)
        got = openfdcm.sort_matches(openfdcm.search(matcher, searcher, optimizer,
                                                    fm, [tmpl], scene))
        check(len(got) == 80 and close(scene_tr[:2, :2], got[0].transform[:2, :2])
              and close(scene_tr[:2, 2], got[0].transform[:2, 2], 1.0 / 0.3),
              f"compat {distance.name}: the rotated scene's best match")
        lists.append(got)
        scene_tr = np.array([[1, 0, 0], [0, 1, 0]])
        scene = apply(tmpl, scene_tr)
        fm = openfdcm.build_cpu_featuremap(scene, params, pool, device=device)
        raw = openfdcm.search(matcher, searcher, optimizer, fm, [tmpl], scene)
        got = openfdcm.sort_matches(openfdcm.penalize(
            openfdcm.ExponentialPenalty(1.5), raw, openfdcm.get_template_lengths([tmpl])))
        check(len(raw) == 80 and close(scene_tr[:2, :2], got[0].transform[:2, :2])
              and close(scene_tr[:2, 2], got[0].transform[:2, 2], 1.0),
              f"compat {distance.name}: the identity scene's best match")
        lists.append(got)
        empty = openfdcm.build_cpu_featuremap(np.zeros((4, 0)), params, pool,
                                              device=device)
        check(not openfdcm.search(matcher, searcher, optimizer, empty, [tmpl],
                                  np.zeros((4, 0)))
              and not openfdcm.search(matcher, searcher, optimizer, fm, [], tmpl)
              and not openfdcm.search(matcher, searcher, optimizer, fm,
                                      [np.zeros((4, 0))], tmpl),
              f"compat {distance.name}: an empty search found matches")
    return lists


def phase_compat(device):
    """The reference integration test through the port's compat layer on
    the card (L2, L1, L2²) and on the CPU: the assertions hold, and the
    card's sorted matches equal the CPU's (ids, scores; transforms atol
    1e-5)."""
    reset_counts()
    t0 = time.perf_counter()
    card = compat_reference(device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, _ = read_counts()
    check_path_launches(launches, 4, "compat")
    t0 = time.perf_counter()
    cpu = compat_reference("cpu")
    wall_cpu = time.perf_counter() - t0
    n = 0
    for a_list, b_list in zip(card, cpu, strict=True):
        check(len(a_list) == len(b_list), "compat: list lengths differ")
        for a, b in zip(a_list, b_list):
            check(a.tmpl_idx == b.tmpl_idx and a.score == b.score
                  and np.allclose(a.transform, b.transform, rtol=1e-6, atol=1e-5),
                  f"compat: card ({a.tmpl_idx}, {a.score}) vs CPU "
                  f"({b.tmpl_idx}, {b.score})")
            n += 1
    print(f"[compat] the reference integration test (L2, L1, L2²) through "
          f"openfdcm_tpu_torch.compat: assertions hold on the card and on the "
          f"CPU; {n} sorted matches equal (ids, scores; transforms atol 1e-5); "
          f"card {wall:.3f} s, launches {short(launches)}; CPU {wall_cpu:.3f} s")


def phase_profile_serving(banks, params, searcher, optimizer, penalty, device):
    """One more serving run of phase 15 under ``torch.profiler``: device
    busy share, launches, device time by kernel."""
    templates, scenes, _ = whole_bank(banks)
    svc = of.MatcherService(templates, params, searcher, optimizer, top_k=TOP_K,
                            penalty=penalty,
                            template_lengths=of.get_template_lengths(templates),
                            max_batch=16, device=device)
    try:
        svc.warmup(scenes[:2])
        reset_counts()
        d0 = svc.dispatches
        rows, wall = profiled(lambda: serve_once(svc, scenes))
        launches, _ = read_counts()
        n_disp = svc.dispatches - d0
    finally:
        svc.close()
    busy = sum(r[2] for r in rows)
    check(busy > 0, "serving profile: no device time was recorded")
    mine = {n: (sum(r[1] for r in rows if n in r[0]),
                round(sum(r[2] for r in rows if n in r[0]), 3))
            for n in PROFILE_NAMES if any(n in r[0] for r in rows)}
    print(f"[profile] serving, {len(scenes)} requests from 4 threads, "
          f"{n_disp} dispatches: wall {wall * 1e3:.3f} ms (profiled), device "
          f"busy {busy:.3f} ms ({busy / (wall * 1e3):.3f} of wall); launches "
          f"{short(launches)}; launches and ms by kernel name {mine}")
    for name, count, ms in rows[:8]:
        print(f"[profile] serving {ms:10.3f} ms {count:7d}x  {name[:100]}")


# ---------------------------------------------------------------------------
# the sharded paths on a mesh of entries of one card (phases 21-27)
# ---------------------------------------------------------------------------

def card_mesh(shape, axes, device):
    """A mesh over the visible cards, entry ``i`` on card ``i`` modulo their
    count.  On one card every entry names it and the shards run in turn:
    that shows the sharding is right, not that it scales."""
    from openfdcm_tpu_torch.parallel import make_mesh
    n, dev = int(np.prod(shape)), torch.device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    devices = [torch.device("cuda", i % cards) if dev.type == "cuda" else dev
               for i in range(n)]
    return make_mesh(shape, axes, devices=devices)


def sync_cards():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def timed(fn):
    """``(result, wall s, launches)`` of ``fn()``, the counts set to 0 just
    before it and read just after (every card synchronized)."""
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    sync_cards()
    wall = time.perf_counter() - t0
    return out, wall, read_counts()[0]


def mesh_line(tag, label, mesh, wall, wall_plain, launches):
    n, cards = mesh.devices.size, len(mesh.distinct())
    print(f"[{tag}] {label}: {wall:.4f} s on a mesh of {n} entries over "
          f"{cards} card(s), {wall_plain:.4f} s unsharded; launches "
          f"{short(launches)}")


def check_launched(launches, names, label):
    for name in names:
        check(launches[name] > 0, f"{label}: kernel {name} was not launched")


def phase_mesh_scene(banks, params, searcher, optimizer, penalty, device,
                     batch_ref):
    """A ``("scene", 4)`` mesh: bank 0's 10-scene build (padded to 12, three
    scenes a block) bit-equal to the unsharded build; ``match_many`` over
    each bank equal to the slice's rows; DefaultOptimize on bank 0 under
    generations 2 and 3 (K5, K6 on the shards) equal to the unsharded
    runs."""
    mesh = card_mesh((4,), ("scene",), device)
    templates, scenes, _ = banks[0]
    ref, wall_u, _ = timed(lambda: of.build_featuremap_batch(scenes, params,
                                                             device=device))
    sh, wall, launches = timed(lambda: of.build_featuremap_batch(scenes, params,
                                                                 mesh=mesh))
    n_bad = mismatches(sh.dt3, ref.dt3)
    check(n_bad == 0, f"scene mesh: the build differs in {n_bad} cells")
    for name in BUILD_KERNELS:
        check(launches[name] == 4,
              f"scene mesh: {name} launched {launches[name]} times")
    mesh_line("mesh scene", f"bank 0 build {tuple(sh.dt3.shape)}, bit-equal", mesh,
              wall, wall_u, launches)
    with generation(4):
        _, wall_u, _ = timed(lambda: run_slice(banks, params, searcher, optimizer,
                                               penalty, device, None))
        res, wall, launches = timed(lambda: run_slice(
            banks, params, searcher, optimizer, penalty, device, None, mesh=mesh))
        rows, wall_p = profiled(lambda: run_slice(
            banks, params, searcher, optimizer, penalty, device, None, mesh=mesh))
    check_path_launches(launches, 4, "scene mesh match_many")
    n = same_lists(res, batch_ref, "scene mesh match_many vs the slice")
    mesh_line("mesh scene", f"match_many over the {len(banks)} banks, {n} "
              f"top-{TOP_K} rows equal the slice's", mesh, wall, wall_u, launches)
    busy = sum(r[2] for r in rows)
    print(f"[mesh scene] profiled: wall {wall_p * 1e3:.3f} ms, device busy "
          f"{busy:.3f} ms ({busy / (wall_p * 1e3):.3f} of wall)")
    for version in (2, 3):
        with generation(version):
            want, wall_u, _ = timed(lambda: run_slice(
                banks[:1], params, searcher, of.DefaultOptimize(), penalty,
                device, None))
            got, wall, launches = timed(lambda: run_slice(
                banks[:1], params, searcher, of.DefaultOptimize(), penalty,
                device, None, mesh=mesh))
        check_path_launches(launches, version, f"scene mesh, generation {version}")
        n = same_lists(got, want, f"scene mesh, generation {version}")
        mesh_line("mesh scene", f"DefaultOptimize, generation {version}, bank 0, "
                  f"{n} rows equal", mesh, wall, wall_u, launches)


def phase_mesh_cand(banks, params, searcher, optimizer, penalty, device):
    """A ``("cand", 4)`` mesh: one bank-0 scene's ``search`` with its
    candidates in four blocks equals the unsharded single-scene search."""
    mesh = card_mesh((4,), ("cand",), device)
    templates, scenes, _ = banks[0]
    bank, _ = make_bank(templates, device)
    fm = of.build_featuremap(scenes[0], params, device=device)
    with generation(4):
        want, wall_u, _ = timed(lambda: of.search(of.DefaultMatch(), searcher,
                                                  optimizer, fm, bank, scenes[0]))
        got, wall, launches = timed(lambda: of.search(
            of.DefaultMatch(), searcher, optimizer, fm, bank, scenes[0], mesh=mesh))
    check_launched(launches, SEARCH_KERNELS[4], "cand mesh search")
    n = same_lists([[got]], [[want]], "cand mesh search vs search")
    mesh_line("mesh cand", f"search of bank-0 scene 0, {n} matches equal", mesh,
              wall, wall_u, launches)


def phase_mesh_optimize(banks, params, searcher, optimizer, penalty, device):
    """A ``("scene", 2) x ("cand", 2)`` mesh: ``optimize_candidates_sharded_batch``
    on two bank-0 scenes' real candidates equals the unsharded kernel call,
    and so does ``topk_candidates`` on its scores.  Returns the call's
    inputs (for the two-process phase) and scene 0's scores and validity
    (for the ``global_topk`` phases)."""
    from openfdcm_tpu_torch.matching.match import _bucket, _scene_candidates
    from openfdcm_tpu_torch.matching.optimize_kernel import \
        optimize_candidates_batch_kernel
    from openfdcm_tpu_torch.matching.pipeline import _bank_pairs_for_scene
    from openfdcm_tpu_torch.parallel import (optimize_candidates_sharded_batch,
                                             topk_candidates)
    mesh = card_mesh((2, 2), ("scene", "cand"), device)
    templates, scenes, _ = banks[0]
    bank, _ = make_bank(templates, device)
    two = scenes[:2]
    fms = of.build_featuremap_batch(two, params, device=device)
    pairs = [_bank_pairs_for_scene(searcher, bank, s) for s in two]
    pb = _bucket(max(p.shape[0] for p in pairs), 64)
    lines, mask, align, _, ok = (torch.stack(x) for x in zip(
        *[_scene_candidates(bank, p, s, pb) for p, s in zip(pairs, two)]))
    mode, window = opt_mod.optimizer_mode(optimizer)
    fs = torch.tensor([[float(w), float(h)] for w, h in fms.feature_sizes],
                      device=fms.dt3.device)
    kw = dict(mode=mode, window=max(window, 1), cand_ok=ok,
              dense_steps=opt_mod.dense_step_count(optimizer, int(fs.max())))
    s_count, _, ph, pw = fms.dt3.shape
    with generation(4):
        want, wall_u, _ = timed(lambda: optimize_candidates_batch_kernel(
            fms.dt3, fms.angles, fms.scene_translations, fs, lines, mask, align,
            **kw))
        got, wall, launches = timed(lambda: optimize_candidates_sharded_batch(
            mesh, fms.dt3.reshape(s_count, -1), fms.angles,
            fms.scene_translations, (ph, pw), fs, lines, mask, align, **kw))
    check_launched(launches, SEARCH_KERNELS[4], "2-D optimize")
    bad = [mismatches(g, w) for g, w in zip(got, want)]
    check(bad == [0, 0, 0], f"2-D optimize: mismatches (scores, translations, "
          f"valid) {bad}")
    for i in range(s_count):
        a = topk_candidates(got[0][i], got[2][i] & ok[i], TOP_K)
        b = topk_candidates(want[0][i], want[2][i] & ok[i], TOP_K)
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"2-D optimize: scene {i}'s top-{TOP_K} differs")
    mesh_line("mesh optimize", f"2 scenes x {lines.shape[1]} candidates "
              f"({int((got[2] & ok).sum())} valid), scores, translations, "
              f"validity and top-{TOP_K} equal", mesh, wall, wall_u, launches)
    case = dict(dt3_flat=fms.dt3.reshape(s_count, -1), angles=fms.angles,
                scene_tr=fms.scene_translations, hw=(ph, pw), fs=fs,
                lines=lines, mask=mask, align=align, kw=kw)
    return case, got[0][0], got[2][0] & ok[0]


def sorted_rows(res):
    """Each scene's matches in a stable order by (score, template id): the
    bank-sharded path ranks equal scores by its own candidate index."""
    return [[sorted(ms, key=lambda m: (m.score, m.tmpl_idx)) for ms in res]]


def phase_mesh_bank(banks, params, searcher, optimizer, penalty, device, ref,
                    wall_u):
    """A ``("scene", 2) x ("bank", 2)`` mesh: ``match_many_bank_sharded``
    on the whole 420-template bank, each bank shard's tables uploaded to its
    entry, equals the whole-bank rows (``ref``)."""
    from openfdcm_tpu_torch.parallel import match_many_bank_sharded
    mesh = card_mesh((2, 2), ("scene", "bank"), device)
    templates, scenes, _ = whole_bank(banks)
    with generation(4):
        res, wall, launches = timed(lambda: match_many_bank_sharded(
            scenes, templates, params, searcher, optimizer, mesh=mesh,
            top_k=TOP_K, penalty=penalty,
            template_lengths=of.get_template_lengths(templates)))
    check_path_launches(launches, 4, "bank mesh")
    n = same_lists(sorted_rows(res), sorted_rows(ref),
                   "bank-sharded vs whole-bank match_many")
    ties = sum(len({m.score for m in ms}) < len(ms) for ms in ref)
    mesh_line("mesh bank", f"{len(scenes)} scenes x {len(templates)} templates, "
              f"{n} rows equal the whole-bank rows by (score, template) "
              f"({ties} scenes hold equal scores)", mesh, wall, wall_u, launches)


def phase_mesh_rows(banks, params, searcher, optimizer, penalty, device):
    """A ``("rows", 4)`` mesh: one bank-0 scene built in four row blocks
    (K2 and K3 per block) bit-equal to ``build_featuremap`` on the logical
    region; ``search_spatial`` against bank 0, every probe read through the
    blocks, equal to ``search``."""
    from openfdcm_tpu_torch.parallel import build_featuremap_spatial, search_spatial
    mesh = card_mesh((4,), ("rows",), device)
    templates, scenes, _ = banks[0]
    bank, _ = make_bank(templates, device)
    ref, wall_u, _ = timed(lambda: of.build_featuremap(scenes[0], params,
                                                       device=device))
    sp, wall, launches = timed(lambda: build_featuremap_spatial(
        scenes[0], params, mesh=mesh))
    w, h = ref.feature_size
    n_bad = mismatches(sp.dt3.gather()[:, :h, :w], ref.dt3[:, :h, :w])
    check(n_bad == 0 and sp.feature_size == ref.feature_size,
          f"row mesh: the build differs in {n_bad} cells")
    for name in ("K2_minplus_rows", "K3_propagate_orientation"):
        check(launches[name] == 4,
              f"row mesh: {name} launched {launches[name]} times")
    mesh_line("mesh rows", f"build of bank-0 scene 0, {len(sp.dt3.blocks)} blocks "
              f"of {tuple(sp.dt3.blocks[0].shape)}, bit-equal on {h} x {w}", mesh,
              wall, wall_u, launches)
    with generation(4):
        want, wall_u, _ = timed(lambda: of.search(of.DefaultMatch(), searcher,
                                                  optimizer, ref, bank, scenes[0]))
        got, wall, launches = timed(lambda: search_spatial(
            searcher, optimizer, sp, bank, scenes[0], mesh=mesh))
    n = same_lists([[got]], [[want]], "search_spatial vs search")
    mesh_line("mesh rows", f"search_spatial against bank 0, {n} matches equal "
              f"(its windows in K1's arithmetic through the blocks)", mesh, wall,
              wall_u, launches)


def phase_mesh_serving_sweep(banks, params, searcher, optimizer, penalty, device,
                             ref, serve_wall, sweep_wall, tmpl_paths, root):
    """``MatcherService(mesh=("scene", 4))`` answering the 40 scenes from 4
    threads, and ``resumable_sweep(mesh=...)`` killed on its third chunk and
    resumed: each equal to the whole-bank rows."""
    from openfdcm_tpu_torch import sweep as sweep_mod
    mesh = card_mesh((4,), ("scene",), device)
    templates, scenes, _ = whole_bank(banks)
    lengths = of.get_template_lengths(templates)
    svc = of.MatcherService(templates, params, searcher, optimizer, top_k=TOP_K,
                            penalty=penalty, template_lengths=lengths,
                            max_batch=16, mesh=mesh)
    try:
        svc.warmup(scenes[:2])
        d0 = svc.dispatches
        (results, lat, wall), _, launches = timed(lambda: serve_once(svc, scenes))
        n_disp = svc.dispatches - d0
    finally:
        svc.close()
    check_path_launches(launches, 4, "meshed serving")
    n = same_lists([results], [ref], "meshed serving vs whole-bank match_many")
    mesh_line("mesh serving", f"{len(scenes)} requests from 4 threads, {n_disp} "
              f"dispatches, every answer equals the whole-bank row ({n} rows), "
              f"{len(scenes) / wall:.3f} requests/s, latency median "
              f"{np.median(lat) * 1e3:.1f} ms", mesh, wall, serve_wall, launches)

    state_dir = os.path.join(root, "mesh_sweep_state")
    kw = dict(top_k=TOP_K, state_dir=state_dir, penalty=penalty,
              template_lengths=lengths, chunk_size=len(banks[0][0]), mesh=mesh)
    real, calls = sweep_mod.match_many, []

    class Killed(RuntimeError):
        pass

    def dying(*a, **k):
        calls.append(k.get("mesh"))
        if len(calls) == 3:
            raise Killed("killed on the third chunk")
        return real(*a, **k)
    sweep_mod.match_many = dying
    try:
        of.resumable_sweep(scenes, tmpl_paths, params, searcher, optimizer, **kw)
        killed = False
    except Killed:
        killed = True
    finally:
        sweep_mod.match_many = real
    state = of.SweepState.load(state_dir)
    check(killed and state is not None and state.done_chunks == 2
          and all(m is mesh for m in calls), "meshed sweep: not killed on chunk 3")
    res, wall, launches = timed(lambda: of.resumable_sweep(
        scenes, tmpl_paths, params, searcher, optimizer, **kw))
    check_path_launches(launches, 4, "meshed sweep")
    n = same_lists([res], [ref], "meshed resumed sweep vs whole-bank match_many")
    mesh_line("mesh sweep", f"killed on chunk 3 (checkpoint 2), resumed: equals "
              f"the whole-bank rows ({n} rows)", mesh, wall, sweep_wall, launches)


def phase_mesh_global_topk(scores, valid, device):
    """``global_topk`` on a ``("cand", 4)`` mesh over real candidate scores
    equals ``topk_candidates`` on the whole row; returns it."""
    from openfdcm_tpu_torch.parallel import global_topk, topk_candidates
    mesh = card_mesh((4,), ("cand",), device)
    want, wall_u, _ = timed(lambda: topk_candidates(scores, valid, TOP_K))
    got, wall, launches = timed(lambda: global_topk(mesh, scores, valid, TOP_K))
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "global_topk differs from topk_candidates")
    mesh_line("mesh topk", f"global_topk of {scores.shape[0]} scores "
              f"({int(valid.sum())} valid) equals topk_candidates", mesh, wall,
              wall_u, launches)
    return got


# ---------------------------------------------------------------------------
# a mesh over two processes on one card (phase 31, run after phase 27)
# ---------------------------------------------------------------------------

RANKS = 2


def mesh_rank(rank, init_file, work, device):
    """One rank of phase 31, in a spawned process that imports only torch,
    numpy and the port: joins a gloo group of ``RANKS`` through
    ``parallel.initialize``, runs ``optimize_candidates_sharded_batch`` on
    a ``("scene", 2) x ("cand", 2)`` mesh whose row ``r`` is rank ``r``'s
    (two ``cuda:0`` entries each) under generations 4, 2 and 3, each run
    with this process's counts set to 0 just before it and read just
    after, then ``global_topk`` on a ``("cand", 4)`` mesh over the ranks;
    ``device`` names the card (``cuda:0``).  Writes ``rank<r>.pt``, or
    ``rank<r>.err`` and exits 1."""
    from openfdcm_tpu_torch.parallel import (global_topk, initialize, make_mesh,
                                             optimize_candidates_sharded_batch)
    try:
        initialize(f"file://{init_file}", RANKS, rank, backend="gloo")
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        x = {k: v.to(dev) if torch.is_tensor(v) else v
             for k, v in torch.load(os.path.join(work, "inputs.pt")).items()}
        x["kw"]["cand_ok"] = x["kw"]["cand_ok"].to(dev)
        entries = [(r, dev) for r in range(RANKS) for _ in range(2)]
        mesh = make_mesh((2, 2), ("scene", "cand"), devices=entries)
        args = (x["dt3_flat"], x["angles"], x["scene_tr"], x["hw"], x["fs"],
                x["lines"], x["mask"], x["align"])
        out = {}
        with generation(4):                 # warm-up: library load, context
            optimize_candidates_sharded_batch(mesh, *args, **x["kw"])
        for version in (4, 2, 3):
            with generation(version):
                reset_counts()
                t0 = time.perf_counter()
                res = optimize_candidates_sharded_batch(mesh, *args, **x["kw"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = read_counts()[0]
            out[version] = dict(wall=wall, launches=launches, shards=[
                [([[i.start, i.stop] for i in sh.index], sh.data.cpu(), str(sh.device))
                 for sh in r.addressable_shards] for r in res])
        cand = make_mesh((2 * RANKS,), ("cand",), devices=entries)
        out["topk"] = [t.cpu() for t in global_topk(cand, x["scores"], x["valid"],
                                                      TOP_K)]
        out["jax"] = [m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "openfdcm_tpu")]
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    except Exception:
        with open(os.path.join(work, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def phase_mesh_processes(case, scores, valid, topk, device, timeout=600):
    """Phase 31: phase 23's two-scene optimize on a mesh over ``RANKS``
    spawned processes on one card (gloo through host memory; NCCL refuses
    two ranks on one card), against the single-process port: every shard
    bit-equal to the unsharded kernel call's rows under generations 4, 2
    and 3, K1 and the tile copy (K5, K6 under generations 2, 3) launched in
    each rank's process, ``global_topk`` over the ranks equal to phase
    27's; each rank's wall beside the single-process meshed wall (two
    processes on one card: a cost, not a scaling)."""
    import multiprocessing
    from openfdcm_tpu_torch.matching.optimize_kernel import \
        optimize_candidates_batch_kernel
    from openfdcm_tpu_torch.parallel import optimize_candidates_sharded_batch
    s_count, c = case["mask"].shape[:2]
    li = case["dt3_flat"].reshape(s_count, -1, *case["hw"])
    args = (case["angles"], case["scene_tr"], case["fs"], case["lines"],
            case["mask"], case["align"])
    mesh = card_mesh((2, 2), ("scene", "cand"), device)
    want, mesh_wall = {}, {}
    for version in (4, 2, 3):
        with generation(version):
            want[version] = optimize_candidates_batch_kernel(li, *args, **case["kw"])
            _, mesh_wall[version], _ = timed(lambda: optimize_candidates_sharded_batch(
                mesh, case["dt3_flat"], case["angles"], case["scene_tr"],
                case["hw"], case["fs"], *args[3:], **case["kw"]))
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as work:
        torch.save({**{k: v.cpu() if torch.is_tensor(v) else v
                       for k, v in case.items()},
                    "kw": {**case["kw"], "cand_ok": case["kw"]["cand_ok"].cpu()},
                    "scores": scores.cpu(), "valid": valid.cpu()},
                   os.path.join(work, "inputs.pt"))
        t0 = time.perf_counter()
        procs = [ctx.Process(target=mesh_rank,
                             args=(r, os.path.join(work, "rendezvous"), work,
                                   str(case["lines"].device)))
                 for r in range(RANKS)]
        try:
            for proc in procs:
                proc.start()
            for proc in procs:
                proc.join(max(0.0, t0 + timeout - time.perf_counter()))
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        spawn_wall = time.perf_counter() - t0
        for r, proc in enumerate(procs):
            err = os.path.join(work, f"rank{r}.err")
            why = open(err).read() if os.path.exists(err) else "no traceback"
            check(proc.exitcode == 0, f"mesh over processes: rank {r} exited "
                  f"with {proc.exitcode}:\n{why}")
        seen = [torch.load(os.path.join(work, f"rank{r}.pt")) for r in range(RANKS)]
    for r, rec in enumerate(seen):
        check(rec["jax"] == [], f"rank {r} imported {rec['jax']}")
        for version in (4, 2, 3):
            got = rec[version]
            for out, sh in zip(want[version], got["shards"]):
                check([ix[0] for ix, _, _ in sh] == [[r, r + 1]] * 2,
                      f"rank {r} holds rows {[ix[0] for ix, _, _ in sh]}")
                for index, data, _ in sh:
                    at = tuple(slice(a, b) for a, b in index)
                    n_bad = mismatches(data, out[at].cpu())
                    check(n_bad == 0, f"rank {r}, generation {version}: a shard "
                          f"at {index} differs in {n_bad} cells")
            check_launched(got["launches"], SEARCH_KERNELS[version],
                           f"rank {r}, generation {version}")
            print(f"[mesh processes] rank {r} of {RANKS}, generation {version}: "
                  f"{got['wall']:.4f} s for its 2 blocks of {c // 2} candidates "
                  f"(scene {r}), single-process meshed wall "
                  f"{mesh_wall[version]:.4f} s; shards bit-equal; launches "
                  f"{short(got['launches'])}")
        check(all(torch.equal(a, b.cpu()) for a, b in zip(rec["topk"], topk)),
              f"rank {r}: global_topk over the ranks differs from phase 27's")
    print(f"[mesh processes] {RANKS} ranks on one card (gloo, host-staged): "
          f"global_topk of {scores.shape[0]} scores equal on every rank to "
          f"phase 27's; ranks spawned, run and joined in {spawn_wall:.1f} s; "
          f"no JAX in the ranks")


# ---------------------------------------------------------------------------
# the rest of the JAX package's surface
# ---------------------------------------------------------------------------

def photo_scene(seed, n=400, w=1920, h=1080):
    """A synthetic photographed scene made from ``seed``: ``n`` lines of
    10-200 px at random angles centred on a ``w x h`` canvas."""
    rng = np.random.default_rng([seed, w, h])
    c = rng.uniform(0, 1, (n, 2)) * (w, h)
    ang = rng.uniform(0, np.pi, n)
    half = rng.uniform(10.0, 200.0, n)[:, None] / 2
    d = np.stack([np.cos(ang), np.sin(ang)], -1) * half
    return np.concatenate([c - d, c + d], -1).astype(np.float32)


def wall_of(fn):
    """``(result, wall s)`` of ``fn()``, the card synchronized."""
    sync_cards()
    t0 = time.perf_counter()
    out = fn()
    sync_cards()
    return out, time.perf_counter() - t0


def phase_core_api(banks, device, seed):
    """The single-image API on the card against the CPU, bit for bit:
    ``distance_transform`` (L1, L2, L2²; one K2 launch per L2/L2² call) of
    bank 0's scene 0 on 640 x 640 and of a 1920 x 1080 scene of 400 lines;
    ``line_integral`` (one K4 launch each, the input unchanged) of the 30
    DT3 angles over the 640² L2 DT and of 4 edge angles over the 1920 x 1080
    one; ``closest_orientation_idx`` on 1M thetas; ``propagate_orientation
    (dt3, wmat)`` on scene 0's 30 x 640² per-orientation DTs, with its
    largest difference from K3's relaxation printed."""
    from openfdcm_tpu_torch.core import dt as core_dt
    from openfdcm_tpu_torch.core import integral as core_integral
    scenes = {"640x640": (banks[0][1][0], (640, 640)),
              "1920x1080": (photo_scene(seed), (1920, 1080))}
    dts = {}
    for label, (lines, size) in scenes.items():
        for metric in (of.Distance.L1, of.Distance.L2, of.Distance.L2_SQUARED):
            got, wall, launches = timed(lambda: core_dt.distance_transform(
                lines, size, metric, device=device))
            k2 = int(metric != of.Distance.L1)
            check(launches["K2_minplus_rows"] == k2,
                  f"core-api: distance_transform {label} {metric.name} launched "
                  f"K2 {launches['K2_minplus_rows']} times, not {k2}")
            want, wall_cpu = wall_of(lambda: core_dt.distance_transform(
                lines, size, metric, device="cpu"))
            n_bad = mismatches(got, want)
            check(got.shape == (size[1], size[0]) and n_bad == 0,
                  f"core-api: distance_transform {label} {metric.name}: "
                  f"{n_bad} pixels differ from the CPU")
            print(f"[core-api] distance_transform {label} {metric.name}: "
                  f"{len(lines)} lines, bit-equal to the CPU, {wall * 1e3:.3f} ms "
                  f"(CPU {wall_cpu * 1e3:.3f} ms), K2 launches {k2}")
            if metric == of.Distance.L2:
                dts[label] = got
        rows, wall = profiled(lambda: core_dt.distance_transform(
            lines, size, of.Distance.L2, device=device))
        busy = sum(r[2] for r in rows)
        top = ", ".join(f"{n[:40]} {c}x {ms:.3f} ms" for n, c, ms in rows[:4])
        print(f"[core-api] profile distance_transform {label} L2: wall "
              f"{wall * 1e3:.3f} ms, device busy {busy:.3f} ms over "
              f"{sum(r[1] for r in rows)} kernel launches; top: {top}")
    angle_sets = {"640x640": [float(a) for a in fm_mod.make_angles(30)],
                  "1920x1080": [0.0, np.pi / 2, -np.pi / 2, np.pi / 2 - 1e-6]}
    for label, angles in angle_sets.items():
        img = dts[label]
        before, host = img.clone(), img.cpu()
        walls, n_k4 = [], 0
        for angle in angles:
            got, wall, launches = timed(lambda: core_integral.line_integral(img, angle))
            n_k4 += launches["K4_sweep_stack"]
            walls.append(wall)
            n_bad = mismatches(got, core_integral.line_integral(host, angle))
            check(n_bad == 0, f"core-api: line_integral {label} at {angle}: "
                  f"{n_bad} cells differ from the CPU")
        check(n_k4 == len(angles), f"core-api: {n_k4} K4 launches for "
              f"{len(angles)} line integrals")
        check(mismatches(img, before) == 0, "core-api: line_integral changed its input")
        print(f"[core-api] line_integral {label}: {len(angles)} angles, each "
              f"bit-equal to the CPU, input unchanged, K4 launches {n_k4}, wall "
              f"{np.median(walls) * 1e3:.3f} ms median, {max(walls) * 1e3:.3f} ms max")
    angles = fm_mod.make_angles(30)
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-2 * np.pi, 2 * np.pi, 1_000_000).astype(np.float32)
    theta[::1000] = np.nan
    theta[1::1000] = np.repeat(angles, 34)[:1000]
    dev_theta = torch.as_tensor(theta, device=device)
    got, wall = wall_of(lambda: fm_mod.closest_orientation_idx(angles, dev_theta))
    n_bad = mismatches(got, fm_mod.closest_orientation_idx(angles, torch.as_tensor(theta)))
    check(n_bad == 0, f"core-api: closest_orientation_idx: {n_bad} indices differ")
    print(f"[core-api] closest_orientation_idx: {theta.size} thetas "
          f"({int(np.isnan(theta).sum())} NaN), identical to the CPU, "
          f"{wall * 1e3:.3f} ms")
    lines, size = scenes["640x640"]
    slice_of = fm_mod.classify_lines(angles, torch.as_tensor(lines)).numpy()
    dt3 = torch.stack([core_dt.distance_transform(lines[slice_of == j], size,
                                                  device=device)
                       for j in range(len(angles))])
    wmat = fm_mod.propagation_weights(angles, 5.0)
    got, wall = wall_of(lambda: fm_mod.propagate_orientation(dt3, wmat))
    n_bad = mismatches(got, fm_mod.propagate_orientation(dt3.cpu(), wmat))
    check(n_bad == 0, f"core-api: propagate_orientation: {n_bad} cells differ")
    relax = fm_mod.propagate_orientation_relax(
        dt3.clone(), fm_mod.propagation_steps(angles, 5.0))
    print(f"[core-api] propagate_orientation(dt3, wmat) on {tuple(dt3.shape)}: "
          f"bit-equal to the CPU, {wall * 1e3:.3f} ms; largest difference from "
          f"K3's relaxation {max_abs_err(got, relax):.6g} "
          f"({mismatches(got, relax)} cells differ)")


def phase_optimize_api(banks, params, searcher, device):
    """``optimize_candidates`` on bank-0 scene 0's candidates (every pair
    of the bank padded to a multiple of 64, both polarities) under
    DefaultOptimize, IndulgentOptimize, BatchOptimize(10) and DenseOptimize
    at generation 4, and DefaultOptimize under generations 2 and 3: per run
    the valid rows (template, score, transform) equal ``search``'s for the
    scene bit for bit, and the generation's window kernel is launched."""
    from openfdcm_tpu_torch.matching.match import _bucket, _scene_candidates
    templates, scenes, _ = banks[0]
    bank, _ = make_bank(templates, device)
    fm = of.build_featuremap(scenes[0], params, device=device)
    pairs = pipeline_mod._bank_pairs_for_scene(searcher, bank, scenes[0])
    lines, mask, align, transforms, _ = _scene_candidates(
        bank, pairs, scenes[0], _bucket(pairs.shape[0], 64))
    w, h = fm.feature_size
    runs = [(4, of.DefaultOptimize()), (4, of.IndulgentOptimize()),
            (4, of.BatchOptimize(10)), (4, of.DenseOptimize()),
            (2, of.DefaultOptimize()), (3, of.DefaultOptimize())]
    for version, optimizer in runs:
        mode, window = opt_mod.optimizer_mode(optimizer)
        with generation(version):
            out, wall, launches = timed(lambda: opt_mod.optimize_candidates(
                fm.dt3.reshape(-1), fm.angles, fm.scene_translation,
                fm.dt3.shape[1:], np.float32([w, h]), lines, mask, align,
                mode=mode, window=max(window, 1),
                dense_steps=opt_mod.dense_step_count(optimizer, max(w, h))))
            want, wall_search, _ = timed(lambda: of.search(
                of.DefaultMatch(), searcher, optimizer, fm, bank, scenes[0]))
        kernel = "K1_window_scores" if mode == "dense" else WINDOW_KERNEL[version]
        check_launched(launches, (kernel, "K1_tile_stack"),
                       f"optimize-api {type(optimizer).__name__} gen {version}")
        scores, trans, valid = (x.cpu().numpy() for x in out)
        mats = transforms.cpu().numpy().copy()
        mats[..., 2] += trans
        got = [of.Match(int(pairs[j // 2, 0]), float(scores[j]), mats[j])
               for j in range(2 * pairs.shape[0]) if valid[j]]
        n = same_lists([[got]], [[want]], f"optimize-api {type(optimizer).__name__} "
                       f"gen {version} vs search")
        print(f"[optimize-api] {type(optimizer).__name__}, generation {version}: "
              f"{lines.shape[0]} candidates, {n} valid rows equal search's, "
              f"{wall * 1e3:.3f} ms (search {wall_search * 1e3:.3f} ms); "
              f"launches {short(launches)}")


def phase_native(banks, root, tmpl_paths, scene_paths):
    """The native runtime against its plain versions: the 460 line files
    through ``read_batch`` on 8 threads, file by file; each written again
    with the native codec and read back by both; DefaultSearch pairs of
    every template of the whole bank against every scene."""
    from openfdcm_tpu_torch import native
    from openfdcm_tpu_torch.matching import search as search_mod
    paths = tmpl_paths + scene_paths
    got, wall = wall_of(lambda: of.io.read_batch(paths, num_threads=8))
    want, wall_plain = wall_of(lambda: of.io.read_batch_plain(paths, num_threads=8))
    check(all(a.tobytes() == b.tobytes() for a, b in zip(got, want, strict=True)),
          "native: read_batch differs from the plain reader")
    out_dir = os.path.join(root, "native_round_trip")
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    for i, arr in enumerate(got):
        of.io.write(os.path.join(out_dir, f"{i:03d}.lines"), arr)
    wrote = time.perf_counter() - t0
    for i, arr in enumerate(got):
        path = os.path.join(out_dir, f"{i:03d}.lines")
        check(of.read(path).tobytes() == arr.tobytes()
              == of.io.read_plain(path).tobytes(), f"native: {path} round trip")
    print(f"[native] {len(paths)} line files: read_batch (8 threads) "
          f"{wall * 1e3:.3f} ms, plain (8 threads) {wall_plain * 1e3:.3f} ms, equal "
          f"file by file; native write {wrote * 1e3:.3f} ms, round trip exact "
          f"through both readers")
    templates, scenes, _ = whole_bank(banks)
    t_len = [search_mod._lengths(t) for t in templates]
    s_len = [search_mod._lengths(s) for s in scenes]
    calls = [(t, s, np.arange(s.size)) for s in s_len for t in t_len]
    nat, wall = wall_of(lambda: [search_mod._pair_by_length(t, s, i, 4, 10)
                                 for t, s, i in calls])
    plain, wall_plain = wall_of(lambda: [search_mod._pair_by_length_plain(
        t, s, i, 4, 10) for t, s, i in calls])
    check(all(np.array_equal(a, b) for a, b in zip(nat, plain, strict=True)),
          "native: DefaultSearch pairs differ from the plain ones")
    print(f"[native] DefaultSearch(4, 10) pairs of {len(templates)} templates x "
          f"{len(scenes)} scenes ({sum(len(p) for p in nat)} pairs): native "
          f"{wall * 1e3:.3f} ms, plain {wall_plain * 1e3:.3f} ms, equal; library "
          f"{native.library_path().name}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = "cuda"
    card = phase_device()
    phase_build()
    banks = make_workload(args.seed)
    params = of.Dt3Params(30, 5.0, 1.0, of.Distance.L2)
    searcher = of.DefaultSearch(4, 10)
    optimizer = of.BatchOptimize(10)
    penalty = of.ExponentialPenalty(1.5)
    cfg = (params, searcher, optimizer, penalty, device)
    report, cases = phase_kernels(banks, *cfg)
    phase_ieee(device)
    phase_small_reference(banks, *cfg)
    launches, batch_ref = phase_slice(banks, *cfg)
    by_gen = phase_generations(banks, params, searcher, penalty, device,
                               batch_ref)
    phase_dense(banks, params, searcher, penalty, device, batch_ref)
    phase_concentric(banks, params, penalty, device, batch_ref)
    phase_host_ranking(banks, params, searcher, penalty, device, batch_ref)
    phase_single_scene(banks, params, searcher, penalty, device, batch_ref)
    phase_template_chunks(banks, params, searcher, penalty, device, batch_ref)
    with generation(4):
        phase_profile(banks, *cfg, report)
        with tempfile.TemporaryDirectory() as root:
            tdir, sdir, tmpl_paths, scene_paths = phase_files(banks, root)
            ref, bank_wall = phase_whole_bank(banks, *cfg)
            serve_wall = phase_serving(banks, *cfg, ref)
            sweep_wall = phase_sweep(banks, *cfg, ref, tmpl_paths, root)
            phase_cli(banks, ref, tdir, sdir, scene_paths, root, device)
            phase_mesh_scene(banks, *cfg, batch_ref)
            phase_mesh_cand(banks, *cfg)
            opt_case, scores, valid = phase_mesh_optimize(banks, *cfg)
            phase_mesh_bank(banks, *cfg, ref, bank_wall)
            phase_mesh_rows(banks, *cfg)
            phase_mesh_serving_sweep(banks, *cfg, ref, serve_wall, sweep_wall,
                                     tmpl_paths, root)
            topk = phase_mesh_global_topk(scores, valid, device)
            phase_mesh_processes(opt_case, scores, valid, topk, device)
            phase_native(banks, root, tmpl_paths, scene_paths)
        phase_pose(banks, *cfg, args.seed)
        phase_compat(device)
        phase_profile_serving(banks, *cfg)
    phase_core_api(banks, device, args.seed)
    phase_optimize_api(banks, params, searcher, device)
    # each kernel's count from the run of the path it serves
    launches["K5_window_v2"] = by_gen[2]["K5_window_v2"]
    launches["K6_window_v3"] = by_gen[3]["K6_window_v3"]
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], **report[name])
               for name, (_, _, src, rep) in KERNELS.items()]
    for k in kernels:
        lib = (f"one PyTorch call {k['library_ms']:.4f} ms" if k["library_ms"]
               else "no single PyTorch call computes its function")
        print(f"[kernels] {k['name']}: {k['ms']:.4f} ms over its recorded "
              f"calls, bound {k['bound_ms']:.4f} ms ({k['bound_by']}), "
              f"{100 * k['bound_ms'] / k['ms']:.1f} % of bound, "
              f"{k['launches']} launches per main-path run; {lib}")
    print(json.dumps({"kernels": kernels}))
    print(f"[device] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)
