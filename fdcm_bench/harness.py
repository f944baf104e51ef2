"""One run of one benchmark cell: set-up, the measured window, the metrics
and the comparison with the plain reference.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration file (``configs/``), its traffic file
(``traffic/<traffic>.json``) and each metric's reader
(``metrics/<metric>.py``, a ``read(run)`` returning a number or None; a
metric with no file of its own is read by the file named by its name's
part before the first dot, so ``device_idle_pct.batch`` and
``device_idle_pct.latency`` share ``metrics/device_idle_pct.py``).
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "openfdcm_tpu")


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(spec: dict, workload: str, root: Path = ROOT):
    """``(cell, configuration entry, configuration, traffic)`` of a cell."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, entry, config, traffic


def metrics_of(spec: dict, cell: dict, trace: bool) -> list:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones: a
    per-layer metric with a ``workloads`` key in the cells it lists, one
    without in every cell that reports the end-to-end metric it moves."""
    name = cell["name"]
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "fdcm_bench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def banned_modules(names=None) -> list:
    """Top-level names among ``names`` (default: the loaded modules) that are
    JAX or the JAX package, each compared whole: ``openfdcm_tpu_torch`` is
    not ``openfdcm_tpu``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(BANNED))


def templates_of(inputs, traffic, bank: int) -> list:
    return inputs.banks[bank] if traffic["bank"] == "per_object" else inputs.whole_bank()


def sample(seed: int, done: list, traffic: dict) -> list:
    """Indices into ``done`` of the completed scenes the comparison checks,
    drawn from the seed and spread over where they ran.  Batch traffic:
    one pass of the window, and in each of its calls the first slot, the
    last and ``sample - 2`` drawn between, so a fault in one call, at
    either end of a batch or in half of it, shows.  Closed loop:
    ``sample`` requests, taken from the clients in turn."""
    rng = np.random.default_rng([seed, 0x53414D])
    if not done:
        return []
    n = traffic["sample"]
    if traffic["kind"] == "batch":
        per_pass = traffic["calls_per_pass"]
        p = int(rng.choice(sorted({d.call // per_pass for d in done})))
        picked = []
        for call in range(p * per_pass, (p + 1) * per_pass):
            slots = sorted((k for k, d in enumerate(done) if d.call == call),
                           key=lambda k: done[k].slot)
            if not slots:
                continue
            between = slots[1:-1]
            drawn = rng.choice(between, size=min(max(n - 2, 0), len(between)),
                               replace=False) if between else []
            picked += sorted({slots[0], slots[-1], *map(int, drawn)})
        return picked
    clients = traffic["clients"]
    own = [[k for k, d in enumerate(done) if d.client == c] for c in range(clients)]
    picked = []
    for j in range(n):
        left = [k for k in own[j % clients] if k not in picked]
        if left:
            picked.append(int(rng.choice(left)))
    return picked


def run_cell(spec, cell, config, traffic, *, seed: int, seconds: float,
             trace: bool, device, t0: float, log=print) -> dict:
    """Set up, measure, check.  Returns the result line's object.  Set-up
    is counted from ``t0``."""
    import torch
    import openfdcm_tpu_torch as of
    from openfdcm_tpu_torch.matching import optimize as program_optimize
    from openfdcm_tpu_torch.ops import build as program_build

    from . import compare, reference, workload
    from . import traffic as traffic_mod
    from .devtrace import Trace
    phases = [("import the port", time.perf_counter())]

    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    if cuda:
        torch.zeros(1, device=device)
        sync()
    phases.append(("CUDA context", time.perf_counter()))
    inputs = workload.make_inputs(config, seed, traffic["pool"])
    phases.append(("inputs", time.perf_counter()))
    n_banks = len(inputs.banks) if traffic["bank"] == "per_object" else 1
    banks = [of.prepare_templates(templates_of(inputs, traffic, b), device=device)
             for b in range(n_banks)]
    program = traffic_mod.Program(of, config, banks, device)
    driver = traffic_mod.DRIVERS[traffic["kind"]](traffic, program, inputs)
    sync()
    phases.append(("template banks", time.perf_counter()))
    if cuda:
        program_build.library()       # built by nvcc first in a fresh checkout
    phases.append(("kernel library", time.perf_counter()))
    driver.run(None, traffic.get("warm_rounds", 1))            # the warm pass
    sync()
    phases.append(("warm pass", time.perf_counter()))
    setup_s = phases[-1][1] - t0
    log("set-up s: " + ", ".join(f"{name} {t - prev:.3f}" for (name, t), prev
                                 in zip(phases, [t0] + [t for _, t in phases[:-1]])))

    if trace and traffic["kind"] == "batch":
        program.timer = of.StageTimer()
    syncs0 = program_optimize.host_sync.count
    dispatches0 = driver.svc.dispatches if getattr(driver, "svc", None) else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if trace:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA if cuda else torch.profiler.ProfilerActivity.CPU])
        prof.start()
    # no collection pauses in the window: set-up's objects frozen, the
    # collector off (the program's calls leave no reference cycles behind)
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        epoch0, perf0 = time.time_ns(), time.perf_counter_ns()
        record = driver.run(seconds)
        sync()
        epoch1 = time.time_ns()
        t_stop = time.perf_counter()
    finally:
        gc.enable()
        gc.unfreeze()
    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    t_read = time.perf_counter()
    run = SimpleNamespace(
        config=config, traffic=traffic, record=record, setup_s=setup_s,
        memory_peak_bytes=peak,
        trace=Trace(prof, epoch0, epoch1,
                    [(n, s - perf0 + epoch0, t - perf0 + epoch0) for n, s, t in record.spans])
        if prof is not None else None,
        stages=dict(program.timer.totals) if program.timer is not None else None,
        host_syncs=program_optimize.host_sync.count - syncs0,
        dispatches=(driver.svc.dispatches - dispatches0) if dispatches0 is not None else None)
    del prof                          # the trace's events, read
    t_metrics = time.perf_counter()
    values = {}
    for m in metrics_of(spec, cell, trace):
        v = reader(m["name"])(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if run.trace is not None:
        breakdown = {"device_ops": run.trace.device_ops(), "idle_gaps": run.trace.idle_gaps()}
        log(f"trace: {len(run.trace.ops)} device operations; s: profiler stop "
            f"{t_read - t_stop:.3f}, reading {t_metrics - t_read:.3f}, metrics and "
            f"breakdown {time.perf_counter() - t_metrics:.3f}")

    # the program's state goes before the reference runs
    driver.close()
    del driver, program, banks
    cycles = gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # every answer the window gave for a sampled scene is compared
    setting = reference.Setting.of(config)
    scenes = sorted({(record.done[k].pool, record.done[k].bank)
                     for k in sample(seed, record.done, traffic)})
    t_ref = time.perf_counter()
    per_answer = []
    for pool, bank in scenes:
        scene = inputs.scenes[pool]
        li, tr, size = reference.featuremap(scene, setting, device)
        rows = reference.match(li, tr, size, templates_of(inputs, traffic, bank),
                               scene, setting, device,
                               keep=setting.top_k + compare.TIE_ROWS)
        del li
        per_answer += [compare.scene_numbers(d.answer, rows, setting.top_k)
                       for d in record.done if d.pool == pool and d.bank == bank]
    numbers = compare.combine(per_answer)
    limits = config["limits"]
    correct = bool(compare.verdict(numbers, limits) and record.failed == 0 and per_answer)
    log(f"reference: {len(scenes)} scenes, {len(per_answer)} answers compared in "
        f"{time.perf_counter() - t_ref:.3f} s; window {record.seconds:.3f} s, "
        f"{len(record.done)} scenes, {record.failed} failed, {cycles} objects in "
        f"reference cycles{'; ' + record.errors[0] if record.errors else ''}")

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": record.attempted, "failed": record.failed,
           "metrics": values, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = breakdown
    out["compared"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return out


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec()
    cell, _, config, traffic = resolve(spec, args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 3
    # set-up starts here: the interpreter, torch and the driver are no part of it
    t0 = time.perf_counter()
    print(f"before set-up s: interpreter, torch import, device check {t0 - t_start:.3f}",
          file=sys.stderr)
    out = run_cell(spec, cell, config, traffic, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device="cuda:0", t0=t0,
                   log=lambda s: print(s, file=sys.stderr))
    found = banned_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 4
    for k, v in out["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
