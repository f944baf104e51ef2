"""Where the card waits: windows of one cell with the program's own spans
and counters recorded (``openfdcm_tpu_torch.profiling``), the device idle
time named by program spans and the device time charged to them
(:class:`.progtrace.ProgramTrace`), and the per-layer metrics that read
them.

    python3 fdcm_bench/split.py --workload <cell> --seed <n> --seconds <s> \\
        [--windows trace+spans trace plain spans]

Set-up is the harness's (inputs from the seed, banks, one warm pass); then
one window a word of ``--windows``, back to back in one process:
``plain`` (neither profiler nor spans, as a ``--trace 0`` run), ``spans``
(spans and counters only), ``trace`` (the device profiler only, as a
``--trace 1`` run) and ``trace+spans``; a traced window of a batch cell
passes a ``StageTimer``, as the harness's traced runs do.  No comparison
with the reference: ``run.py`` decides ``correct``.  Prints one
JSON object a window; the last line of standard output is the list.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from types import SimpleNamespace

# the metrics that read the program's spans and counters, by the
# end-to-end metric a cell reports
NEW_METRICS = {
    "scenes_per_s": ("walks_idle_pct.batch", "collect_idle_pct.batch",
                     "build_device_ms_per_scene"),
    "latency_p95_ms": ("walks_idle_pct.latency", "collect_idle_pct.latency",
                       "serve_wait_ms", "host_copies_per_scene.latency"),
}
# the DT3 build's kernels and the spans that should launch them
BUILD_KERNELS = {"edt_rows_kernel": "build.columns", "prop_fixed": "build.relax",
                 "sweep_paths_kernel": "build.integral"}
WINDOWS = ("plain", "spans", "trace", "trace+spans")


def measure(spec, cell, config, traffic, *, seed: int, seconds: float, windows,
            device="cuda:0", log=print) -> list:
    import torch
    import openfdcm_tpu_torch as of
    from openfdcm_tpu_torch import profiling

    from . import harness, workload
    from . import traffic as traffic_mod
    from .progtrace import ProgramTrace, shifted

    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    inputs = workload.make_inputs(config, seed, traffic["pool"])
    n_banks = len(inputs.banks) if traffic["bank"] == "per_object" else 1
    banks = [of.prepare_templates(harness.templates_of(inputs, traffic, b), device=device)
             for b in range(n_banks)]
    program = traffic_mod.Program(of, config, banks, device)
    load = traffic_mod.DRIVERS[traffic["kind"]](traffic, program, inputs)
    load.run(None, traffic.get("warm_rounds", 1))
    sync()
    e2e = [m["name"] for m in harness.metrics_of(spec, cell, False)
           if m["name"] not in ("setup_s", "device_peak_gib")]
    layer = [m["name"] for m in harness.metrics_of(spec, cell, True)]
    layer += [n for m in e2e for n in NEW_METRICS.get(m, ())]
    svc = getattr(load, "svc", None)
    results = []
    for mode in windows:
        traced, spans = mode in ("trace", "trace+spans"), mode in ("spans", "trace+spans")
        program.timer = of.StageTimer() if traced and traffic["kind"] == "batch" else None
        dispatches0 = svc.dispatches if svc is not None else None
        prof = None
        if traced:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA if cuda
                else torch.profiler.ProfilerActivity.CPU])
            prof.start()
        profiling.take_spans()
        counts0 = profiling.counts()
        profiling.record_spans(spans)
        gc.collect()
        gc.freeze()
        gc.disable()
        try:
            epoch0, perf0 = time.time_ns(), time.perf_counter_ns()
            record = load.run(seconds)
            sync()
            epoch1 = time.time_ns()
        finally:
            profiling.record_spans(False)
            gc.enable()
            gc.unfreeze()
        counts = {k: v - counts0.get(k, 0) for k, v in profiling.counts().items()}
        program_spans = profiling.take_spans()
        t_stop = time.perf_counter()
        if prof is not None:
            prof.stop()
        offset = epoch0 - perf0
        trace = (ProgramTrace(prof, epoch0, epoch1,
                              [(n, s + offset, t + offset) for n, s, t in record.spans],
                              shifted(program_spans, offset))
                 if prof is not None else None)
        del prof
        run = SimpleNamespace(
            config=config, traffic=traffic, record=record, setup_s=None,
            memory_peak_bytes=0, trace=trace, counts=counts if spans else None,
            stages=dict(program.timer.totals) if program.timer is not None else None,
            host_syncs=counts["host_sync.count"],
            dispatches=(svc.dispatches - dispatches0) if svc is not None else None)
        out = {"workload": cell["name"], "seed": seed, "window": mode,
               "timer": program.timer is not None, "scenes": len(record.done),
               "failed": record.failed, "spans": len(program_spans),
               "end_to_end": {m: harness.reader(m)(run) for m in e2e}}
        if trace is not None:
            out.update(
                busy_s=trace.busy_s, window_s=trace.window_s,
                device_ops=len(trace.ops), unlaunched=trace.unlaunched,
                per_layer={m: harness.reader(m)(run) for m in layer},
                idle_gaps=trace.idle_gaps(top=None), charged=trace.charge(),
                build_kernels={k: trace.charge_of([k]) for k in BUILD_KERNELS},
                trace_read_s=time.perf_counter() - t_stop)
        out["counts"] = {k: v for k, v in counts.items() if v}
        log(json.dumps(out))
        results.append(out)
    load.close()
    return results


def main(argv) -> int:
    from . import harness
    ap = argparse.ArgumentParser(description="Split one cell's device idle time by "
                                             "the program's spans.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--windows", nargs="+", choices=WINDOWS, default=["trace+spans"])
    args = ap.parse_args(argv)
    spec = harness.load_spec()
    cell, _, config, traffic = harness.resolve(spec, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    out = measure(spec, cell, config, traffic, seed=args.seed, seconds=args.seconds,
                  windows=args.windows, log=lambda s: print(s, file=sys.stderr, flush=True))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    import os
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from fdcm_bench import split
    sys.exit(split.main(sys.argv[1:]))
