"""The control of the comparison: the plain reference computed in bfloat16,
the precision below the configuration's float32, put in the program's
place and judged by the same numbers and limits as the program.

    python3 fdcm_bench/control.py --workload <cell> --seeds 11 12 13

For each seed: the cell's inputs, its sample of scenes drawn from the seed
by the run's own sampler (``harness.sample``) over the cell's first pass
(batch traffic) or its pool sent round the clients (closed loop), each
scene's float32 ranking and its bfloat16 ranking, and the numbers
``compare`` makes of them, one line per seed on standard output.  The
benchmark's own runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from types import SimpleNamespace

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from fdcm_bench import compare, harness, reference, workload  # noqa: E402
from fdcm_bench import traffic as traffic_mod  # noqa: E402


def as_answer(rows):
    """Reference rows in the shape of the program's ``Match`` objects."""
    return [SimpleNamespace(tmpl_idx=r.template, score=r.score, transform=r.transform)
            for r in rows]


def schedule(traffic, inputs) -> list:
    """What a window would record, without answers: the first pass of batch
    traffic, or the pool sent round the clients of a closed loop."""
    if traffic["kind"] == "batch":
        drv = traffic_mod.Batch(traffic, None, inputs)
        return [traffic_mod.Done(i, c if drv.per_object else 0, None, call=c, slot=j)
                for c in range(traffic["calls_per_pass"]) for j, i in enumerate(drv._take(c))]
    return [traffic_mod.Done(i, 0, None, client=i % traffic["clients"])
            for i in range(len(inputs.scenes))]


def numbers(config, traffic, seed, device, dtype=torch.bfloat16) -> dict:
    inputs = workload.make_inputs(config, seed, traffic["pool"])
    setting = reference.Setting.of(config)
    done = schedule(traffic, inputs)
    per_scene = []
    for pool, bank in sorted({(done[k].pool, done[k].bank)
                              for k in harness.sample(seed, done, traffic)}):
        scene = inputs.scenes[pool]
        templates = harness.templates_of(inputs, traffic, bank)
        li, tr, size = reference.featuremap(scene, setting, device)
        want = reference.match(li, tr, size, templates, scene, setting, device,
                               keep=setting.top_k + compare.TIE_ROWS)
        del li
        li, tr, size = reference.featuremap(scene, setting, device, dtype)
        got = reference.match(li, tr, size, templates, scene, setting, device, dtype)
        del li
        per_scene.append(compare.scene_numbers(as_answer(got), want, setting.top_k))
    return compare.combine(per_scene)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    spec = harness.load_spec()
    cell, _, config, traffic = harness.resolve(spec, args.workload)
    for seed in args.seeds:
        got = numbers(config, traffic, seed, torch.device(args.device))
        print(json.dumps({"workload": cell["name"], "seed": seed, "control": got,
                          "limits": config["limits"],
                          "fails": not compare.verdict(got, config["limits"])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
