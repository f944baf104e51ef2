"""Command-line interface: ``python -m openfdcm_tpu_torch <command>`` (port
of :mod:`openfdcm_tpu.__main__`, with the same arguments and JSON lines):

    python -m openfdcm_tpu_torch match --templates DIR --scene FILE [--top-k K]
    python -m openfdcm_tpu_torch sweep --templates DIR --scenes GLOB --state DIR
    python -m openfdcm_tpu_torch info FILE.tmpl

``match`` and ``sweep`` run on ``--device`` (default ``cuda``; they raise
without a CUDA device unless given ``--device cpu``); ``info`` reads the
file on the host only.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def _common(p):
    p.add_argument("--depth", type=int, default=30)
    p.add_argument("--coeff", type=float, default=5.0)
    p.add_argument("--padding", type=float, default=1.0)
    p.add_argument("--distance", choices=["l1", "l2", "l2sq"], default="l2")
    p.add_argument("--max-tmpl-lines", type=int, default=4)
    p.add_argument("--max-scene-lines", type=int, default=10)
    p.add_argument("--batch", type=int, default=10,
                   help="BatchOptimize batch size")
    p.add_argument("--tau", type=float, default=1.5,
                   help="ExponentialPenalty tau")
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device to match on (cuda, cuda:N or cpu)")


def _setup(args):
    import openfdcm_tpu_torch as of
    dist = {"l1": of.Distance.L1, "l2": of.Distance.L2,
            "l2sq": of.Distance.L2_SQUARED}[args.distance]
    params = of.Dt3Params(args.depth, args.coeff, args.padding, dist)
    searcher = of.DefaultSearch(args.max_tmpl_lines, args.max_scene_lines)
    optimizer = of.BatchOptimize(args.batch)
    return of, params, searcher, optimizer


def _template_paths(spec: str) -> list:
    if os.path.isdir(spec):
        return sorted(glob.glob(os.path.join(spec, "*.tmpl")))
    return sorted(glob.glob(spec))


def cmd_match(args) -> int:
    of, params, searcher, optimizer = _setup(args)
    tmpl_paths = _template_paths(args.templates)
    templates = of.io.read_batch(tmpl_paths)
    scene = of.read(args.scene)
    res = of.match_many([scene], templates, params, searcher, optimizer,
                        penalty=of.ExponentialPenalty(args.tau),
                        template_lengths=of.get_template_lengths(templates),
                        top_k=args.top_k, device=args.device)
    for m in res[0]:
        print(json.dumps({
            "template": os.path.basename(tmpl_paths[m.tmpl_idx]),
            "tmpl_idx": m.tmpl_idx, "score": round(float(m.score), 6),
            "transform": [[round(float(v), 4) for v in row]
                          for row in m.transform],
        }))
    return 0


def cmd_sweep(args) -> int:
    of, params, searcher, optimizer = _setup(args)
    tmpl_paths = _template_paths(args.templates)
    scene_paths = sorted(glob.glob(args.scenes))
    scenes = of.io.read_batch(scene_paths)
    res = of.resumable_sweep(
        scenes, tmpl_paths, params, searcher, optimizer,
        top_k=args.top_k, state_dir=args.state,
        penalty=of.ExponentialPenalty(args.tau),
        chunk_size=args.chunk_size, device=args.device)
    for sp, matches in zip(scene_paths, res):
        best = matches[0] if matches else None
        print(json.dumps({
            "scene": sp,
            "best_template": (os.path.basename(tmpl_paths[best.tmpl_idx])
                              if best else None),
            "best_score": round(float(best.score), 6) if best else None,
            "n_matches": len(matches),
        }))
    return 0


def cmd_info(args) -> int:
    import numpy as np
    from openfdcm_tpu_torch.core import io
    arr = io.read(args.file)
    d = arr[:, 2:4] - arr[:, 0:2]
    lengths = np.hypot(d[:, 0], d[:, 1])
    print(json.dumps({
        "file": args.file, "lines": int(arr.shape[0]),
        "bbox": [float(arr[:, 0::2].min()), float(arr[:, 1::2].min()),
                 float(arr[:, 0::2].max()), float(arr[:, 1::2].max())],
        "total_length": round(float(lengths.sum()), 3),
    }))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="openfdcm_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("match", help="match one scene against a bank")
    m.add_argument("--templates", required=True,
                   help="directory or glob of .tmpl files")
    m.add_argument("--scene", required=True)
    _common(m)
    m.set_defaults(fn=cmd_match)

    s = sub.add_parser("sweep", help="resumable sweep over scenes x bank")
    s.add_argument("--templates", required=True)
    s.add_argument("--scenes", required=True, help="glob of .scene files")
    s.add_argument("--state", required=True, help="checkpoint directory")
    s.add_argument("--chunk-size", type=int, default=2048)
    _common(s)
    s.set_defaults(fn=cmd_sweep)

    i = sub.add_parser("info", help="inspect a line file")
    i.add_argument("file")
    i.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
