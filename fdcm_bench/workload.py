"""Seeded inputs of a configuration: template banks and a pool of scenes.

Everything is made on the host with NumPy from ``--seed``, the same seed
giving the same lines.  Two kinds of configuration file exist:

- ``random_banks`` (the pose notebook's shape): ``banks`` objects, each a
  bank of ``templates_per_bank`` templates of random lines; a scene plants one
  template of one bank under a random rigid transform among clutter lines.
  Copied from ``chip_smoke.make_workload``.
- ``scaled_variants`` (the general-matching notebook's shape): a few base
  shapes, each at a list of scales, in one bank; a frame plants one
  variant of every shape among clutter lines, all within the frame, each
  variant equally often over the pool.

A scene's pool index picks it; the pool is made once in set-up.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

F32 = np.float32


@dataclass
class Inputs:
    """``banks``: per object a list of ``(N_i, 4)`` templates (one entry
    when the configuration has one bank); ``scenes``: the pool of ``(N, 4)``
    scenes; ``bank_of``: the bank each scene's object belongs to."""
    banks: list
    scenes: list
    bank_of: list

    def whole_bank(self) -> list:
        return [t for bank in self.banks for t in bank]


def random_lines(rng, n, box, lmin, lmax):
    """``n`` lines of length in ``[lmin, lmax)`` at random angles, centred
    uniformly in ``box = (lo, hi)`` on both axes."""
    c = rng.uniform(box[0], box[1], (n, 2))
    ang = rng.uniform(0, np.pi, n)
    half = rng.uniform(lmin, lmax, n)[:, None] / 2
    d = np.stack([np.cos(ang), np.sin(ang)], -1) * half
    return np.concatenate([c - d, c + d], -1).astype(F32)


def rotation(theta):
    return np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])


def make_inputs(config: dict, seed: int, pool: int) -> Inputs:
    """The configuration's banks, made from its own ``template_seed`` (the
    same in every run, as a deployment's templates are), and a pool of
    ``pool`` scenes made from ``seed``."""
    spec = config["inputs"]
    kind = spec["kind"]
    tag = [ord(c) for c in config["name"]]
    bank_rng = np.random.default_rng([spec["template_seed"], 0x54] + tag)
    rng = np.random.default_rng([seed, 0x46444] + tag)
    if kind == "random_banks":
        return _random_banks(spec, bank_rng, rng, pool)
    if kind == "scaled_variants":
        return _scaled_variants(spec, bank_rng, rng, pool)
    raise ValueError(f"unknown input kind {kind!r}")


def _random_banks(spec, bank_rng, rng, pool) -> Inputs:
    lo, hi = spec["template_lines"]
    lmin, lmax = spec["line_length_px"]
    half_box = spec["template_half_extent_px"]
    banks = [[random_lines(bank_rng, int(bank_rng.integers(lo, hi + 1)),
                           (-half_box, half_box), lmin, lmax)
              for _ in range(spec["templates_per_bank"])]
             for _ in range(spec["banks"])]
    extent = spec["scene_extent_px"]
    reach = spec["template_reach_px"]
    margin = spec["clutter_margin_px"]
    scenes, bank_of = [], []
    for i in range(pool):
        b = i % len(banks)      # the scenes of a pass: every bank in turn
        t = banks[b][int(rng.integers(len(banks[b])))]
        pts = t.reshape(-1, 2) @ rotation(rng.uniform(-np.pi, np.pi)).T \
            + rng.uniform(reach, extent - reach, 2)
        clutter = random_lines(rng, spec["clutter_lines"], (margin, extent - margin),
                               lmin, lmax)
        lines = np.concatenate([pts.reshape(-1, 4).astype(F32), clutter])
        scenes.append(lines[rng.permutation(len(lines))])
        bank_of.append(b)
    return Inputs(banks, scenes, bank_of)


def _scaled_variants(spec, bank_rng, rng, pool) -> Inputs:
    bank, shapes = [], []
    for shape in spec["shapes"]:
        half = shape["extent_px"] / 2
        lmin, lmax = shape["line_length_px"]
        base = random_lines(bank_rng, shape["lines"],
                            (-half + lmax / 2, half - lmax / 2), lmin, lmax)
        first = len(bank)
        lo, hi, n = shape["scales"]
        bank += [(base * F32(s)).astype(F32) for s in np.linspace(lo, hi, n)]
        shapes.append((first, len(bank)))
    w, h = spec["frame_px"]
    lmin, lmax = spec["clutter_length_px"]
    # every shape's variants planted equally often over the pool, in an
    # order drawn from the seed: each seed has the same set of sizes
    planted_variant = [rng.permutation(np.arange(pool) % (end - first)) + first
                       for first, end in shapes]
    scenes = []
    for k in range(pool):
        parts = []
        for (first, end), variants in zip(shapes, planted_variant):
            t = bank[int(variants[k])]
            pts = t.reshape(-1, 2) @ rotation(rng.uniform(-np.pi, np.pi)).T
            r = np.abs(pts).max(axis=0)          # the placed variant stays inside
            parts.append(pts + rng.uniform(r, (w - 1 - r[0], h - 1 - r[1])))
        planted = np.concatenate(parts).reshape(-1, 4)
        n_clutter = spec["frame_lines"] - planted.shape[0]
        c = rng.uniform((0, 0), (w - 1, h - 1), (n_clutter, 2))
        ang = rng.uniform(0, np.pi, n_clutter)
        half = rng.uniform(lmin, lmax, n_clutter)[:, None] / 2
        d = np.stack([np.cos(ang), np.sin(ang)], -1) * half
        clutter = np.clip(np.concatenate([c - d, c + d], -1), 0, (w - 1, h - 1, w - 1, h - 1))
        lines = np.concatenate([planted.astype(F32), clutter.astype(F32)])
        scenes.append(lines[rng.permutation(len(lines))])
    return Inputs([bank], scenes, [0] * pool)
