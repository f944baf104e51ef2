"""Resumable large-bank sweeps: checkpointed chunked matching (port of
:mod:`openfdcm_tpu.sweep`).

The bank is processed in template chunks; each chunk's top-k is folded
into a running per-scene best-k, merged by (score, chunk, rank), and the
merged state is written to disk after every chunk, so a killed sweep
resumes at the first unprocessed chunk.  The checkpoint is one
atomically replaced JSON file in the JAX package's format: a
``state.json`` written by either package resumes in the other.  Chunk
boundaries are deterministic (bank order x chunk size), so a resumed sweep
gives exactly the result of an uninterrupted one.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from .core.io import read_batch
from .matching import featuremap as fm
from .matching.match import _matches, _ranked_rows
from .matching.pipeline import _call_device, match_many

__all__ = ["SweepState", "resumable_sweep"]


@dataclasses.dataclass
class SweepState:
    """On-disk sweep progress: merged per-scene top-k after ``done_chunks``
    template chunks."""
    state_dir: str
    n_templates: int
    chunk_size: int
    top_k: int
    done_chunks: int
    rows: list          # per scene: list of (score, tmpl_idx, chunk, rank)
    mats: np.ndarray    # (S, top_k_alloc, 2, 3) transforms aligned to rows

    @property
    def n_chunks(self) -> int:
        return -(-self.n_templates // self.chunk_size)

    def save(self) -> None:
        """One atomic file (write-tmp + rename): a kill at any point leaves
        either the previous or the new checkpoint, never a torn one."""
        os.makedirs(self.state_dir, exist_ok=True)
        tmp = os.path.join(self.state_dir, ".state.tmp")
        with open(tmp, "w") as f:
            json.dump({
                "n_templates": self.n_templates,
                "chunk_size": self.chunk_size,
                "top_k": self.top_k,
                "done_chunks": self.done_chunks,
                "rows": self.rows,
                "mats": self.mats.tolist(),
            }, f)
            f.flush()
            os.fsync(f.fileno())        # survive a hard kill mid-rename
        os.replace(tmp, os.path.join(self.state_dir, "state.json"))

    @classmethod
    def load(cls, state_dir: str):
        path = os.path.join(state_dir, "state.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            d = json.load(f)
        return cls(state_dir=state_dir, n_templates=d["n_templates"],
                   chunk_size=d["chunk_size"], top_k=d["top_k"],
                   done_chunks=d["done_chunks"],
                   rows=[[tuple(r) for r in sc] for sc in d["rows"]],
                   mats=np.asarray(d["mats"], np.float32).reshape(
                       len(d["rows"]), -1, 2, 3))


def resumable_sweep(scenes, templates, params: fm.Dt3Params, searcher,
                    optimizer, *, top_k: int, state_dir: str,
                    penalty=None, template_lengths=None,
                    chunk_size: int = 2048, mesh=None, match_fn=None,
                    device=None) -> list:
    """Match ``scenes`` against a (possibly huge) template bank on
    ``device`` (default the card; with a ``mesh``, every chunk runs
    ``match_many(..., mesh=mesh)``, which decides ``device`` when that is
    None), with checkpoint and resume.

    ``templates`` may be a list of arrays or of ``.tmpl`` paths (read per
    chunk, so the full bank never resides in host memory).  Returns
    ``list[list[Match]]`` per scene, equal to ``match_many(...,
    top_k=top_k)`` over the whole bank.  ``match_fn(scenes, chunk_templates,
    chunk_lengths)`` overrides the per-chunk matcher."""
    device = _call_device(mesh, device, "resumable_sweep")
    n_total = len(templates)
    lazy = bool(n_total) and isinstance(templates[0], (str, os.PathLike))

    state = SweepState.load(state_dir)
    if state is not None and (state.n_templates != n_total
                              or state.chunk_size != chunk_size
                              or state.top_k != top_k
                              or len(state.rows) != len(scenes)):
        raise ValueError(
            f"sweep state in {state_dir} was written for a different "
            f"configuration (templates {state.n_templates} vs {n_total}, "
            f"chunk {state.chunk_size} vs {chunk_size}, k {state.top_k} "
            f"vs {top_k}, scenes {len(state.rows)} vs {len(scenes)}); "
            f"delete it or use a fresh state_dir")
    if state is None:
        state = SweepState(
            state_dir=state_dir, n_templates=n_total, chunk_size=chunk_size,
            top_k=top_k, done_chunks=0, rows=[[] for _ in scenes],
            mats=np.zeros((len(scenes), 0, 2, 3), np.float32))

    if match_fn is None:
        def match_fn(scene_list, chunk_templates, chunk_lengths):
            return match_many(scene_list, chunk_templates, params, searcher,
                              optimizer, penalty=penalty,
                              template_lengths=chunk_lengths, top_k=top_k,
                              device=device, mesh=mesh)

    lengths_all = None
    if template_lengths is not None:
        lengths_all = np.asarray(template_lengths, np.float32)

    for ci in range(state.done_chunks, state.n_chunks):
        lo, hi = ci * chunk_size, min((ci + 1) * chunk_size, n_total)
        chunk = templates[lo:hi]
        if lazy:
            chunk = read_batch([os.fspath(p) for p in chunk])
        chunk_lengths = None
        if penalty is not None and lengths_all is not None:
            chunk_lengths = lengths_all[lo:hi]
        res = match_fn(scenes, chunk, chunk_lengths)

        # fold the chunk's top-k into the running state, by (score, chunk, rank)
        new_mats = []
        for si, matches in enumerate(res):
            merged = state.rows[si] + [
                (float(m.score), int(m.tmpl_idx) + lo, ci, r)
                for r, m in enumerate(matches)]
            mats_merged = np.concatenate([
                state.mats[si][: len(state.rows[si])],
                np.asarray([m.transform for m in matches], np.float32).reshape(-1, 2, 3)])
            score, _, chunk, rank = np.asarray(merged, np.float64).reshape(-1, 4).T
            order = _ranked_rows(score, chunk, rank, ok=np.ones(len(merged), bool),
                                 k=top_k)
            state.rows[si] = [merged[i] for i in order]
            new_mats.append(mats_merged[order])
        kmax = max((m.shape[0] for m in new_mats), default=0)
        mats = np.zeros((len(scenes), kmax, 2, 3), np.float32)
        for si, m in enumerate(new_mats):
            mats[si, : m.shape[0]] = m
        state.mats = mats
        state.done_chunks = ci + 1
        state.save()

    tables = [np.asarray(rows, np.float64).reshape(-1, 4) for rows in state.rows]
    return [_matches(t[:, 1], t[:, 0], state.mats[si]) for si, t in enumerate(tables)]
