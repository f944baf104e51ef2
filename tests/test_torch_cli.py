"""The port's CLI, ``python -m openfdcm_tpu_torch {match,sweep,info}``, with
``--device cpu``, against the JAX package's CLI on the same files."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from openfdcm_tpu.__main__ import main as jax_main
from openfdcm_tpu_torch.__main__ import main
from tests.test_cli import _write_assets

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()
            if line.startswith("{")]


def test_cli_info(tmp_path, capsys):
    tdir, _ = _write_assets(tmp_path)
    assert main(["info", str(tdir / "t0.tmpl")]) == 0
    got = _lines(capsys)
    assert jax_main(["info", str(tdir / "t0.tmpl")]) == 0
    assert got == _lines(capsys)
    assert got[0]["lines"] == 5 and got[0]["total_length"] > 0


def test_cli_match_equals_jax_cli(tmp_path, capsys):
    """Ids, templates and transforms equal; scores at the CLI's rounding
    (6 decimals; the penalized scores agree to rtol 1e-6)."""
    tdir, scene = _write_assets(tmp_path)
    args = ["match", "--templates", str(tdir), "--scene", str(scene),
            "--depth", "4", "--top-k", "3"]
    assert main(args + ["--device", "cpu"]) == 0
    got = _lines(capsys)
    assert jax_main(args) == 0
    want = _lines(capsys)
    assert 1 <= len(got) == len(want) <= 3
    assert [(g["template"], g["tmpl_idx"]) for g in got] == \
        [(w["template"], w["tmpl_idx"]) for w in want]
    for g, w in zip(got, want):
        assert g["score"] == pytest.approx(w["score"], rel=1e-6, abs=1e-6)
        np.testing.assert_allclose(g["transform"], w["transform"], atol=1e-4)
    assert got[0]["score"] <= got[-1]["score"]


def test_cli_sweep(tmp_path, capsys):
    tdir, scene = _write_assets(tmp_path)
    args = ["sweep", "--templates", str(tdir), "--scenes", str(scene),
            "--depth", "2", "--top-k", "2", "--chunk-size", "2"]
    assert main(args + ["--state", str(tmp_path / "state"), "--device", "cpu"]) == 0
    got = _lines(capsys)
    assert len(got) == 1 and got[0]["best_template"] is not None
    assert got[0]["n_matches"] == 2
    assert os.path.exists(tmp_path / "state" / "state.json")
    assert jax_main(args + ["--state", str(tmp_path / "jstate")]) == 0
    want = _lines(capsys)
    assert got[0]["best_template"] == want[0]["best_template"]
    assert got[0]["best_score"] == pytest.approx(want[0]["best_score"], rel=1e-6)


def test_cli_module_runs_and_needs_cuda(tmp_path):
    """``python -m openfdcm_tpu_torch``: ``info`` on the host; ``match``
    without a CUDA device raises unless given ``--device cpu``."""
    tdir, scene = _write_assets(tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    run = lambda *a: subprocess.run(
        [sys.executable, "-m", "openfdcm_tpu_torch", *a], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    res = run("info", str(tdir / "t1.tmpl"))
    assert res.returncode == 0 and json.loads(res.stdout)["lines"] == 6
    res = run("match", "--templates", str(tdir), "--scene", str(scene),
              "--depth", "2")
    assert res.returncode != 0 and "CUDA" in res.stderr
