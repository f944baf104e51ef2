"""Nothing the harness loads is JAX or the JAX package, compared by whole
top-level module names (the port's name begins with the JAX package's)."""
import ast
import subprocess
import sys
from pathlib import Path

from fdcm_bench import harness
from fdcm_bench.tests.conftest import ROOT

BENCH = Path(ROOT) / "fdcm_bench"


def test_sources_import_no_jax():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in harness.BANNED, (path, n)


def test_a_run_loads_no_jax():
    code = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
from fdcm_bench import harness
from fdcm_bench.tests.conftest import shrink
spec = harness.load_spec()
cell, _, config, traffic = harness.resolve(spec, "general.frame")
config, traffic = shrink(config, traffic)
out = harness.run_cell(spec, cell, config, traffic, seed=3, seconds=0.3, trace=True,
                       device="cpu", t0=time.perf_counter(), log=lambda s: None)
assert out["correct"]
print(harness.banned_modules())
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_banned_names_compare_whole():
    assert harness.banned_modules(["openfdcm_tpu_torch", "openfdcm_tpu_torch.ops.build",
                                   "numpy", "jaxtyping"]) == []
    assert harness.banned_modules(["openfdcm_tpu.core", "jaxlib.xla_client", "jax"]) == [
        "jax", "jaxlib", "openfdcm_tpu"]
