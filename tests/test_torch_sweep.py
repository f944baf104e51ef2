"""The port's resumable sweep on the CPU: chunked, killed and resumed runs
equal one ``match_many`` over the whole bank exactly; a checkpoint written
by the JAX package's sweep resumes in the port.  Mirrors
``tests/test_sweep.py``."""
import numpy as np
import pytest
import torch

import openfdcm_tpu as jof
import openfdcm_tpu_torch as ot
from openfdcm_tpu.sweep import resumable_sweep as jax_sweep
from openfdcm_tpu_torch.sweep import SweepState, resumable_sweep
from tests.test_sweep import _setup
from tests.torch_cases import assert_same_matches

torch.set_num_threads(1)

PARAMS = ot.Dt3Params(4, 5.0, 2.2, ot.Distance.L2)
DEV = dict(device="cpu")


def _full(scenes, templates, k):
    return ot.match_many(scenes, templates, PARAMS, ot.DefaultSearch(4, 10),
                         ot.BatchOptimize(10), penalty=ot.ExponentialPenalty(1.5),
                         template_lengths=ot.get_template_lengths(templates),
                         top_k=k, **DEV)


def _kwargs(templates, k, state_dir, chunk):
    return dict(top_k=k, state_dir=str(state_dir),
                penalty=ot.ExponentialPenalty(1.5),
                template_lengths=ot.get_template_lengths(templates),
                chunk_size=chunk)


@pytest.mark.parametrize("lazy", [False, True])
def test_sweep_equals_match_many(tmp_path, lazy):
    """In-memory templates, and ``.tmpl`` paths read per chunk."""
    templates, scenes = _setup(n_tmpl=5)
    scenes = scenes[:2]
    bank = templates
    if lazy:
        bank = []
        for i, t in enumerate(templates):
            bank.append(tmp_path / f"t{i}.tmpl")
            ot.write(str(bank[-1]), t)
    swept = resumable_sweep(scenes, bank, PARAMS, ot.DefaultSearch(4, 10),
                            ot.BatchOptimize(10), **DEV,
                            **_kwargs(templates, 3, tmp_path / "s", 2))
    assert assert_same_matches(swept, _full(scenes, templates, 3), exact=True) > 0


def test_sweep_resumes_after_kill(tmp_path):
    templates, scenes = _setup()
    k = 4
    calls = []

    class Boom(RuntimeError):
        pass

    def dying_match(scene_list, chunk_templates, chunk_lengths):
        calls.append(len(chunk_templates))
        if len(calls) == 2:
            raise Boom()          # killed mid-sweep, after one checkpoint
        return ot.match_many(scene_list, chunk_templates, PARAMS,
                             ot.DefaultSearch(4, 10), ot.BatchOptimize(10),
                             penalty=ot.ExponentialPenalty(1.5),
                             template_lengths=chunk_lengths, top_k=k, **DEV)

    kwargs = _kwargs(templates, k, tmp_path / "s2", 4)
    with pytest.raises(Boom):
        resumable_sweep(scenes, templates, PARAMS, ot.DefaultSearch(4, 10),
                        ot.BatchOptimize(10), match_fn=dying_match, **DEV,
                        **kwargs)
    st = SweepState.load(kwargs["state_dir"])
    assert st is not None and st.done_chunks == 1

    # resume: chunk 0 is not computed again
    calls.clear()
    swept = resumable_sweep(scenes, templates, PARAMS, ot.DefaultSearch(4, 10),
                            ot.BatchOptimize(10), **DEV, **kwargs)
    assert len(calls) == 0          # default match_fn used; chunks 1, 2 ran
    assert_same_matches(swept, _full(scenes, templates, k), exact=True)


def test_sweep_rejects_mismatched_state(tmp_path):
    templates, scenes = _setup(n_tmpl=5)
    state_dir = str(tmp_path / "s3")
    resumable_sweep(scenes, templates, PARAMS, ot.DefaultSearch(4, 10),
                    ot.BatchOptimize(10), top_k=3, state_dir=state_dir,
                    chunk_size=2, **DEV)
    with pytest.raises(ValueError, match="different"):
        resumable_sweep(scenes, templates, PARAMS, ot.DefaultSearch(4, 10),
                        ot.BatchOptimize(10), top_k=4, state_dir=state_dir,
                        chunk_size=2, **DEV)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX package's sweep stops after its first chunk; the port resumes
    from its ``state.json`` and equals the port's uninterrupted sweep."""
    templates, scenes = _setup(n_tmpl=6)
    scenes = scenes[:2]
    k = 3
    kwargs = _kwargs(templates, k, tmp_path / "j", 3)
    calls = []

    def one_chunk(scene_list, chunk_templates, chunk_lengths):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt
        return jof.match_many(scene_list, chunk_templates,
                              jof.Dt3Params(4, 5.0, 2.2, jof.Distance.L2),
                              jof.DefaultSearch(4, 10), jof.BatchOptimize(10),
                              penalty=jof.ExponentialPenalty(1.5),
                              template_lengths=chunk_lengths, top_k=k)
    with pytest.raises(KeyboardInterrupt):
        jax_sweep(scenes, templates, jof.Dt3Params(4, 5.0, 2.2, jof.Distance.L2),
                  jof.DefaultSearch(4, 10), jof.BatchOptimize(10),
                  match_fn=one_chunk, **kwargs)
    assert SweepState.load(kwargs["state_dir"]).done_chunks == 1
    resumed = resumable_sweep(scenes, templates, PARAMS, ot.DefaultSearch(4, 10),
                              ot.BatchOptimize(10), **DEV, **kwargs)
    whole = resumable_sweep(scenes, templates, PARAMS, ot.DefaultSearch(4, 10),
                            ot.BatchOptimize(10), **DEV,
                            **_kwargs(templates, k, tmp_path / "p", 3))
    # the JAX chunk's penalized scores hold to rtol 1e-6 (its f32 power)
    assert assert_same_matches(resumed, whole) > 0


def test_sweep_needs_cuda_unless_given_cpu(tmp_path, monkeypatch):
    templates, scenes = _setup(n_tmpl=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resumable_sweep(scenes, templates, PARAMS, ot.DefaultSearch(4, 10),
                        ot.BatchOptimize(10), top_k=2,
                        state_dir=str(tmp_path / "s"))


def test_sweep_on_a_scene_mesh(tmp_path, monkeypatch):
    """``resumable_sweep(mesh=...)``, killed after its first chunk and
    resumed, equals one unsharded ``match_many`` over the whole bank; its
    checkpoint is the unsharded sweep's format."""
    from openfdcm_tpu_torch import sweep
    from openfdcm_tpu_torch.parallel import make_mesh
    templates, scenes = _setup()
    mesh = make_mesh((2,), ("scene",), devices=[torch.device("cpu")] * 2)
    kwargs = _kwargs(templates, 4, tmp_path / "s", 4)
    calls = []

    class Boom(RuntimeError):
        pass

    def dying(*a, **kw):
        calls.append(kw.get("mesh"))
        if len(calls) == 2:
            raise Boom()
        return ot.match_many(*a, **kw)

    with monkeypatch.context() as m:
        m.setattr(sweep, "match_many", dying)
        with pytest.raises(Boom):
            resumable_sweep(scenes, templates, PARAMS, ot.DefaultSearch(4, 10),
                            ot.BatchOptimize(10), mesh=mesh, **kwargs)
    assert calls == [mesh, mesh]
    assert SweepState.load(kwargs["state_dir"]).done_chunks == 1
    swept = resumable_sweep(scenes, templates, PARAMS, ot.DefaultSearch(4, 10),
                            ot.BatchOptimize(10), mesh=mesh, **kwargs)
    assert assert_same_matches(swept, _full(scenes, templates, 4), exact=True) > 0
