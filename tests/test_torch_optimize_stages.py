"""The compact optimize loop in stages (``models/optimize.py::CompactStages``)
against the whole-iteration gradient (``loss_grads`` over
``_loss_fn_compact``), on the CPU, where every stage runs eager.

The scene is ``parallel/sharded.py::_tiny_problem`` at 32x32 with three
frames, made uneven from numpy seed 5: rows 0-31 stable and 32-63
unstable, random confidences, flat discs, per frame its own random colour
and depth and a camera moved 5 cm along x.  A whole local pass over the
three frames and a whole global pass over them as three keyframes (the
top-40 % colour-error tiles, the global pass's learning rates) run
``MAPPER_ITERS`` iterations each, with the mapper's frame order (random,
the newest in the late half).

Tolerance: none.  Adam's eps of 1e-15 turns a one-ulp change of a gradient
into a step the size of the learning rate, so the staged iteration must
hand Adam the same bits: every step's gradients, parameters and moments,
the final parameters and confidences, and the last report are compared
with ``torch.equal``.

The CUDA graphs that replay the stages are held to the eager pass on the
card (``tests/test_torch_optimize_graphs.py``).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from rtgslam_torch.models import map_ops
from rtgslam_torch.models import optimize as topt
from rtgslam_torch.models.gaussian_map import STABLE, MapState
from rtgslam_torch.ops.rasterize import blend
from rtgslam_torch.parallel.sharded import _tiny_problem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAPPER_ITERS = 50   # the mapper's gaussian_update_iter
WEIGHTS = {"color_weight": 0.8, "depth_weight": 1.0, "normal_weight": 0.1,
           "add_depth_thres": 0.1}
WINDOW = ("color", "depth", "normal", "w2c", "K", "campos")
# (mode, sample_ratio, learning rates, history merge weight)
PASSES = {
    "local": ("local", -1.0, {k: 1e-3 for k in topt.PARAM_KEYS}, 0.5),
    "global": ("global", 0.4,
               dict({k: 1e-4 for k in topt.PARAM_KEYS}, xyz=0.0), 0.0),
}


@pytest.fixture(scope="module")
def scene():
    state, frames, settings = _tiny_problem(3, 32, 32)
    rng = np.random.default_rng(5)
    with torch.no_grad():
        state.status[:32] = STABLE
        state.confidence[:64, 0] = torch.from_numpy(
            rng.integers(0, 6, 64).astype(np.float32))
        state.scaling[:64, 2] = float(np.log(np.float32(0.02)))
        for k, lo, hi in (("color", 0.1, 0.9), ("depth", 1.8, 2.6)):
            frames[k] = torch.from_numpy(
                rng.uniform(lo, hi, frames[k].shape).astype(np.float32))
        frames["depth"][:, :, :4] = 0.0
        shift = 0.05 * torch.arange(3, dtype=torch.float32)
        frames["w2c"][:, 0, 3] = shift
        frames["campos"][:, 0] = -shift
    seq = rng.integers(0, 3, MAPPER_ITERS)
    seq[MAPPER_ITERS // 2 + 1:] = 2
    return state, tuple(frames[k] for k in WINDOW), settings, seq


def _copy(state: MapState) -> MapState:
    return MapState(**{f.name: getattr(state, f.name).clone()
                       for f in dataclasses.fields(MapState)})


def _run_pass(scene, kind, n_iters=MAPPER_ITERS, blend_for=None):
    """A copy of the scene's state after a whole compact pass of ``kind``,
    and the pass's report."""
    state, window, settings, seq = scene
    mode, ratio, lrs, max_weight = PASSES[kind]
    state = _copy(state)
    prep = topt.optimize_prepare(state, *window, settings, mode, ratio, False)
    report = topt.optimize_execute(
        state, *window, prep.rmasks, prep.lists_orig, prep.counts,
        prep.pool_order[:prep.n_pool], prep.n_pool,
        prep.tile_order[:, :prep.n_live_tiles], seq[:n_iters], n_iters, lrs,
        WEIGHTS, settings, mode, max_weight,
        topt.list_crop(prep.cnt_max, prep.lists_orig.shape[-1]), blend_for)
    return state, report


def _recording_adam(monkeypatch):
    """Every Adam step's inputs and outputs, cloned."""
    steps = []
    adam = topt._adam_step

    def recorded(params, grads, m, v, step, lrs, update_mask):
        out = adam(params, grads, m, v, step, lrs, update_mask)
        steps.append([{k: x.clone() for k, x in d.items()}
                      for d in (params, grads, m, v, *out)])
        return out

    monkeypatch.setattr(topt, "_adam_step", recorded)
    return steps


def _counting(monkeypatch, name):
    """Patch ``topt.<name>`` to count its calls; returns the counter."""
    calls = []
    fn = getattr(topt, name)

    def counted(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)

    monkeypatch.setattr(topt, name, counted)
    return calls


@pytest.mark.parametrize("kind", ["local", "global"])
def test_staged_pass_is_bitwise_the_whole_iteration(scene, kind, monkeypatch):
    """A whole pass in stages hands every Adam step the gradients,
    parameters and moments of ``loss_grads``, and leaves the same map."""
    with monkeypatch.context() as mp:
        want_steps = _recording_adam(mp)
        want_state, want_report = _run_pass(scene, kind)
    monkeypatch.setattr(topt, "use_stages", lambda *a: True)
    got_steps = _recording_adam(monkeypatch)
    whole = _counting(monkeypatch, "loss_grads")
    got_state, got_report = _run_pass(scene, kind)

    assert not whole, "the staged pass took the whole-iteration gradient"
    assert len(got_steps) == len(want_steps) == MAPPER_ITERS
    names = ("params", "grads", "m", "v", "new params", "new m", "new v")
    for i, (got, want) in enumerate(zip(got_steps, want_steps)):
        for name, g, w in zip(names, got, want):
            for k in topt.PARAM_KEYS:
                assert torch.equal(g[k], w[k]), f"step {i} {name} {k}"
    for f in dataclasses.fields(MapState):
        assert torch.equal(getattr(got_state, f.name),
                           getattr(want_state, f.name)), f.name
    assert set(got_report) == set(topt.REPORT_KEYS)
    for k in topt.REPORT_KEYS:
        assert torch.equal(got_report[k], want_report[k]), k
    moved = (got_state.features_dc != scene[0].features_dc).any(dim=-1)
    pool = slice(32, 64) if kind == "local" else slice(0, 32)
    assert moved[pool].any() and moved.sum() == moved[pool].sum()
    assert (got_state.confidence > scene[0].confidence).any()


@pytest.mark.parametrize("case", ["under_threshold", "blend_fn", "chain",
                                  "replays"])
def test_which_passes_replay(scene, case, monkeypatch):
    """With the decision taken as on a CUDA device, a pass under
    ``REPLAY_MIN_ITERS`` iterations, a pass given a ``blend_fn``
    (``parallel/sp_optimize.py``) and ``optimize_chain`` (the final pass
    and the full-render path) run ``loss_grads`` every iteration; a pass of
    ``REPLAY_MIN_ITERS`` iterations runs in stages."""
    decide = topt.use_stages
    monkeypatch.setattr(topt, "use_stages", lambda device, n, blend_for:
                        decide(torch.device("cuda"), n, blend_for))
    built = _counting(monkeypatch, "CompactStages")
    whole = _counting(monkeypatch, "loss_grads")
    n = topt.REPLAY_MIN_ITERS - (case == "under_threshold")
    if case == "chain":
        state, window, settings, seq = scene
        mode, ratio, lrs, _ = PASSES["global"]
        topt.optimize_chain(_copy(state), *window, seq[:n], n, lrs, WEIGHTS,
                            settings, mode, ratio, False, 0.0)
    else:
        blend_for = ((lambda *a: blend.blend_tiles_fused)
                     if case == "blend_fn" else None)
        _run_pass(scene, "local", n, blend_for)
    if case == "replays":
        assert len(built) == 1 and not whole
    else:
        assert not built and len(whole) == n
    assert not decide(torch.device("cpu"), 10 * n, None)


def test_stage_inputs_do_not_alias_the_pass(scene):
    """The fixed tensors a step copies into are the stages' own: the pass's
    parameters are left as they were."""
    state, window, settings, seq = scene
    st = _copy(state)
    prep = topt.optimize_prepare(st, *window, settings, "local", -1.0, False)
    hist = map_ops.capture_history(st)
    cp = topt.compact_problem(
        st, *window, prep.rmasks, prep.lists_orig, prep.counts,
        prep.pool_order[:prep.n_pool], prep.n_pool,
        prep.tile_order[:, :prep.n_live_tiles], WEIGHTS, hist, settings,
        "local", topt.list_crop(prep.cnt_max, prep.lists_orig.shape[-1]))
    before = {k: p.clone() for k, p in cp.params.items()}
    stages = topt.CompactStages(cp, settings, prep.counts.shape[1])
    grads, report = stages(0, int(seq[0]), cp.params)
    for k in topt.PARAM_KEYS:
        assert torch.equal(cp.params[k], before[k])
        assert stages.leaves[k].data_ptr() != cp.params[k].data_ptr()
        assert grads[k].shape == cp.params[k].shape
    assert set(report) == set(topt.REPORT_KEYS)
    assert stages.graphs is None   # the CPU never captures


def test_a_staged_step_imports_no_symbolic_shapes(tmp_path):
    """``autograd.grad`` with tensor cotangents imports torch's
    symbolic-shape module (sympy) once a process, 4.5-7 s on the H100 host
    of PERF.md §6; the stages seed their cotangents through ``_Seed``.
    In a fresh interpreter, so no other test has imported it."""
    script = tmp_path / "step.py"
    script.write_text(textwrap.dedent("""
        import sys
        sys.path.insert(0, sys.argv[1])
        import torch
        from rtgslam_torch.models import map_ops, optimize as topt
        from rtgslam_torch.parallel.sharded import _tiny_problem

        state, frames, settings = _tiny_problem(2, 32, 32)
        window = [frames[k] for k in
                  ("color", "depth", "normal", "w2c", "K", "campos")]
        prep = topt.optimize_prepare(state, *window, settings, "local",
                                     -1.0, False)
        cp = topt.compact_problem(
            state, *window, prep.rmasks, prep.lists_orig, prep.counts,
            prep.pool_order[:prep.n_pool], prep.n_pool,
            prep.tile_order[:, :prep.n_live_tiles],
            {"color_weight": 0.8, "depth_weight": 1.0, "normal_weight": 0.1,
             "add_depth_thres": 0.1},
            map_ops.capture_history(state), settings, "local",
            topt.list_crop(prep.cnt_max, prep.lists_orig.shape[-1]))
        stages = topt.CompactStages(cp, settings, prep.counts.shape[1])
        stages(0, 0, cp.params)
        stages(1, 1, cp.params)
        print("symbolic_shapes" if "torch.fx.experimental.symbolic_shapes"
              in sys.modules else "clean")
    """))
    out = subprocess.run([sys.executable, str(script), REPO],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "clean"
