"""What decides a run's ``correct``: the first session's outputs, kept as
the timed path produced them, judged against the plain reference
(``reference/``) after the window.

Kept from the first session of the window:

- every tracked pose, against the generator's ground truth;
- the eval render of the last keyframe after the final pass, with the map
  it was rendered from and its camera: the reference renders that map at
  that camera again (projection, tile binning, blend) and the two renders
  are compared;
- one gradient iteration of a later pass, drawn from the seed
  (:func:`draw_sample`: a gradient frame from the session's third on, when
  the map holds several frames, and an iteration from the third on, when
  Adam's moments are no longer zero): its K2 launch (the backward of the
  blend with its reduce), with its inputs and the gradient it returned, and
  its Adam step, with the parameters, gradients and moments it was handed
  and those it returned;
- the map right after the first frame's spawn: every new Gaussian's centre
  against the depth the frame was spawned from.

Each number a cell compares has its limit in
``reference/limits/<workload>.json``; a reading without one is not
compared.  Bin overflow above 0 makes a run not correct (the repository's
own gate).
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

import port
import stats

# the first gradient pass and iteration a sample may fall on (0-based)
FIRST_PASS, FIRST_STEP = 2, 2


def draw_sample(seed: int, gradient: List[int], iters: int) -> Dict[str, int]:
    """The gradient frame and the iteration whose K2 launch and Adam step
    the check keeps, drawn from the seed."""
    rng = np.random.default_rng(seed)
    frames = gradient[FIRST_PASS:] or gradient[-1:]
    first = min(FIRST_STEP, iters - 1)
    return {"frame": int(frames[rng.integers(len(frames))]),
            "step": int(rng.integers(first, iters))}


def _clone(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: x.detach().clone() for k, x in d.items()}


class Capture:
    """Keeps the first session's outputs while the window runs; a context
    manager around the window that hooks the port's ``blend.blend_bwd`` and
    ``optimize._adam_step`` (``port.py``) and restores them on exit.

    :meth:`readings` with a ``control`` puts the lower-precision reference
    in the program's place (``control.py``); the benchmark's own runs never
    do."""

    def __init__(self, blend, optimize, sample: Dict[str, int]):
        self.blend = blend
        self.optimize = optimize
        self.sample = sample
        self.session = -1
        self.frame: Optional[int] = None
        self.k2_calls = 0
        self.kept: Dict = {}
        self.psnr_db: Optional[float] = None
        self.last_readings: Dict[str, float] = {}
        self._stack = contextlib.ExitStack()

    def _due(self) -> bool:
        return self.session == 0 and self.frame == self.sample["frame"]

    # -- the window ---------------------------------------------------------
    def __enter__(self):
        def make_bwd(orig):
            def kept_bwd(*a):
                g = orig(*a)
                if self._due():
                    if self.k2_calls == self.sample["step"]:
                        self.kept["k2"] = {
                            "args": [x.detach().clone() if torch.is_tensor(x)
                                     else x for x in a[:13]],
                            "grad": g.detach().clone()}
                    self.k2_calls += 1
                return g
            return kept_bwd

        def make_adam(orig):
            def kept_adam(params, grads, m, v, step, lrs, update_mask):
                out = orig(params, grads, m, v, step, lrs, update_mask)
                if self._due() and step == self.sample["step"]:
                    self.kept["adam"] = {
                        "params": _clone(params), "grads": _clone(grads),
                        "m": _clone(m), "v": _clone(v), "step": int(step),
                        "lrs": dict(lrs), "mask": update_mask.clone(),
                        "new": _clone(out[0]), "new_m": _clone(out[1]),
                        "new_v": _clone(out[2])}
                return out
            return kept_adam

        self._stack.enter_context(port.patch(self.blend, "blend_bwd", make_bwd))
        self._stack.enter_context(port.patch(self.optimize, "_adam_step", make_adam))
        return self

    def __exit__(self, *exc):
        self._stack.close()
        return False

    def session_start(self, session: int, tracker, mapper) -> None:
        self.session = session
        self.watch_spawn(mapper)

    def frame_start(self, session: int, index: int) -> None:
        self.frame, self.k2_calls = index, 0

    def frame_end(self, session: int, index: int) -> None:
        self.frame = None

    def watch_spawn(self, mapper) -> None:
        """Keep the map right after the first spawn of the first session."""
        if self.session != 0 or "spawn" in self.kept:
            return
        orig = mapper.gaussians_add

        def kept_add(frame):
            before = mapper.state.status.clone()
            n = orig(frame)
            new = (before == 0) & (mapper.state.status != 0)
            self.kept["spawn"] = {
                "xyz": mapper.state.xyz[new].detach().clone(),
                "uid": frame.uid}
            del mapper.gaussians_add   # the class's method again
            return n

        mapper.gaussians_add = kept_add

    def session_end(self, session: int, info: Dict) -> None:
        if session != 0:
            return
        missing = [k for k in ("spawn", "k2", "adam") if k not in self.kept]
        if missing:
            raise port.PortChanged(
                f"the first session kept no {', '.join(missing)}: the port no "
                f"longer calls Mapper.gaussians_add, blend.blend_bwd or "
                f"optimize._adam_step as benchmark/port.py expects (sample "
                f"{self.sample})")
        mapper, out, cam = info["mapper"], info["render"], info["camera"]
        st = mapper.state
        alive = (st.status != 0).nonzero().squeeze(1)
        self.kept["render"] = {
            "colour": out["render"].detach().clone(),
            "state": {k: getattr(st, k)[alive].detach().clone() for k in
                      ("xyz", "features_dc", "features_rest", "scaling",
                       "rotation", "opacity")},
            "w2c": np.asarray(cam.w2c, np.float64), "uid": cam.uid}
        self.psnr_db = stats.psnr(out["render"].detach().cpu().numpy(),
                                  np.asarray(cam.image))

    # -- after the window ---------------------------------------------------
    def readings(self, cfg: Dict, seq: Dict, first: Dict, overflow: int,
                 device, control: Optional[str] = None) -> Dict[str, float]:
        """Every number compared, the program's or, with ``control``, the
        lower-precision reference's in its place."""
        from reference import check

        readings = {"bin_overflow": float(overflow)}
        readings.update(check.readings(self.kept, first, seq, cfg, device,
                                       control))
        if control is None:
            self.last_readings = readings
        return readings

    def judge(self, root: str, workload: str, cfg: Dict, seq: Dict,
              first: Dict, overflow: int, device) -> Dict:
        """Every number compared, with its limit and whether it holds."""
        return verdict(self.readings(cfg, seq, first, overflow, device),
                       load_limits(root, workload))


def verdict(readings: Dict[str, float], limits: Dict) -> Dict:
    """Each limited reading beside its limit and whether it holds; a limit
    without its reading fails."""
    out = {}
    for name, value in readings.items():
        if value is not None and not np.isfinite(value):
            value = None
        lim = limits.get(name)
        if lim is None:
            continue   # read, but not a number this cell compares
        rule, bound = next(iter(lim.items()))
        ok = value is not None and (value <= bound if rule == "max"
                                    else value >= bound)
        out[name] = {"value": value, "limit": bound, "rule": rule,
                     "pass": bool(ok)}
    for name in limits:
        if name not in out:
            out[name] = {"value": None, "limit": next(iter(limits[name].values())),
                         "rule": "missing", "pass": False}
    return out


def load_limits(root: str, workload: str) -> Dict:
    path = os.path.join(root, "benchmark", "reference", "limits", workload + ".json")
    if not os.path.exists(path):
        return {"bin_overflow": {"max": 0}}
    with open(path) as f:
        return json.load(f)["limits"]
