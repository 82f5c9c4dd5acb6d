"""Port parity: the small public helpers of ``models/losses.py``
(``l2_loss``, ``cosine_distance``), ``utils/general.py``
(``inverse_sigmoid_np``) and ``utils/monitor.py`` (``Recorder.time_block``)
against ``rtgslam_tpu`` on numpy inputs from a seed.

Tolerances: the losses 1e-6 relative (float32 means and norms whose sums
may round in another order); the numpy copy exactly equal; ``time_block``
adds the same keys and counts as the JAX recorder, and a time no shorter
than the block's sleep.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtgslam_tpu.models import losses as jlosses
from rtgslam_tpu.utils import general as jgeneral
from rtgslam_tpu.utils import monitor as jmonitor
from rtgslam_torch.models import losses as tlosses
from rtgslam_torch.utils import general as tgeneral
from rtgslam_torch.utils import monitor as tmonitor

torch.set_num_threads(1)
RTOL = 1e-6


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("fn,shape", [
    ("l2_loss", (64, 96, 3)), ("l2_loss", (1000,)),
    ("cosine_distance", (500, 3)), ("cosine_distance", (7, 40, 16))])
def test_losses(fn, shape):
    a, b = _pair(shape, seed=len(shape))
    if fn == "cosine_distance":
        a[:3] = 0.0      # zero vectors: the 1e-8 in the denominator holds
        b[1] = a[1]
    want = np.asarray(getattr(jlosses, fn)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(tlosses, fn)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_inverse_sigmoid_np(seed):
    x = np.random.default_rng(seed).uniform(1e-4, 1 - 1e-4, (257,))
    for arr in (x, x.astype(np.float32)):
        got = tgeneral.inverse_sigmoid_np(arr)
        want = jgeneral.inverse_sigmoid_np(arr)
        assert got.dtype == want.dtype
        assert np.array_equal(got, want)


def test_recorder_time_block():
    recs = (jmonitor.Recorder(), tmonitor.Recorder())
    for rec in recs:
        for _ in range(3):
            with rec.time_block("decode"):
                time.sleep(0.01)
        with rec.time_block("render"):
            pass
    for rec in recs:
        assert dict(rec.count_dict) == {"decode": 3, "render": 1}
        assert rec.mean_dict["decode"] >= 0.01
        assert rec.mean_dict["render"] < rec.mean_dict["decode"]
    assert len(recs[1].samples["decode"]) == 3
