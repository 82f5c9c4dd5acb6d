"""Port parity: the user scripts ``scripts/*_torch.py`` against their JAX
twins, each run as ``python scripts/<name>.py`` from the repository root.

- ``make_synthetic``: the same file set; the poses and intrinsics byte for
  byte, the PNGs' pixels equal (the port writes its own PNG encoding, the
  JAX package OpenCV's, so the bytes of the compressed streams differ).
- ``eval_ate`` and ``associate``: the same standard output, character for
  character, on TUM files with offset, jittered and missing stamps.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, *argv):
    proc = subprocess.run(
        [sys.executable, os.path.join("scripts", script), *map(str, argv)],
        cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_make_synthetic_matches(tmp_path):
    import cv2

    a, b = tmp_path / "jax", tmp_path / "port"
    args = ("--frames", 3, "--height", 24, "--width", 32)
    assert _run("make_synthetic.py", "--out", a, *args).replace(str(a), "") \
        == _run("make_synthetic_torch.py", "--out", b, *args).replace(str(b), "")
    names = _files(a)
    assert names == _files(b) and len(names) == 3 * 3 + 1
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".png"):
            ia = cv2.imread(pa, cv2.IMREAD_UNCHANGED)
            ib = cv2.imread(pb, cv2.IMREAD_UNCHANGED)
            assert ia.dtype == ib.dtype and np.array_equal(ia, ib), name
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), name


def _tum(path, stamps, xyz, quats):
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for t, p, q in zip(stamps, xyz, quats):
            f.write(f"{t:.6f} " + " ".join(f"{v:.6f}" for v in (*p, *q)) + "\n")


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    """A ground-truth and an estimated TUM trajectory: the estimate rotated,
    shifted and noisy, its stamps jittered, a few of them dropped."""
    tmp = tmp_path_factory.mktemp("traj")
    rng = np.random.default_rng(7)
    n = 60
    t = np.arange(n) / 30.0
    gt = np.stack([np.cos(t), np.sin(t), 0.1 * t], 1)
    th = 0.3
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    es = gt @ R.T + [0.5, -0.2, 0.1] + rng.normal(0, 0.01, gt.shape)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    keep = rng.random(n) > 0.1
    _tum(tmp / "gt.txt", t, gt, q)
    _tum(tmp / "es.txt", (t + rng.normal(0, 0.004, n))[keep], es[keep], q[keep])
    return tmp / "gt.txt", tmp / "es.txt"


@pytest.mark.parametrize("extra", [(), ("--offset", 0.01, "--max_difference", 0.01)])
def test_eval_ate_matches(trajectories, extra):
    gt, es = trajectories
    want = _run("eval_ate.py", gt, es, *extra)
    assert want.startswith("compared_pose_pairs")
    assert _run("eval_ate_torch.py", gt, es, *extra) == want


@pytest.mark.parametrize("extra", [(), ("--first_only",),
                                   ("--offset", 0.005, "--max_difference", 0.01)])
def test_associate_matches(trajectories, extra):
    gt, es = trajectories
    want = _run("associate.py", gt, es, *extra)
    assert len(want.splitlines()) > 30
    assert _run("associate_torch.py", gt, es, *extra) == want
