"""No module the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program.  Top-level module names are
compared whole (the port's name begins with the JAX package's)."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "rtgslam_tpu"}
# the harness's copies of the repository's scripts are files of its own
SCRIPTS = {"bench", "bench_torch", "chip_smoke"}


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources(sub=""):
    root = os.path.join(BENCH, sub)
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x not in ("tests", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_harness_imports_no_jax(path):
    found = top_level_imports(path)
    assert not found & FORBIDDEN
    assert not found & SCRIPTS


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    found = top_level_imports(path)
    assert "rtgslam_torch" not in found
    assert not found & FORBIDDEN


def test_whole_names_are_compared():
    # a name that only begins with the JAX package's is the port, not JAX
    assert "rtgslam_torch" not in FORBIDDEN and "rtgslam_tpu" in FORBIDDEN
