"""Nothing under benchmark/ imports JAX or the JAX package, and the
references import nothing of the system under test.  Top-level module
names are compared whole: the port's name begins with the JAX package's."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "transfer_em_tpu"}


def _sources(sub=""):
    root = os.path.join(HERE, sub)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_anywhere(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_system(path):
    tops = set(_imports(path))
    assert "transfer_em_tpu_torch" not in tops
    assert tops <= {"__future__", "contextlib", "itertools", "math",
                    "typing", "numpy", "torch"}


def test_whole_names_compared():
    """transfer_em_tpu_torch passes; transfer_em_tpu would not."""
    assert "transfer_em_tpu_torch" not in FORBIDDEN
    assert "transfer_em_tpu_torch".split(".")[0] != "transfer_em_tpu"
