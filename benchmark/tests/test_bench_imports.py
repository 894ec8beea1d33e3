"""No module of the benchmark imports JAX, flax or the JAX package, and
the reference imports nothing of the port: top-level names compared whole
(the port's name begins with the JAX package's)."""

import ast
import os

import pytest

from benchmark.chip import FORBIDDEN_MODULES, forbidden_loaded
from benchmark.harness import HERE

PORT = "audio_motion_avatar_tpu_torch"


def sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    """Top-level names of every absolute import in the file."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(sources(HERE)), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not set(imported(path)) & set(FORBIDDEN_MODULES)


@pytest.mark.parametrize("path", sorted(sources(os.path.join(HERE, "reference"))),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in set(imported(path))


def test_whole_names():
    assert forbidden_loaded({PORT: None, f"{PORT}.serve": None}) == []
    assert forbidden_loaded({"jax.numpy": None, "audio_motion_avatar_tpu": None}) == [
        "audio_motion_avatar_tpu", "jax"]
