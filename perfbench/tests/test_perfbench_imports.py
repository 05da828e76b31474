"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the program."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "gantron_tpu"}


def modules():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(imported(path)) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            names = set(imported(os.path.join(ref, f)))
            assert "gantron_tpu_torch" not in names, f
            assert names <= {"math", "torch", "perfbench"}, (f, names)


def test_only_the_program_adapter_imports_the_program():
    for path in modules():
        rel = os.path.relpath(path, HERE)
        if rel == "program.py" or rel.startswith("tests"):
            continue
        assert "gantron_tpu_torch" not in set(imported(path)), rel
