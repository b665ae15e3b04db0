"""What the benchmark may load and write, on the CPU."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import lookup

FORBIDDEN = {"jax", "jaxlib", "flax", "broadway_tpu"}


def _sources(sub=""):
    top = os.path.join(lookup.HERE, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, lookup.HERE))
def test_no_module_imports_jax_or_the_jax_package(path):
    """Compared by whole top-level name: broadway_tpu_torch is not
    broadway_tpu."""
    assert not FORBIDDEN.intersection(_imports(path))


@pytest.mark.parametrize("sub", ["reference", "gen"])
def test_reference_and_generator_import_nothing_of_the_port(sub):
    for path in _sources(sub):
        names = set(_imports(path))
        assert "broadway_tpu_torch" not in names, path
        assert "torch" not in names, path


def test_reference_loads_no_package_but_numpy():
    code = ("import sys; import portbench.reference.decode, "
            "portbench.reference.control, portbench.gen.streams; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=lookup.REPO,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded.intersection(FORBIDDEN | {"broadway_tpu_torch",
                                                "torch"})


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, lookup.HERE))
def test_nothing_writes_to_shared_memory_or_a_fixed_tmp_path(path):
    if os.path.basename(path) == "test_pb_imports.py":
        return
    with open(path) as f:
        text = f.read()
    assert "/dev/shm" not in text
    assert "'/tmp" not in text and '"/tmp' not in text
    assert "multiprocessing" not in set(_imports(path))
