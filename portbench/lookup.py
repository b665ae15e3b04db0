"""Where the benchmark finds each of its parts, by name.

A cell is ``workloads/<cell>.json``, a configuration
``configs/<config>.json`` with its pool of GOPs in ``streams/<config>/``,
a per-layer metric ``metrics/<metric>.py``. Adding any of them is adding
a file; nothing here names one.
"""

from __future__ import annotations

import importlib
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _load(kind: str, name: str, root: str) -> dict:
    if not NAME.fullmatch(name):
        raise ValueError(f"not a name: {name!r}")
    path = os.path.join(root, kind, name + ".json")
    if not os.path.exists(path):
        raise KeyError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


# `root`: the folder that holds configs/, workloads/ and streams/ (this
# one; a test's own tree in the tests)

def workload(name: str, root: str = HERE) -> dict:
    return _load("workloads", name, root)


def config(name: str, root: str = HERE) -> dict:
    return _load("configs", name, root)


def pool_dir(config_name: str, root: str = HERE) -> str:
    return os.path.join(root, "streams", config_name)


def manifest(config_name: str, root: str = HERE) -> dict:
    with open(os.path.join(pool_dir(config_name, root),
                           "manifest.json")) as f:
        return json.load(f)


def gop_bytes(config_name: str, entry: dict, root: str = HERE) -> bytes:
    with open(os.path.join(pool_dir(config_name, root), entry["file"]),
              "rb") as f:
        return f.read()


def quantity(name: str) -> str:
    """What a metric's name measures: the name up to its first '.'. What
    follows names the cells it is reported for (``fps.cam``: ``fps`` in
    the cells of the 1080p cameras), so that cells whose runs spread
    apart get bounds of their own."""
    if not NAME.fullmatch(name):
        raise ValueError(f"not a name: {name!r}")
    return name.split(".")[0]


def metric(name: str):
    """The reader module of a per-layer metric (``read(run) -> value or
    None``, ``UNIT``): ``metrics/<quantity>.py``."""
    return importlib.import_module(
        "portbench.metrics." + quantity(name).replace("-", "_"))


def benchmark() -> dict:
    """BENCHMARK.json at the root of the checkout ({} where there is none:
    a test's own tree)."""
    path = os.path.join(REPO, "BENCHMARK.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def per_layer_metrics(cell: str, root: str = HERE) -> list:
    """The per-layer metrics that BENCHMARK.json gives this cell: those
    that list it under ``workloads`` and those that list no cells; every
    reader in ``metrics/`` for a cell that BENCHMARK.json does not name
    (a test's own)."""
    entries = benchmark().get("per_layer")
    if entries is None or root != HERE:
        names = sorted(f[:-3] for f in os.listdir(os.path.join(HERE,
                                                               "metrics"))
                       if f.endswith(".py") and not f.startswith("_"))
        return names
    return [m["name"] for m in entries
            if cell in m.get("workloads", [cell])]
