"""What a run loads: no module of JAX or of the JAX package (top-level
names compared whole: the port's own name begins with the JAX package's),
and a reference that imports nothing of the port."""
import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from benchmark import cells, harness
from benchmark.conftest import BENCH, ROOT

RUN = """
import sys, time
sys.path.insert(0, {root!r})
import torch
from benchmark import cells, conftest, harness
root = conftest.make_root({tmp!r})
for name in ("gi_room.look", "gi_room.fit512"):
    cell = cells.load_cell(name, root)
    harness.run_cell(cell, 5, 0.2, False, torch.device("cpu"),
                     time.perf_counter(), out=open("/dev/null", "w"),
                     err=open("/dev/null", "w"))
loaded = {{m.split(".")[0] for m in sys.modules}}
print(sorted(loaded & {{"jax", "jaxlib", "flax", "madarch_tpu",
                       "madarch_tpu_torch"}}))
"""

REFERENCE = """
import sys, pkgutil, importlib
sys.path.insert(0, {root!r})
import numpy as np, torch
from benchmark import cells, check
for name in {names!r}:
    pkg = importlib.import_module("benchmark." + name)
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(m.name)
for cfg in {configs!r}:
    r = check.ViewReference(cfg, {root!r}, torch.device("cpu"))
    r.frame((np.array(r.rr.camera_position), np.eye(3, dtype=np.float32)),
            None, None, np.arange(16))
print(sorted({{m.split(".")[0] for m in sys.modules}}
             & {{"jax", "jaxlib", "flax", "madarch_tpu",
                 "madarch_tpu_torch"}}))
"""
# The tiny size the reference's frame is run at by the guard.
TINY = {"resolution": [32, 32], "radiance_resolution": 4,
        "irradiance_resolution": 2}


def reference_packages():
    """(names, configurations): every reference package, the default,
    each a configuration of BENCHMARK.json names and every
    ``benchmark/reference*`` directory; and those configurations cut to
    TINY."""
    names = {cells.DEFAULT_REFERENCE}
    names |= {os.path.basename(os.path.dirname(p)) for p in glob.glob(
        os.path.join(BENCH, "reference*", "__init__.py"))}
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    configs = []
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        names.add(cfg.get("reference", cells.DEFAULT_REFERENCE))
        cfg["resolution"] = TINY["resolution"]
        cfg["probes"] = dict(
            cfg["probes"], radiance_resolution=TINY["radiance_resolution"],
            irradiance_resolution=TINY["irradiance_resolution"])
        configs.append(cfg)
    return sorted(names), configs


def _python(code):
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax(tmp_path):
    """A run of a view and a fit cell loads the port and nothing of JAX or
    of the JAX package."""
    assert _python(RUN.format(root=ROOT, tmp=str(tmp_path))) \
        == "['madarch_tpu_torch']"


def test_the_reference_loads_nothing_of_the_port():
    """Every reference package, each of its modules imported and a frame
    of each configuration run through its own, loads nothing of the port,
    JAX or the JAX package."""
    names, configs = reference_packages()
    assert _python(REFERENCE.format(root=ROOT, names=names,
                                    configs=configs)) == "[]"


def _imported(path, node):
    """The absolute names an import statement of the module at ``path``
    names (a relative import resolved from the module's own name)."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if node.level == 0:
        return [node.module or ""]
    # the module's package: its directory, for __init__.py as for the rest
    package = os.path.relpath(path, ROOT).split(os.sep)[:-1]
    base = package[:len(package) - (node.level - 1)]
    return [".".join(base + ([node.module] if node.module else []))]


def test_the_reference_imports_nothing_of_the_port():
    """No import statement of a reference package names the port, JAX or
    the JAX package, or a module of the benchmark that is no reference
    package (relative imports resolved)."""
    names, _ = reference_packages()
    for name in names:
        for path in glob.glob(os.path.join(BENCH, name, "**", "*.py"),
                              recursive=True):
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if not isinstance(node, (ast.Import, ast.ImportFrom)):
                    continue
                for imported in _imported(path, node):
                    parts = imported.split(".")
                    assert parts[0] not in (
                        "jax", "jaxlib", "flax", "madarch_tpu",
                        "madarch_tpu_torch"), (path, imported)
                    if parts[0] == "benchmark":
                        assert len(parts) > 1 and parts[1] in names, (
                            path, imported)


@pytest.mark.parametrize("name,flagged", [
    ("jax", True), ("jax.numpy", True), ("jaxlib", True), ("flax", True),
    ("madarch_tpu", True), ("madarch_tpu.render", True),
    ("madarch_tpu_torch", False), ("madarch_tpu_torch.ops", False),
    ("jaxtyping", False)])
def test_forbidden_names_compare_whole(monkeypatch, name, flagged):
    monkeypatch.setitem(sys.modules, name, object())
    assert (name in harness.forbidden_modules()) is flagged
