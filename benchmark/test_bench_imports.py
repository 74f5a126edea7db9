"""What a run loads: no module of JAX or of the JAX package (top-level
names compared whole: the port's own name begins with the JAX package's),
and a reference that imports nothing of the port."""
import ast
import glob
import os
import subprocess
import sys

import pytest

from benchmark import harness
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
import benchmark.reference as ref
for m in pkgutil.walk_packages(ref.__path__, "benchmark.reference."):
    importlib.import_module(m.name)
import numpy as np, torch
from benchmark import check
cfg = {{"builder": "global_illumination", "builder_args": {{}},
        "resolution": [32, 32],
        "probes": {{"radiance_resolution": 4, "irradiance_resolution": 2,
                    "probe_count": [6, 6], "grid_dimensions": [4, 3, 3],
                    "grid_spacing": [2.0, 3.0, 3.0]}}}}
r = check.ViewReference(cfg, {root!r}, torch.device("cpu"))
r.frame((np.array([2.0, 2.0, 0.0], np.float32), np.eye(3, dtype=np.float32)),
        None, None, np.arange(16))
print(sorted({{m.split(".")[0] for m in sys.modules}}
             & {{"jax", "jaxlib", "flax", "madarch_tpu",
                 "madarch_tpu_torch"}}))
"""


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
    assert _python(REFERENCE.format(root=ROOT)) == "[]"


def test_the_reference_imports_nothing_of_the_port():
    """No import statement under reference/ names the port, JAX or the
    JAX package."""
    for path in glob.glob(os.path.join(BENCH, "reference", "**", "*.py"),
                          recursive=True):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "jaxlib", "flax", "madarch_tpu",
                    "madarch_tpu_torch"), (path, name)


@pytest.mark.parametrize("name,flagged", [
    ("jax", True), ("jax.numpy", True), ("jaxlib", True), ("flax", True),
    ("madarch_tpu", True), ("madarch_tpu.render", True),
    ("madarch_tpu_torch", False), ("madarch_tpu_torch.ops", False),
    ("jaxtyping", False)])
def test_forbidden_names_compare_whole(monkeypatch, name, flagged):
    monkeypatch.setitem(sys.modules, name, object())
    assert (name in harness.forbidden_modules()) is flagged
