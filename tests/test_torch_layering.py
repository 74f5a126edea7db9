"""The arrows between the port's kernel layer and its callers, by an ``ast``
scan of madarch_tpu_torch/ (nothing is imported, so this runs with no
card and no JAX):

- no module of ops/ imports from render/ but render/raymarch.py, the plain
  marches, which depend on core/ alone;
- no kernel module of ops/ (every one but ops/build.py and ops/launch.py,
  the seam they share) imports another kernel module;
- render/shading.py does not import ops/probe_lookup.py: render/probes.py
  owns both probe lookups and their routes.

On the CPU:

    python -m pytest tests/test_torch_layering.py -q
"""
import ast
import os

import pytest

PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "madarch_tpu_torch")
OPS = sorted(f[:-3] for f in os.listdir(os.path.join(PORT, "ops"))
             if f.endswith(".py"))
# ops/ modules every kernel module may import
SEAM = ("__init__", "build", "launch")
KERNEL_MODULES = [name for name in OPS if name not in SEAM]


def imported(path):
    """Every module the source file ``path`` imports, by dotted name: for
    ``from a.b import c`` both a.b.c and a.b, since c may be a module."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
            out.update(f"{node.module}.{alias.name}" for alias in node.names)
    return out


def test_the_scan_sees_every_kind_of_import(tmp_path):
    (tmp_path / "m.py").write_text(
        "import madarch_tpu_torch.ops.march\n"
        "from madarch_tpu_torch.render import probes as p\n"
        "def f():\n"
        "    from madarch_tpu_torch.ops.launch import check\n")
    assert imported(tmp_path / "m.py") == {
        "madarch_tpu_torch.ops.march", "madarch_tpu_torch.render",
        "madarch_tpu_torch.render.probes", "madarch_tpu_torch.ops.launch",
        "madarch_tpu_torch.ops.launch.check"}


def reached(rel, package):
    """The modules of madarch_tpu_torch/<package>/ that the port's source
    file ``rel`` imports."""
    prefix = f"madarch_tpu_torch.{package}."
    return {name[len(prefix):].split(".")[0]
            for name in imported(os.path.join(PORT, rel))
            if name.startswith(prefix)}


@pytest.mark.parametrize("name", OPS)
def test_the_kernel_layer_imports_only_the_plain_marches_of_render(name):
    assert reached(f"ops/{name}.py", "render") - {"raymarch"} == set()


@pytest.mark.parametrize("name", KERNEL_MODULES)
def test_no_kernel_module_imports_another(name):
    assert reached(f"ops/{name}.py", "ops") & (
        set(KERNEL_MODULES) - {name}) == set()


def test_the_shade_leaves_the_probe_lookups_to_render_probes():
    assert "probe_lookup" not in reached("render/shading.py", "ops")
