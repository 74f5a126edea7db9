"""Every public name of the JAX package has its counterpart in the port, or
a stated deviation.

An ``ast`` scan of madarch_tpu/ and madarch_tpu_torch/: neither package is
imported, so this runs with no JAX.  One case per module of madarch_tpu/:

- every public name there (a function, class, method or module-level
  name not starting with ``_``) exists in the port module of the same path
  (defined, assigned or imported there; a method in the port's class of
  the same name);
- for each function, method or class of the same name, every JAX
  parameter (a class's: its ``__init__``'s, or its dataclass fields) is a
  parameter of the port's too;
- or the name, the parameter or the whole module stands in DEVIATIONS as
  ``("renamed", "madarch_tpu_torch/<path>:<qualname>[(<parameter>)]")``,
  whose target must exist, or as ``("by design", "<reason>")`` naming its
  ROADMAP item.  A deviation of a class covers its members.

An entry whose JAX item no longer lacks its port counterpart (or no longer
exists) is stale and fails.  On the CPU:

    python -m pytest tests/test_torch_api_parity.py -q
"""
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "madarch_tpu", "madarch_tpu_torch"

_PLAN = ("the TPU kernels' plan and VMEM/SMEM layout machinery; the CUDA "
         "kernels pack the scene with pack_scene and pick a build by "
         "march_layout and geometry_lanes (ROADMAP C6, 'Not ported, by "
         "design')")
_KNOB = ("a knob of the TPU kernels' tiling, unrolling or culling plan; a "
         "knob comes back only with an H100 measurement (ROADMAP C6, 'Not "
         "ported, by design')")

DEVIATIONS = {
    # -- whole modules
    "madarch_tpu/native.py": (
        "by design", "the C++ loaders of native/; the port keeps its "
        "pure-Python OBJ loader, BVH builder and distance transform "
        "(ROADMAP C6)"),
    # -- core/resample.py
    "madarch_tpu/core/resample.py:MAX_PERIOD": (
        "by design", "the threshold of the TPU's strided-slice lowering of "
        "a periodic index map; the port gathers with index_select (ROADMAP "
        "C6, 'Not ported, by design')"),
    # -- ops/march.py: the Pallas wrappers and the TPU plan
    "madarch_tpu/ops/march.py:pallas_geometry": (
        "renamed", "madarch_tpu_torch/ops/march.py:geometry"),
    "madarch_tpu/ops/march.py:pallas_raycast": (
        "renamed", "madarch_tpu_torch/ops/march.py:raycast"),
    "madarch_tpu/ops/march.py:pallas_visibility": (
        "renamed", "madarch_tpu_torch/ops/march.py:visibility"),
    "madarch_tpu/ops/march.py:pallas_softshadows": (
        "renamed", "madarch_tpu_torch/ops/march.py:softshadows"),
    "madarch_tpu/ops/march.py:pack_params": (
        "renamed", "madarch_tpu_torch/ops/march.py:pack_scene"),
    "madarch_tpu/ops/march.py:PackedScene(vec)": ("by design", _PLAN),
    "madarch_tpu/ops/march.py:PackedScene(chunked)": ("by design", _PLAN),
    "madarch_tpu/ops/march.py:PackedScene(spheres)": ("by design", _PLAN),
    "madarch_tpu/ops/march.py:ScenePlan": ("by design", _PLAN),
    "madarch_tpu/ops/march.py:PlanEntry": ("by design", _PLAN),
    "madarch_tpu/ops/march.py:SceneRefs": ("by design", _PLAN),
    "madarch_tpu/ops/march.py:build_plan": ("by design", _PLAN),
    **{f"madarch_tpu/ops/march.py:{name}": ("by design", _KNOB) for name in (
        "TILE_ROWS", "UNROLL", "S_UNROLL", "SEG_CAND", "SEG_DENSE", "LANES",
        "CHUNK_S", "SUPER_MIN", "S_CULL", "AO_MARGIN", "SHADOW_MARGIN_MIN")},
    # -- parallel/spmd.py: one process per device, not one process's mesh
    "madarch_tpu/parallel/spmd.py:init_distributed(coordinator_address)": (
        "renamed", "madarch_tpu_torch/parallel/spmd.py:"
        "init_distributed(init_method)"),
    "madarch_tpu/parallel/spmd.py:init_distributed(num_processes)": (
        "renamed", "madarch_tpu_torch/parallel/spmd.py:"
        "init_distributed(world_size)"),
    "madarch_tpu/parallel/spmd.py:init_distributed(process_id)": (
        "renamed", "madarch_tpu_torch/parallel/spmd.py:init_distributed(rank)"),
    "madarch_tpu/parallel/spmd.py:make_mesh(n_devices)": (
        "by design", "one process per device: make_mesh takes this "
        "process's device, not a count of the host's (ROADMAP C6)"),
    "madarch_tpu/parallel/spmd.py:make_mesh(axis)": (
        "by design", "the port's mesh has one axis, the rays, and no name "
        "(ROADMAP C6)"),
    "madarch_tpu/parallel/spmd.py:RaySharder(axis)": (
        "by design", "the port's mesh has one axis, the rays, and no name "
        "(ROADMAP C6)"),
    "madarch_tpu/parallel/spmd.py:ray_sharder(axis)": (
        "by design", "the port's mesh has one axis, the rays, and no name "
        "(ROADMAP C6)"),
    "madarch_tpu/parallel/spmd.py:collective_report(jitted)": (
        "renamed", "madarch_tpu_torch/parallel/spmd.py:collective_report(fn)"),
    # -- render/context.py
    "madarch_tpu/render/context.py:GRID_CHUNK": (
        "renamed", "madarch_tpu_torch/ops/march.py:GRID_CHUNK"),
    "madarch_tpu/render/context.py:CHUNK_SLOT_THRESHOLD": (
        "renamed", "madarch_tpu_torch/ops/march.py:CHUNK_SLOT_THRESHOLD"),
    # -- render/: the march closures became the SceneCtx
    "madarch_tpu/render/lighting.py:direct_lighting(sdf_b)": (
        "renamed", "madarch_tpu_torch/render/lighting.py:direct_lighting(ctx)"),
    "madarch_tpu/render/probes.py:sample_irradiance(sdf_b)": (
        "renamed", "madarch_tpu_torch/render/probes.py:sample_irradiance(ctx)"),
    "madarch_tpu/render/shading.py:shade_hits(sdf_b)": (
        "renamed", "madarch_tpu_torch/render/shading.py:shade_hits(ctx)"),
    "madarch_tpu/render/shading.py:shade_hits(sdf_b_diff)": (
        "by design", "the differentiable scene distance is the SceneCtx's "
        "sdf_b_diff (ROADMAP C6)"),
    "madarch_tpu/render/shading.py:sample_radiance_no_specular(sdf_b)": (
        "renamed", "madarch_tpu_torch/render/shading.py:"
        "sample_radiance_no_specular(ctx)"),
    "madarch_tpu/render/shading.py:sample_radiance_with_specular(sdf_b)": (
        "renamed", "madarch_tpu_torch/render/shading.py:"
        "sample_radiance_with_specular(ctx)"),
    "madarch_tpu/render/shading.py:sample_radiance_with_specular(data)": (
        "by design", "the JAX function never reads it (ROADMAP C6)"),
    "madarch_tpu/render/shading.py:compute_indirect_specular(sdf_b)": (
        "renamed", "madarch_tpu_torch/render/shading.py:"
        "compute_indirect_specular(ctx)"),
    "madarch_tpu/render/volumetrics.py:visibility_pass(sdf_b)": (
        "renamed", "madarch_tpu_torch/render/volumetrics.py:"
        "visibility_pass(ctx)"),
    "madarch_tpu/render/volumetrics.py:scattering_pass(sdf_b)": (
        "renamed", "madarch_tpu_torch/render/volumetrics.py:"
        "scattering_pass(ctx)"),
    **{f"madarch_tpu/render/raymarch.py:{fn}(sdf)": (
        "renamed", f"madarch_tpu_torch/render/raymarch.py:{fn}(sdf_b)")
       for fn in ("raycast", "raycast_visibility", "softshadows",
                  "ambient_occlusion")},
    # -- randomness: a torch.Generator where JAX takes a key
    **{f"madarch_tpu/render/{mod}.py:{fn}(key)": (
        "renamed", f"madarch_tpu_torch/render/{mod}.py:{fn}(generator)")
       for mod, fn in (("pathtrace", "pixel_color_many"),
                       ("pathtrace", "pixel_color_path"),
                       ("sampling", "random_sphere_point"),
                       ("sampling", "random_hemisphere_point"),
                       ("sampling", "cosine_direction"),
                       ("sampling", "uniform_vector"))},
    # -- render/pipeline.py, render/renderer.py
    "madarch_tpu/render/pipeline.py:render_frame_impl": (
        "renamed", "madarch_tpu_torch/render/pipeline.py:render_frame"),
}


# ---------------------------------------------------------------------------
# The scan
# ---------------------------------------------------------------------------

def _params(node):
    a = node.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def _is_record(node):
    """A dataclass or a NamedTuple: its fields are its parameters."""
    decos = [ast.unparse(d) for d in node.decorator_list]
    bases = [ast.unparse(b) for b in node.bases]
    return any("dataclass" in d for d in decos) or "NamedTuple" in bases


def _assigned(node):
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    return [n.id for t in targets for n in ast.walk(t)
            if isinstance(n, ast.Name)]


def scan(path, imports=True):
    """{qualname: parameter list, or None for a constant} of every name a
    module defines or assigns (and, with ``imports``, imports) at its top
    level, and of its
    classes' members as ``Class.member`` (methods and plain class
    attributes).  A class's parameters are its ``__init__``'s, or its
    annotated fields where it is a dataclass or NamedTuple."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            fields = [s.target.id for s in node.body
                      if isinstance(s, ast.AnnAssign)
                      and isinstance(s.target, ast.Name)]
            out[node.name] = fields if _is_record(node) else []
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{sub.name}"] = _params(sub)
                    if sub.name == "__init__":
                        out[node.name] = _params(sub)
                elif isinstance(sub, ast.Assign):
                    for name in _assigned(sub):
                        out[f"{node.name}.{name}"] = None
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for name in _assigned(node):
                out[name] = None
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                out[(alias.asname or alias.name).split(".")[0]] = None
    return out


def _public(qualname):
    return not any(part.startswith("_") for part in qualname.split("."))


def jax_public(path):
    """The public names a JAX module defines or assigns (not those it
    imports), with their parameters."""
    return {q: p for q, p in scan(path, imports=False).items()
            if _public(q)}


def _modules():
    root = os.path.join(REPO, JAX_PKG)
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root)
                  for f in files if f.endswith(".py"))


MODULES = _modules()


def _split(key):
    """'pkg/path.py[:qualname[(param)]]' -> (path, qualname, param)."""
    path, _, rest = key.partition(":")
    qual, _, param = rest.partition("(")
    return path, qual or None, param.rstrip(")") or None


def _port_scan(rel):
    path = os.path.join(REPO, PORT_PKG, rel)
    return scan(path) if os.path.exists(path) else None


def _covered(rel, qual, param=None):
    """The DEVIATIONS entry for a parameter, or for a name, its class or
    its whole module; or None."""
    base = f"{JAX_PKG}/{rel}"
    if param is not None:
        keys = [f"{base}:{qual}({param})"]
    else:
        keys = [base, f"{base}:{qual.split('.')[0]}", f"{base}:{qual}"]
    return next((DEVIATIONS[k] for k in keys if k in DEVIATIONS), None)


def gaps(rel):
    """The public JAX names and parameters of module ``rel`` the port
    lacks, and no entry covers."""
    jax_names = jax_public(os.path.join(REPO, JAX_PKG, rel))
    port = _port_scan(rel)
    out = []
    for qual, params in sorted(jax_names.items()):
        if _covered(rel, qual) is not None:
            continue
        if port is None or qual not in port:
            out.append(f"{JAX_PKG}/{rel}:{qual}")
            continue
        for p in params or []:
            if p not in (port[qual] or []) and \
                    _covered(rel, qual, p) is None:
                out.append(f"{JAX_PKG}/{rel}:{qual}({p})")
    return out


def stale(key):
    """Why the entry ``key`` no longer stands for a gap, or None."""
    path, qual, param = _split(key)
    rel = os.path.relpath(path, JAX_PKG)
    if not os.path.exists(os.path.join(REPO, path)):
        return "no such JAX module"
    port = _port_scan(rel)
    if qual is None:
        return "the port has this module" if port is not None else None
    jax_names = jax_public(os.path.join(REPO, path))
    if qual not in jax_names:
        return "no such public JAX name"
    if param is None:
        return "the port has this name" if port and qual in port else None
    if param not in (jax_names[qual] or []):
        return "no such JAX parameter"
    if not port or qual not in port:
        return "the port lacks the whole name"
    return "the port has this parameter" if param in (port[qual] or []) \
        else None


def target_exists(target):
    path, qual, param = _split(target)
    if not path.startswith(PORT_PKG + "/") or qual is None:
        return False
    port = _port_scan(os.path.relpath(path, PORT_PKG))
    if port is None or qual not in port:
        return False
    return param is None or param in (port[qual] or [])


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rel", MODULES)
def test_every_public_jax_name_has_its_port_counterpart(rel):
    """Module ``rel`` of the JAX package: no gap without an entry, and its
    entries neither stale nor pointing at nothing."""
    assert gaps(rel) == []
    mine = [k for k in DEVIATIONS if _split(k)[0] == f"{JAX_PKG}/{rel}"]
    assert {k: stale(k) for k in mine if stale(k)} == {}
    for key in mine:
        kind, what = DEVIATIONS[key]
        if kind == "renamed":
            assert target_exists(what), (key, what)


def test_deviation_entries_are_well_formed():
    """Each entry names a JAX module that exists, and is a rename or a
    reason that names its ROADMAP item."""
    for key, value in DEVIATIONS.items():
        path = _split(key)[0]
        assert path.startswith(JAX_PKG + "/"), key
        assert os.path.relpath(path, JAX_PKG) in MODULES, key
        kind, what = value
        assert kind in ("renamed", "by design"), key
        if kind == "by design":
            assert "ROADMAP" in what, key


def test_the_scan_sees_what_it_checks(tmp_path):
    """The scanner's rules on a module of each kind of name: functions,
    methods, constants, dataclass fields, __init__ parameters and imports;
    private names and imported names are not the JAX module's own."""
    src = tmp_path / "mod.py"
    src.write_text(
        "import numpy as np\n"
        "from os import path\n"
        "import dataclasses\n"
        "LIMIT = 3\n"
        "_HIDDEN = 4\n"
        "Thing = object()\n"
        "def f(a, b=1, *args, c, **kw):\n"
        "    pass\n"
        "def _g():\n"
        "    pass\n"
        "@dataclasses.dataclass\n"
        "class Rec:\n"
        "    x: int\n"
        "    y: int = 0\n"
        "    def m(self, z):\n"
        "        pass\n"
        "class Obj:\n"
        "    def __init__(self, p, q=None):\n"
        "        pass\n"
        "    def _private(self):\n"
        "        pass\n")
    names = scan(str(src))
    assert names["f"] == ["a", "b", "c", "args", "kw"]
    assert names["Rec"] == ["x", "y"] and names["Rec.m"] == ["z"]
    assert names["Obj"] == ["p", "q"]
    assert {"np", "path", "LIMIT", "Thing"} <= set(names)
    public = jax_public(str(src))
    assert set(public) == {"LIMIT", "Thing", "f", "Rec", "Rec.m", "Obj"}
