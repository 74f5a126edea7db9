"""Finding a cell by name: BENCHMARK.json, its configuration, traffic mix,
per-layer metric readers, correctness limits and reference package, each
a file or a directory of its own under the benchmark's folder.  Nothing
here names a cell, a configuration or a metric."""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# The reference package of a configuration that names none.
DEFAULT_REFERENCE = "reference"
# The renderer settings a configuration may state (its "renderer"
# object): attributes of the built renderer, each a dataclass.
SETTINGS = ("screen_cfg",)


@dataclasses.dataclass
class Cell:
    """One entry of BENCHMARK.json's workloads with what it names loaded:
    ``chips`` as the entry gives it, ``config`` and ``mix`` the parsed data
    files, ``end_to_end`` and ``per_layer`` the metric entries that the
    cell reports, ``readers`` {per-layer metric name: read function},
    ``limits`` {number compared: its limit}; ``root`` the checkout the
    files were found in."""

    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list
    readers: dict
    limits: dict
    root: str


def _reports(metric, cell_name, e2e_names=None):
    """Whether a metric entry is reported in the cell: its ``workloads``
    list names the cell, or (without one) the metric it moves is one the
    cell reports."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    if e2e_names is None:
        return True
    return metric["moves"] in e2e_names


def load_reader(path):
    """The ``read`` function of a metric reader file (its name may hold
    dots, so it is loaded by path)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + os.path.basename(path)[:-3].replace(".", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_cell(name, root=ROOT):
    """The Cell called ``name`` in ``root``'s BENCHMARK.json, its data files
    looked up under this folder's name inside ``root``.  Raises KeyError
    for an unknown cell, FileNotFoundError for a file it names that is
    missing.  It imports no reference package: a run's set-up holds the
    program's work alone."""
    bench_dir = os.path.join(root, os.path.basename(HERE))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[w["config"]]["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", w["traffic"] + ".json")) \
            as f:
        mix = json.load(f)
    end_to_end = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, e2e_names)]
    readers = {m["name"]: load_reader(
        os.path.join(bench_dir, "metrics", m["name"] + ".py"))
        for m in per_layer}
    with open(os.path.join(bench_dir, "limits", name + ".json")) as f:
        limits = json.load(f)
    return Cell(name=name, chips=w["chips"], config=config, mix=mix,
                end_to_end=end_to_end, per_layer=per_layer, readers=readers,
                limits=limits, root=root)


def _import_dir(name, path):
    """The package in directory ``path``: this folder's own as
    ``benchmark.<name>`` (so that a package importing the default's
    modules shares them), a checkout's elsewhere under a name made from
    its path (the same directory is imported once)."""
    if os.path.realpath(path) == os.path.realpath(os.path.join(HERE, name)):
        return importlib.import_module(f"{__name__.rpartition('.')[0]}."
                                       f"{name}")
    key = "benchmark_reference_" + hashlib.sha1(
        os.path.realpath(path).encode()).hexdigest()[:16]
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(path, "__init__.py"),
            submodule_search_locations=[path])
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def reference_package(config, root=ROOT):
    """The entry module (``entry.py``) of the reference package that a
    configuration names by its ``reference`` key (DEFAULT_REFERENCE
    without one): the directory of that name in ``root``'s benchmark
    folder, else in this one (a test checkout holds only the packages it
    adds).  The entry is the whole of what the check takes from a package
    (reference/entry.py lists it)."""
    name = config.get("reference", DEFAULT_REFERENCE)
    if not name.isidentifier():
        raise ValueError(f"a reference package is a directory of the "
                         f"benchmark's folder, not {name!r}")
    for bench_dir in (os.path.join(root, os.path.basename(HERE)), HERE):
        path = os.path.join(bench_dir, name)
        if os.path.isfile(os.path.join(path, "__init__.py")):
            break
    else:
        raise FileNotFoundError(f"no reference package {name!r} under "
                                f"{root}")
    package = _import_dir(name, path)
    return importlib.import_module(package.__name__ + ".entry")


def _tuples(fields):
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in fields.items()}


def apply_settings(r, config):
    """Sets on the built renderer ``r`` the fields that the configuration's
    ``renderer`` object states of each SETTINGS attribute (lists as
    tuples), over the value the scene's builder gave it: a field not
    stated keeps the scene's own (``render_volumetrics`` as the scene has
    volumetrics).  Raises ValueError for a key SETTINGS does not have or
    a field its class does not have."""
    for key, fields in config.get("renderer", {}).items():
        if key not in SETTINGS:
            raise ValueError(f"unknown renderer setting {key!r}; known: "
                             f"{list(SETTINGS)}")
        current = getattr(r, key)
        known = {f.name for f in dataclasses.fields(current)}
        unknown = sorted(set(fields) - known)
        if unknown:
            raise ValueError(f"renderer setting {key!r}: "
                             f"{type(current).__name__} has no field "
                             f"{unknown}; known: {sorted(known)}")
        setattr(r, key, dataclasses.replace(current, **_tuples(fields)))


def build_scene(examples, probe_settings, config, root, device, width=None,
                height=None):
    """A renderer of the configuration's scene, built by one side: the
    port's modules (program.py) or the reference package's (check.py).
    ``examples(module)`` is the side's ``examples.<module>``, and
    ``probe_settings`` its ProbeSettings class.

    - ``builder``: ``function`` of ``examples/scenes.py``, or
      ``module.function`` of another module of ``examples/`` (such as
      ``large_scenes.sphere_field``);
    - ``builder_args``: its keywords (``obj_path`` taken from ``root``);
    - ``probes``: the fields of the side's ProbeSettings (lists as tuples);
    - ``renderer`` (optional): fields of the renderer's settings, set over
      the scene's own once it is built (``apply_settings``);
    - ``resolution``: width and height, unless given here."""
    w, h = config["resolution"]
    kwargs = dict(config.get("builder_args", {}))
    if "obj_path" in kwargs:
        kwargs["obj_path"] = os.path.join(root, kwargs["obj_path"])
    where, _, function = config["builder"].rpartition(".")
    builder = getattr(examples(where or "scenes"), function)
    r = builder(width or w, height or h, device=device,
                probes=probe_settings(**_tuples(config["probes"])),
                **kwargs)
    apply_settings(r, config)
    return r
