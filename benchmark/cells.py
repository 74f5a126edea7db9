"""Finding a cell by name: BENCHMARK.json, its configuration, traffic mix,
per-layer metric readers and correctness limits, each a file of its own
under the benchmark's folder.  Nothing here names a cell, a
configuration or a metric."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


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
    missing."""
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
    limits_path = os.path.join(bench_dir, "limits", name + ".json")
    with open(limits_path) as f:
        limits = json.load(f)
    return Cell(name=name, chips=w["chips"], config=config, mix=mix,
                end_to_end=end_to_end, per_layer=per_layer, readers=readers,
                limits=limits, root=root)


def build_scene(scenes, probe_settings, config, root, device, width=None,
                height=None):
    """A renderer of the configuration's scene from a scene module
    (``scenes``: the port's examples/scenes.py or the reference's copy)
    and its ProbeSettings class: the builder the configuration names,
    called with its arguments, its probes, and the resolution (the
    configuration's unless given)."""
    w, h = config["resolution"]
    kwargs = dict(config.get("builder_args", {}))
    if "obj_path" in kwargs:
        kwargs["obj_path"] = os.path.join(root, kwargs["obj_path"])
    probes = {k: tuple(v) if isinstance(v, list) else v
              for k, v in config["probes"].items()}
    builder = getattr(scenes, config["builder"])
    return builder(width or w, height or h, device=device,
                   probes=probe_settings(**probes), **kwargs)
