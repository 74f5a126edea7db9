"""The traffic generator: deterministic for a seed, and a seed changes
only where a cycle starts."""
import glob
import json
import os

import numpy as np
import pytest

from benchmark import traffic
from benchmark.conftest import BENCH

MIXES = sorted(os.path.basename(p)[:-5]
               for p in glob.glob(os.path.join(BENCH, "traffic", "*.json")))
SCENE = (2.0, 2.0, 0.0)


def load(name):
    with open(os.path.join(BENCH, "traffic", name + ".json")) as f:
        return json.load(f)


def sent(mix, seed, frames=240):
    gen = traffic.make(mix, seed, SCENE)
    if mix["loop"] == "view":
        return [(gen.pose(k), gen.edit(k)) for k in range(-3, frames)]
    return [gen.view(k) for k in range(frames)], gen.perturbation(5)


def same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("name", MIXES)
def test_deterministic_for_a_seed(name):
    mix = load(name)
    seed = 2 ** 31 + 12345
    assert same(sent(mix, seed), sent(mix, seed))
    assert not same(sent(mix, seed), sent(mix, seed + 1))


@pytest.mark.parametrize("name", [m for m in MIXES
                                  if "cycle_frames" in load(m)])
def test_seeds_send_the_same_poses_in_another_order(name):
    mix = load(name)
    cycle = mix["cycle_frames"]

    def poses(seed):
        gen = traffic.make(mix, seed, SCENE)
        return sorted(tuple(np.round(np.concatenate(
            [p.ravel(), o.ravel()]), 4)) for p, o in
            (gen.pose(k) for k in range(cycle)))
    assert poses(1) == poses(2 ** 31 + 5)


def test_orbit_keeps_its_distance_and_looks_at_the_centre():
    mix = load("orbit")
    gen = traffic.make(mix, 7, (0.0, 1.0, -5.0))
    centre = np.array(mix["camera"]["centre"])
    for k in range(0, 120, 7):
        pos, orient = gen.pose(k)
        assert np.hypot(*(pos - centre)[[0, 2]]) == pytest.approx(
            np.hypot(1.5, 6.0), rel=1e-5)
        forward = orient[:, 2]
        to_centre = (centre - pos) / np.linalg.norm(centre - pos)
        assert forward == pytest.approx(to_centre, abs=1e-5)
