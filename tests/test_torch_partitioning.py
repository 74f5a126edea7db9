"""Port parity: the uniform partitioning grid
(madarch_tpu_torch/scene/partitioning.py) against
madarch_tpu/scene/partitioning.py.

build_grid's three methods on test_march_kernels.build_chunked_scene()
(80 triangles and a plane, a 10×8×10 grid of K = 20) and on the in-repo
torus with obj_mesh's 30×20×20 grid (K = 150; cpu_best on a block of it,
TORUS_BEST_BLOCK says why), each package building its own grid from the
same scene:
- the candidate sets and counts are equal, except on cells where the sets
  differ by a near-tie, which _explained checks cell by cell: a candidate
  within 1e-6 of the keep threshold or of the K-th kept one (where the
  order is a last bit's choice); for cpu_best a sample where two primitives are
  closest to within 1e-6 (a shared edge of the mesh), each package's
  rounding picking its own winner.  Both packages compute the same float32
  distances up to XLA's fused multiply-adds, which the host's CPU decides,
  so how many cells differ is the host's rounding: their share of the
  grid's cells is capped;
- grid_closest on the same grid at seeded points inside and outside it
  agrees to 1e-6, with the clamp and the fallback border behaviours.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madarch_tpu.core import config as JC
from madarch_tpu.examples import scenes as jscenes
from madarch_tpu.scene import partitioning as JPT
from madarch_tpu_torch.core.config import PartitioningSettings
from madarch_tpu_torch.examples import scenes as tscenes
from madarch_tpu_torch.scene import partitioning as TPT
from madarch_tpu_torch.scene.scene import scene_data_from_numpy
from test_march_kernels import build_chunked_scene
from test_torch_config import torch_threads  # noqa: F401
from test_torch_march import port_spec

pytestmark = pytest.mark.usefixtures("torch_threads")

METHODS = ["gpu_fast", "cpu_fast", "cpu_best"]
SMALL_GRID = PartitioningSettings(index_count=20, border_behavior="clamp",
                                  grid_dimensions=(10, 8, 10),
                                  grid_spacing=(0.5, 0.5, 0.5),
                                  grid_offset=(-2.5, -1.2, 2.5))
# cpu_best samples 27 points per cell against every triangle: on the torus
# it runs on this 10×10×10 block of obj_mesh's grid (its spacing and K,
# the block over the torus's near half), a twelfth of the cells, to keep
# the test fast.  Its 27 samples meet many near-ties between the mesh's
# neighbouring triangles, so a fair share of its cells differ.
TORUS_BEST_BLOCK = dict(grid_dimensions=(10, 10, 10),
                        grid_offset=(0.5, 0.5, 0.2))
# The largest share of a grid's cells whose candidate sets may differ
# between the packages, every one explained by a near-tie (_explained).
# How many differ is the host's XLA rounding (XLA's CPU backend fuses
# multiply-adds as the host's CPU allows): on the torus, 3 of the 12,000
# cells for gpu_fast and cpu_fast on two hosts, and for cpu_best 220 of
# the 1,000-cell block on one host and 233 on another; none on the
# 80-triangle scene.  cpu_best's cap is about 1.3x the most measured, the
# others one cell in a thousand, so most cells are still compared exactly.
MAX_DIFFERING_SHARE = {"gpu_fast": 1e-3, "cpu_fast": 1e-3, "cpu_best": 0.3}


def _jax_settings(s):
    return JC.PartitioningSettings(**dataclasses.asdict(s))


@pytest.fixture(scope="module", params=["tris80", "torus"])
def scene(request):
    """(name, jax spec, jax data, port spec, port data, port settings)."""
    if request.param == "torus":
        jr = jscenes.obj_mesh(width=8, height=8, obj_path=tscenes.TORUS_OBJ)
        jspec, jdata = jr.spec, jr.builder.device_data(grid=None)
        tspec = port_spec(jspec)
        settings = tspec.partitioning
    else:
        jspec, jdata = build_chunked_scene(n_tris=80)
        tspec = port_spec(jspec)
        settings = SMALL_GRID
    tdata = scene_data_from_numpy(jax.tree.map(np.asarray, jdata), "cpu")
    return request.param, jspec, jdata, tspec, tdata, settings


def _method_settings(name, settings, method):
    if name == "torus" and method == "cpu_best":
        return dataclasses.replace(settings, **TORUS_BEST_BLOCK)
    return settings


@pytest.fixture(scope="module")
def grids(scene):
    """Both packages' grids for every method: {method: (settings, jax,
    port)}."""
    name, jspec, jdata, tspec, tdata, settings = scene
    out = {}
    for method in METHODS:
        s = _method_settings(name, settings, method)
        j = JPT.build_grid(jspec, _jax_settings(s), jdata, method=method)
        t = TPT.build_grid(tspec, s, tdata, method=method)
        out[method] = (s, jax.tree.map(np.asarray, j), t)
    return out


def _explained(tspec, tdata, settings, method, cell, tset, jset):
    """Whether a cell's differing candidate sets come from near-ties: for
    the keep-threshold methods, every candidate in one set only lies
    within 1e-6 of the threshold closest + cell_diag or of the K-th kept
    distance; for cpu_best, both sets hold a closest primitive (to
    1e-6) at each of the cell's 27 samples."""
    center = TPT._cell_centers(settings, "cpu")[cell:cell + 1]
    if method == "cpu_best":
        offs = torch.tensor(TPT._BEST_OFFSETS, dtype=torch.float32) * 0.5
        pts = center + offs * torch.tensor(settings.grid_spacing)
        d = TPT.all_slot_dists(tspec, tdata, pts)
        dt = d[:, sorted(tset)].amin(dim=1)
        dj = d[:, sorted(jset)].amin(dim=1)
        return bool(torch.allclose(dt, dj, rtol=1e-6, atol=1e-6))
    d = TPT.all_slot_dists(tspec, tdata, center)[0]
    thresh = float(d.min()) + settings.cell_diag
    kept = torch.sort(d[d < thresh]).values
    k = settings.index_count
    kth = float(kept[k - 1]) if len(kept) > k else None

    def near(x, y):
        return y is not None and math.isclose(x, y, rel_tol=1e-6,
                                              abs_tol=1e-6)

    return all(near(float(d[c]), thresh) or near(float(d[c]), kth)
               for c in tset ^ jset)


@pytest.mark.parametrize("method", METHODS)
def test_build_grid_matches_jax(scene, grids, method):
    name, jspec, jdata, tspec, tdata, _ = scene
    settings, j, t = grids[method]
    assert t.cells.dtype == torch.int32 and t.counts.dtype == torch.int32
    assert t.cells.shape == j.cells.shape == (settings.num_cells,
                                              settings.index_count)
    assert j.counts.max() > 0
    tc, tn = t.cells.numpy(), t.counts.numpy()
    differ = []
    for c in range(settings.num_cells):
        assert (tc[c, tn[c]:] == -1).all()          # -1 past the count
        tset, jset = set(tc[c, :tn[c]]), set(j.cells[c, :j.counts[c]])
        if tset != jset:
            assert _explained(tspec, tdata, settings, method, c, tset,
                              jset), c
            differ.append(c)
    assert len(differ) <= MAX_DIFFERING_SHARE[method] * settings.num_cells, \
        differ
    same = np.ones(settings.num_cells, bool)
    same[differ] = False
    np.testing.assert_array_equal(tn[same], j.counts[same])


def _points(settings, n, seed):
    """Seeded points over the grid and a margin around it (outside cells
    clamp to the border)."""
    rng = np.random.RandomState(seed)
    lo = np.asarray(settings.grid_offset, np.float32)
    ext = np.asarray(settings.grid_dimensions, np.float32) \
        * np.asarray(settings.grid_spacing, np.float32)
    return (lo - 0.1 * ext + rng.rand(n, 3) * 1.2 * ext).astype(np.float32)


@pytest.mark.parametrize("method", ["gpu_fast", "cpu_best"])
def test_grid_closest_matches_jax(scene, grids, method):
    """The query on the JAX package's grid, handed to both."""
    name, jspec, jdata, tspec, tdata, _ = scene
    settings, j, _ = grids[method]
    t = TPT.GridData(cells=torch.as_tensor(np.array(j.cells)),
                     counts=torch.as_tensor(np.array(j.counts)))
    p = _points(settings, 256, seed=81)
    jg = JPT.GridData(cells=jnp.asarray(j.cells), counts=jnp.asarray(j.counts))
    js = _jax_settings(settings)
    jd = jax.vmap(lambda q: JPT.grid_closest(jspec, js, jdata, jg, q))(
        jnp.asarray(p))
    td = TPT.grid_closest(tspec, settings, tdata, t, torch.as_tensor(p))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)
    assert (td.numpy() < tspec.max_dist).any()


def test_grid_closest_fallback_outside_the_grid(scene, grids):
    """border_behavior 'fallback': outside the grid the whole scene's
    distance, inside the candidates' (as the JAX package)."""
    name, jspec, jdata, tspec, tdata, _ = scene
    settings, j, _ = grids["gpu_fast"]
    t = TPT.GridData(cells=torch.as_tensor(np.array(j.cells)),
                     counts=torch.as_tensor(np.array(j.counts)))
    fb = dataclasses.replace(settings, border_behavior="fallback")
    p = _points(settings, 128, seed=82)
    jg = JPT.GridData(cells=jnp.asarray(j.cells), counts=jnp.asarray(j.counts))
    js = _jax_settings(fb)
    jd = jax.vmap(lambda q: JPT.grid_closest(jspec, js, jdata, jg, q))(
        jnp.asarray(p))
    td = TPT.grid_closest(tspec, fb, tdata, t, torch.as_tensor(p))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)


def test_build_grid_rejects_unknown_methods(scene):
    name, jspec, jdata, tspec, tdata, settings = scene
    with pytest.raises(ValueError):
        TPT.build_grid(tspec, settings, tdata, method="gpu_best")


def test_renderer_carries_the_grid():
    """obj_mesh builds the grid on the renderer's device and scene_data
    carries it; scene_data_from_numpy carries the JAX package's."""
    r = tscenes.obj_mesh(width=8, height=8, obj_path=tscenes.TORUS_OBJ,
                         device="cpu")
    g = r.scene_data.grid
    assert isinstance(g, TPT.GridData)
    assert g.cells.shape == (12000, 150) and g.counts.shape == (12000,)
    jr = jscenes.obj_mesh(width=8, height=8, obj_path=tscenes.TORUS_OBJ)
    data = scene_data_from_numpy(jax.tree.map(np.asarray, jr.scene_data),
                                 "cpu")
    np.testing.assert_array_equal(data.grid.counts.numpy(),
                                  g.counts.numpy())


def test_planar_prims_matches_jax(scene):
    """planar_prims leaf for leaf, exactly: each vec3 field split into
    name_x/y/z, floats as they are, no material ids."""
    name, jspec, jdata, tspec, tdata, _ = scene
    want = jax.tree.map(np.asarray, JPT.planar_prims(jspec, jdata))
    got = TPT.planar_prims(tspec, tdata)
    assert sorted(got) == sorted(want)
    for tname, fields in want.items():
        assert sorted(got[tname]) == sorted(fields)
        for f, arr in fields.items():
            assert got[tname][f].dtype == torch.float32
            np.testing.assert_array_equal(got[tname][f].numpy(), arr,
                                          err_msg=f"{tname}.{f}")


@pytest.mark.parametrize("method", ["gpu_fast", "cpu_best"])
def test_planar_queries_are_bit_equal(scene, grids, method):
    """candidate_dists and grid_closest read the parameters from
    planar_prims' split when given it: bit-equal to the same queries
    without it, and grid_closest within 1e-6 of JAX's planar query."""
    name, jspec, jdata, tspec, tdata, _ = scene
    settings, j, t = grids[method]
    planar = TPT.planar_prims(tspec, tdata)
    p = torch.as_tensor(_points(settings, 256, seed=83))
    for fb in ("clamp", "fallback"):
        s = dataclasses.replace(settings, border_behavior=fb)
        plain = TPT.grid_closest(tspec, s, tdata, t, p)
        assert torch.equal(TPT.grid_closest(tspec, s, tdata, t, p,
                                            planar=planar), plain)
    cells = np.random.RandomState(85).randint(0, settings.num_cells, 256)
    cand = t.cells[torch.as_tensor(cells)]
    assert torch.equal(
        TPT.candidate_dists(tspec, tdata, cand, p, planar=planar),
        TPT.candidate_dists(tspec, tdata, cand, p))
    jg = JPT.GridData(cells=jnp.asarray(j.cells), counts=jnp.asarray(j.counts))
    js = _jax_settings(settings)
    jplanar = JPT.planar_prims(jspec, jdata)
    jd = jax.vmap(lambda q: JPT.grid_closest(jspec, js, jdata, jg, q,
                                             planar=jplanar))(
        jnp.asarray(p.numpy()))
    tg = TPT.GridData(cells=torch.as_tensor(np.array(j.cells)),
                      counts=torch.as_tensor(np.array(j.counts)))
    np.testing.assert_allclose(
        TPT.grid_closest(tspec, settings, tdata, tg, p, planar=planar)
        .numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)


def test_planar_candidate_dists_on_the_room_types_are_bit_equal():
    """Spheres, planes and boxes (the GI room), seeded candidates with
    dead (-1) entries, seeded points: bit-equal with and without planar,
    and JAX's planar candidate distances within 1e-6."""
    jr = jscenes.global_illumination(width=8, height=8)
    tr = tscenes.global_illumination(width=8, height=8, device="cpu")
    jspec, tspec = jr.base_spec, tr.base_spec
    jdata = jr.scene_data
    tdata = scene_data_from_numpy(jax.tree.map(np.asarray, jdata), "cpu")
    rng = np.random.RandomState(84)
    total = tspec.total_prim_capacity
    cand = rng.randint(-1, total, (200, 12)).astype(np.int32)
    p = rng.uniform([-1, -1, -6], [7, 7, 7], (200, 3)).astype(np.float32)
    planar = TPT.planar_prims(tspec, tdata)
    assert sorted(planar) == ["box", "plane", "sphere"]
    got = TPT.candidate_dists(tspec, tdata, torch.as_tensor(cand),
                              torch.as_tensor(p), planar=planar)
    assert torch.equal(got, TPT.candidate_dists(
        tspec, tdata, torch.as_tensor(cand), torch.as_tensor(p)))
    jplanar = JPT.planar_prims(jspec, jdata)
    ref = jax.vmap(lambda c, q: JPT.candidate_dists(
        jspec, jdata, c, q, planar=jplanar))(jnp.asarray(cand),
                                             jnp.asarray(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
