#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (madarch_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:

1. toolchain: the card's name and power limit (nvidia-smi), torch, CUDA
   and nvcc versions; fails without a CUDA device;
2. builds the kernels (ops/csrc/march.cu generic and once per layout of
   MARCH_LAYOUTS; geometry.cu once per lane count and with COUNT_WORK;
   probes.cu; one nvcc each, started together) from
   the checkout and prints ptxas's register and spill lines for the
   geometry and the probe-lookup kernels;
3. holds the geometry kernel against its plain PyTorch version
   (geometry_reference) on the global_illumination scene, on rays of the
   radiance pass (no reflection) and of the 800x800 screen pass
   (reflection folded in): seeded subsets of 16,384 rays, then both
   passes' full shapes (36,864 and 640,000 rays), where it also times the
   kernel against the plain version;
4. renders global_illumination at 128x128 over 4 frames through
   Renderer(device="cuda") and holds it to the JAX golden
   (tests/goldens/images.npz) under the golden gates;
5. renders global_illumination at 800x800, checks the image, checks that
   the geometry kernel ran twice per frame, and reports ms/frame (CUDA
   events), rays/s and, under torch.profiler, the device's busy time per
   frame and its heaviest kernels, and the same trace's busy time as
   key_averages() sums it;
7. prints ptxas's register and spill lines for the raycast and
   visibility kernels (each build of march.cu);
8. prints the march steps of the plain versions (mean, quantiles,
   largest, and the SIMT efficiency of one thread a ray) on the 62,500
   rays of light_shafts' 800x800 scattering pass and its 1,000,000
   froxel-to-light rays; holds the raycast kernel against
   raycast_reference on the scattering rays, and the visibility kernel
   against visibility_reference on the froxel rays, each in every build
   of march_candidates (the generic build and the room's layout build on
   the room, and both on the room padded to each of PADDED_LAYOUTS);
9. renders light_shafts at 128x128 over 2 frames through
   Renderer(device="cuda") and holds it to the JAX golden;
10. renders light_shafts at 800x800 (5 timed frames after a warm-up),
   checks the image and that per frame the geometry kernel ran twice, the
   raycast kernel once and the visibility kernel once per live light
   slot, and reports ms/frame, rays/s, the per-pass split and the device
   busy time under torch.profiler;
11. times the raycast and visibility kernels against their plain
   versions at those shapes, and every candidate of each in turns beside
   the bound;
12. prints ptxas's register and spill lines for the softshadow kernel
   (each build of march.cu);
13. on the rays of a global_illumination specular-mode-1 800x800 screen
   pass, prints the plain versions' march steps as in phase 8 and holds
   the raycast kernel against raycast_reference on its 640,000 masked
   reflection rays and the softshadow kernel against
   softshadows_reference on its 5,120,000 penumbra rays (8 per pixel,
   k = 0.5), each at every candidate as in phase 8;
14. holds the geometry kernel with a per-ray mask and no AO (specular
   mode 3's reflection launch) against geometry_reference on 16,384 and
   on all 640,000 of the mode-3 reflection rays;
15. renders global_illumination in specular modes 1 and 3 at 128x128 over
   4 frames through Renderer(device="cuda") and holds each to the same
   render through Renderer(device="cpu") (the plain versions) under the
   golden gates (no JAX golden exists for these modes);
16. renders simple_scene (40 live slots) at 128x128 over 2 frames and
   holds it to the JAX golden; holds the geometry kernel against its
   plain version on simple_scene's radiance and screen rays (16,384 of
   each, then all 36,864 and 640,000) and times it there;
17. renders global_illumination in mode 1, in mode 3 and simple_scene at
   800x800 (5 timed frames after a warm-up each), checks each image and
   the launches per frame (mode 1: geometry 2, raycast 1, softshadows 1;
   mode 3: geometry 3; simple_scene: geometry 2), and reports ms/frame,
   rays/s, the per-pass split and, under torch.profiler, the device's
   busy time per frame and its heaviest kernels;
18. times the softshadow kernel against its plain version on the
   5,120,000 penumbra rays, and the raycast kernel on the 640,000
   reflection rays, and every candidate of each in turns beside the
   bound;
19. prints ptxas's register and spill lines for the triangle variants of
   the geometry kernel and of the march kernels;
20. builds obj_mesh at 800x800 on the in-repo 968-triangle torus
   (examples/media/torus968.obj) and checks its 968 packed triangles in
   121 chunks;
21. holds the geometry kernel against geometry_reference on 16,384 seeded
   radiance rays and 16,384 seeded screen rays of obj_mesh, then on both
   passes' full shapes (36,864 and 640,000 rays), where it counts the
   plain version's work for the bound, and the raycast, visibility and
   softshadow kernels against their plain versions on 16,384 mesh rays
   each (from the camera and the probes toward the torus's box);
22. renders obj_mesh at 32x32 with the tiny probes over 2 frames on the
   card and on the CPU and holds them to each other under the golden
   gates;
23. renders obj_mesh at 800x800 (5 timed frames after a warm-up), checks
   the image and 2 geometry launches per frame, reports ms/frame, rays/s,
   the per-pass split and the device busy time under torch.profiler, and
   times the geometry kernel at both passes' full shapes against its
   bound (the work of exact pruning, counted in phase 21 on the plain
   version at the same shapes) and against the unculled count, and the
   plain version on the subsets; holds the kernel with one box level
   (every super-chunk box opened, so it tests every chunk box in slot
   order) to the two-level kernel and times it between two runs of that.

25. the train step's loss gradient (parallel/spmd.py:make_value_and_grad:
   the frame rendered differentiable, the kernels under stop gradient)
   on the card and on the CPU from the same scene data and atlases, per
   float leaf by relative norm within GRAD_REL_LIMIT: GI mode 2 at 64x64,
   GI modes 1 and 3 and light_shafts (small volumetrics) at 32x32, with
   test_examples.py's tiny probes; checks that each kernel of each path
   launched;
26. the GI train step (parallel/spmd.py:make_train_step) at bench.py's
   sizes, 256x256 and 512x512, full width (36 probes x 32² texels), both
   ways: compiled (the step make_train_step gives on the kernel route,
   one CUDA graph a static key) and eager (inside pipeline.eager()); a
   warm-up step each, then 5 steps a turn timed with CUDA events in turns
   (eager, compiled, compiled, eager), and the differentiable forward
   alone as often, eager and through compiled_frame; reports ms/step,
   forward ms, backward+update ms each way, rays/s (the forward frame's
   rays), the capture's seconds and graph pool, each step's loss, the
   largest parameter change and the eager steps' peak memory, and fails
   on a non-finite loss, unmoved parameters or other than 2 geometry
   launches a step either way;
27. both train steps of phase 26 under torch.profiler, at each size and
   each way: the device's busy ms per step, its idle share under the
   profiler and by CUDA events (1 − busy / phase 26's ms per step), and
   the heaviest device ops of the forward and of the backward and
   update;
28. renders bvh_test (16 BVH spheres, the default probes) at 128x128 over
   2 frames through Renderer(device="cuda") and holds it to the JAX
   golden; checks that the scene takes the generic route (the plain
   marches over the batched scene distance) and that no hand-written
   kernel launched;
29. ball_game at 128x128 with the golden's script (a ball thrown, 2
   physics steps through eval_distance_to, 2 frames) held to the JAX
   golden, with 2 geometry launches a frame; then 12 more balls thrown
   (live slots 8 to 20, past LANES_MIN_SLOTS), a step and 2 frames, and
   fails if an nvcc build ran or a library was loaded after the first
   frame;
30. obj_mesh's baked mode on the torus: the 48^3 bake on the card, timed,
   held to a CPU bake of the same grid (distances to BAKE_ATOL); the
   scene at 32x32 with the tiny probes, 2 frames on the card and on the
   CPU under the golden gates;
31. ball_game at 800x800: a frame at 8 live slots (the screen pass at 1
   lane a ray), 12 balls thrown, a frame at 20 slots (8 lanes, the build
   the radiance pass loaded), failing on a build or a library load in
   that frame; the geometry kernel held to its plain version on its
   radiance and screen rays at 20 slots as in phase 3; then bvh_test,
   obj_mesh baked and ball_game at 800x800: a warm-up frame, then 2
   timed frames (the generic-route scenes) or 5 (ball_game), with
   ms/frame, rays/s, the launches per frame (none for the generic route,
   2 geometry launches for ball_game), the per-pass split, the device's
   busy time and idle share under torch.profiler (for obj_mesh baked and
   ball_game also as key_averages() sums the same trace) and, for the
   generic route, the plain primary march's mean and largest step count
   on the 640,000 screen rays;
32. the global_illumination room lit by a light without a vec3
   'position' at 800x800: the kernels take the scene, the geometry kernel
   does not, so the shade takes its unfused branches; 2 timed frames with
   3 raycast, 3 softshadows (k = 64) and 3 visibility (8 corners a
   point) launches a frame and none of geometry; one frame's launches
   recorded and each held to its plain version on its inputs (the three
   visibility launches also in every build of march_candidates, with
   their steps as in phase 8), the screen pass's three timed against
   their plain versions beside the bound; prints a scenes JSON line
   (phases 28-32);
33. the path tracers (render/pathtrace.py) on the global_illumination
   room at 800x800 at the reference's defaults (AO 3 steps, 100 samples,
   3 bounces, 300 steps): direct, many and path each a warm-up call, 2
   timed calls with the launches counted (raycast and softshadows 1,
   1 + 100 and 3 + 1 times per live light slot, no other kernel) and one
   call under torch.profiler; one call's launches recorded at SceneCtx
   and held to the plain versions on their inputs (every launch of direct
   and path, of many the primary query's and two seeded samples'), with
   the plain marches' steps and SIMT efficiency; one bounce launch of
   each kernel per mode timed against its plain version beside the
   bound; direct, and many at 4 samples from one CPU generator, at 32x32
   on the card and on the CPU under the golden gates;
34. a torch.distributed world of 1 over NCCL on the card: the GI frame at
   800x800 through make_sharded_render and through a RaySharder, both
   equal to Renderer.render()'s; the GI train step at 256x256 with and
   without the mesh, equal in loss and updated leaves; the GI scene, state
   and camera saved from the card and loaded back bit-equal, rendering
   the same next frame; a second process on the one card is not
   attempted; prints a pathtrace JSON line (phases 33-34);
35. the functions the port gained last, on the global_illumination room at
   800x800 after 4 frames: render/probes.py:sample_irradiance by its
   gather and by its matmul method on the screen pass's 640,000 points
   (pos = o + t·d and the normals of one geometry launch, its vis8, the
   converged irradiance atlas), held together to LOOKUP_ATOL and timed in
   turns; utils/profiling.py:trace(log_dir) around one frame, its
   *.pt.trace.json read back and its device events required to name the
   geometry kernel, with 2 geometry launches in that frame; a checkpoint
   of the scene loaded with spec.empty_data(device) as the template,
   bit-equal, rendering the same frame; FrameTimer.time_fn's ms/frame
   beside frame()'s; prints an api JSON line;
36. the geometry kernel's want_shadows / want_vis on the bench's
   global_illumination and obj_mesh at 800x800: with each flag off and
   with both, held to geometry_reference with the same flags on a seeded
   16,384-ray subset of the screen rays and on all radiance rays, at each
   lane count geometry_lanes picks for the scene, the skipped outputs all
   ones; the flags on bit-equal to the call without them; then
   tools/geom_probe.py's four variants timed on all 640,000 screen rays
   and their split (primary march + normal, AO, shadows, probe
   visibility); prints a geometry_flags JSON line;
37. python -m madarch_tpu_torch.bench in a subprocess (the builds of
   phase 2 reused): fails if it exits non-zero, if its JSON line lacks a
   key, if a configuration's frame_ms is not finite and positive, or if
   GI's launches per frame are not phase 5's, or if a train step was not
   compiled or its ms/step, either way, is not finite and positive;
   prints its line as {"bench": ...};
38. the box-exit cap (ops/march.py:ray_box_cap) on obj_mesh 800x800, the
   one all-bounded scene: the capped geometry kernel held to the capped
   plain version (the folded screen launch on the 16,384-ray subset, the
   radiance launch on all 36,864 rays), and at both full shapes against
   the launch with box_cap=False (equal on hits, a miss's t max_dist or
   the uncapped t), both timed in turns; raycast, visibility and (its
   march uncapped) softshadows held on the screen subset, raycast and
   visibility timed capped and uncapped on all 640,000 screen rays;
   geom_probe's split and the bench's obj_mesh row capped and uncapped;
   on the torus at 1000x1000, the bounces whose classification the
   geometry kernel skipped (a COUNT_WORK launch of each pass) against
   those its outputs say could not hit, idx -1 and mid 0 on them, and
   the folded screen launch and its misses alone timed beside the
   kernel's before the skip;
   the GI, light_shafts, simple_scene and obj_mesh 800x800 images
   bit-equal with the cap on and off (only obj_mesh packs a cap); prints
   a box_cap JSON line;
39. scenes past 48 KiB of staged tables (examples/large_scenes.py): 3,500
   spheres in the chunked layout (staged), a 12,000-triangle grid OBJ
   through obj_mesh (the geometry kernel's opt-in; the march kernels'
   device memory) and a 65,000-triangle grid (device memory), at 800x800:
   each scene's staged bytes and placement; the four kernels held to their
   plain versions on a seeded subset of the screen rays (LARGE_CHECK: the
   plain versions' [points, slots] intermediates grow with the slots), the
   geometry kernel at both lane counts without and with the fold and a
   mask, timed there against its plain version and its bound; at the full
   shapes every placement that holds the tables bit-equal and timed in
   turns (folded screen, radiance, raycast, visibility, softshadows); the
   sphere field's chunked run against the same spheres in one typed run
   (typed_spheres), bit-equal and timed; the sphere field and the mesh at
   32x32 on the card and on the CPU under the golden gates, and at 800x800
   (a warm-up, 3 timed frames, 2 geometry launches each, device busy and
   idle share under torch.profiler); prints a large_scenes JSON line;
40. the compiled frame (render/pipeline.py:compiled_frame), at 800x800 on
   GI modes 2, 1 and 3, light_shafts, simple_scene, obj_mesh (capped),
   ball_game dynamic (specialize_counts False: balls thrown between
   replays, no capture) and specialised (a capture a throw), and the
   3,500-sphere field, each from an empty cache: the eager first frame
   against the compiled one (eager warm-up, capture, replay), 20 replays
   each held bit for bit (image and state) to an eager frame on the same
   inputs, eager and compiled ms/frame in turns, device busy and idle
   share both ways under torch.profiler, the kernels' device events in a
   replayed frame held to the launches its capture recorded, capture
   seconds and graph pool MiB;
41. the compiled train step (parallel/spmd.py:CompiledStep): bench.py's
   GI step at 256x256 and 512x512, GI mode 1 (raycast and softshadows in
   the graph) and light_shafts (raycast and visibility) at 256x256, all at
   full width (36 probes of 32x32 texels; light_shafts' own volumetrics),
   each from a new make_train_step: the first step eager and
   compiled (warm-up, capture), 10 replays each with two eager steps on
   its own inputs and its launches counted, each held to an eager step
   (hold_step: the loss, new state and every updated leaf bit-equal but
   the material table's, whose gradients index_add sums with atomics;
   those within max(2 × the largest spread of the phase's eager pairs,
   1e-6) relative norm and GRAD_REL_LIMIT); 5 chained replays against two
   chains of 5 eager steps (every item within that bound: the chains part
   where an atomic sum flips an updated leaf's last bit); under
   deterministic algorithms 3 replays
   bit-equal to eager steps in every item; eager and compiled ms/step in
   turns, the trace's device events a replayed step held to the launches
   the capture recorded, capture seconds and graph pool MiB; prints a
   compiled JSON line (phases 40-41);
42. the shade's probe lookups (ops/probe_lookup.py, csrc/probes.cu) on
   the GI room's 1000x1000 screen pass after 4 frames, 10^6 points: the
   irradiance kernel held to sample_irradiance's gather (its plain
   version, PROBE_PLAIN_REL) and matmul (the dense route,
   PROBE_DENSE_REL), mode 2's radiance kernel held to
   sample_tile_bilinear at mip 1 and to the dense one-hot lookup; each
   timed in turns with both beside its bound; a replayed frame's
   launches (2 irradiance, 1 radiance); the eager frame by the kernel
   route against the dense route (PROBE_IMAGE_GAP); prints a
   probe_lookups JSON line;
43. the shade kernel (ops/shade_kernel.py, csrc/shade.cu) on the same
   10^6 GI screen points (mode 2) and the 36,864 probe rays (mode 0): the
   kernel held to the plain chain it replaces (shade_hits and
   pixel_color's tail on the same geometry and lookups, SHADE_PLAIN_REL),
   the kernel alone, the kernel route (lookups + kernel) and the plain
   chain timed in turns beside the kernel's bound in bytes; the device
   operations a replayed frame launches by both routes (torch.profiler);
   the 1000x1000 images and atlases of GI, light_shafts and the torus by
   both routes (PROBE_IMAGE_GAP); prints a shade JSON line;
44. the volumetric kernels (ops/volumetrics_kernel.py,
   csrc/volumetrics.cu) on light_shafts at 1000x1000 with upstream's
   volumetrics after 4 frames: the visibility pass (its froxel
   in-scatter), the scattering pass (its integral) and the composite,
   each by the kernel route and by the plain ops, held bit for bit
   (VOL_PLAIN_REL) and timed in turns beside the kernel alone on the
   pass's inputs and its bound in bytes; a replayed frame's device
   operations and busy ms by both routes, each kernel launched once (the
   in-scatter once a light slot); prints a volumetrics JSON line.

Renderer.render() runs the compiled frame on the kernel route: a scene's
first frame runs an eager warm-up and captures the frame into a CUDA
graph, later frames replay it, and each replay adds the captured launches
to the wrappers' counts (ops/launch.py:add_launches).  So the timed and
counted frames of phases 5, 10, 17, 23, 31 and 39 are replays; a phase
that records the wrappers' inputs during a frame (32) renders it inside
pipeline.eager(), and one that patches the packing (38) drops the
compiled frames at its edges.

The geometry kernel shares a ray among a group of lanes
(ops/csrc/scene.cuh).  At every full shape above (phases 3, 16, 21) and on
the masked launch (phase 14) each lane count the wrapper can choose
(ops/march.py:LANE_CHOICES) is held to the plain version, and each of
TIMED_LANES is timed in turns beside the bound (phases 3, 16, 23); on
obj_mesh a COUNT_WORK build reports the box tests and triangles the kernel
itself evaluated, beside the plain version's count of what exact pruning
needs (phase 23).

The raycast, visibility and softshadow kernels run one thread a ray, in
the build of march.cu for the scene's layout where it has one
(ops/march.py:march_layout; the room scenes), else the generic build.
The padded layouts time that choice at march_layout's limit and past it:
the room with inert slots appended (pad_scene) marches as the room does,
so either build's outputs are the plain version's on the room.

(Phase 6 of earlier versions, the geometry kernel at the full shapes, is
part of phase 3.)

Each kernel's bound is the larger of its bytes over 3.35 TB/s and the
float operations of its scene evaluations (counted on the plain version
over the same rays; for triangles, the super-chunk box tests, the chunk
box tests inside the admitted super-chunks and the triangles of the
chunks exact pruning must admit) over 67 TFLOP/s, the H100 SXM's
published fp32 peak.
It prints a train JSON line (phases 25-27), a scenes JSON line (phases
28-32), a pathtrace JSON line (phases 33-34), an api JSON line (phase 35),
a geometry_flags JSON line (phase 36), a bench JSON line (phase 37), a
box_cap JSON line (phase 38), a large_scenes JSON line (phase 39), a
compiled JSON line (phases 40-41), a probe_lookups JSON line (phase 42), a
shade JSON line (phase 43), a volumetrics JSON line (phase 44), a kernels
JSON line, the card line, then
the last line {"ok": true, "device": {...}}.  Imports no JAX.
"""
import contextlib
import dataclasses
import glob
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

REPO = os.path.dirname(os.path.abspath(__file__))
# Kernel vs plain version: discrete outputs (hit, indices, material ids,
# the best-probe pick, visibility) may flip only at near-ties, on at most
# this share of rays; continuous outputs agree to this absolute error on
# the other rays.
DISCRETE_MAX_FRAC = 1e-3
CONT_ATOL = 1e-4
CHECK_RAYS = 16384
SEED = 0
# H100 SXM published peaks: HBM bandwidth and fp32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# Lanes per ray the geometry kernel is timed at beside the wrapper's choices
# (ops/march.py:LANE_CHOICES): 32, a whole warp per ray, is measured and
# not chosen anywhere.
TIMED_LANES = (1, 8, 32)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def port_modules():
    """The port's modules this script drives, imported together (a test
    imports them with JAX blocked)."""
    from madarch_tpu_torch import bench
    from madarch_tpu_torch.core.config import (PROBE_SHADE_CONFIG,
                                               ProbeSettings, ShadeConfig,
                                               VolumetricsSettings)
    from madarch_tpu_torch.core.vecmath import length, reflect
    from madarch_tpu_torch.examples import large_scenes
    from madarch_tpu_torch.examples import scenes
    from madarch_tpu_torch.ops import build
    from madarch_tpu_torch.ops import launch
    from madarch_tpu_torch.ops import march
    from madarch_tpu_torch.ops import probe_lookup
    from madarch_tpu_torch.ops import shade_kernel
    from madarch_tpu_torch.ops import volumetrics_kernel
    from madarch_tpu_torch.parallel import spmd
    from madarch_tpu_torch.render import pipeline
    from madarch_tpu_torch.render import lighting
    from madarch_tpu_torch.render import pathtrace
    from madarch_tpu_torch.render import probes
    from madarch_tpu_torch.render import raymarch
    from madarch_tpu_torch.render import shading
    from madarch_tpu_torch.render import volumetrics
    from madarch_tpu_torch.render.camera import camera_rays, pixel_grid
    from madarch_tpu_torch.render.context import SceneCtx
    from madarch_tpu_torch.render.raymarch import SURFACE_OFFSET
    from madarch_tpu_torch.render.renderer import Renderer
    from madarch_tpu_torch.scene import lights
    from madarch_tpu_torch.scene import mesh
    from madarch_tpu_torch.scene.scene import (SceneBuilder,
                                               material_lookup, tree_items,
                                               tree_leaves, tree_map)
    from madarch_tpu_torch.tools import geom_probe
    from madarch_tpu_torch.utils import checkpoint
    from madarch_tpu_torch.utils.golden import image_stats
    from madarch_tpu_torch.utils.profiling import (FrameTimer,
                                                   averaged_busy,
                                                   device_ops,
                                                   kernel_events, kernel_ops,
                                                   rays_per_frame, trace,
                                                   trace_calls)
    return SimpleNamespace(
        PROBE_SHADE_CONFIG=PROBE_SHADE_CONFIG, ProbeSettings=ProbeSettings,
        ShadeConfig=ShadeConfig, VolumetricsSettings=VolumetricsSettings,
        length=length, reflect=reflect, S=scenes, build=build, M=march,
        launch=launch, PL=probe_lookup, SK=shade_kernel,
        VK=volumetrics_kernel,
        spmd=spmd, pipeline=pipeline, lighting=lighting, PT=pathtrace,
        checkpoint=checkpoint, SceneBuilder=SceneBuilder,
        tree_leaves=tree_leaves,
        probes=probes, rm=raymarch, shading=shading, vol=volumetrics,
        Renderer=Renderer, lights=lights, mesh=mesh,
        camera_rays=camera_rays, pixel_grid=pixel_grid, SceneCtx=SceneCtx,
        SURFACE_OFFSET=SURFACE_OFFSET, material_lookup=material_lookup,
        tree_items=tree_items, tree_map=tree_map,
        image_stats=image_stats, FrameTimer=FrameTimer,
        averaged_busy=averaged_busy, device_ops=device_ops,
        kernel_ops=kernel_ops, kernel_events=kernel_events, trace=trace,
        trace_calls=trace_calls,
        rays_per_frame=rays_per_frame, bench=bench, geom_probe=geom_probe,
        LS=large_scenes)


def toolchain(torch, m):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    nvcc = subprocess.run([m.build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    print(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    return card


def build_all(m):
    """Builds every library this script launches at once (one nvcc each, in
    parallel): march.cu at each of MARCH_LAYOUTS; geometry.cu at each of
    TIMED_LANES and, at the lane counts the wrapper can choose, with
    COUNT_WORK; probes.cu."""
    M = m.M
    builds = [(f"march.cu {' '.join(M.march_defines(c))}".strip(),
               lambda c=c: M.march_library(c)) for c in MARCH_LAYOUTS]
    builds += [(f"geometry.cu {x} lanes", lambda x=x: M.geometry_library(x))
               for x in TIMED_LANES]
    builds += [(f"{name}.cu", lambda name=name: m.launch.library(name))
               for name in ("probes", "volumetrics")]
    builds += [(f"geometry.cu {x} lanes COUNT_WORK",
                lambda x=x: M.geometry_library(x, count_work=True))
               for x in M.LANE_CHOICES]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda b: b[1](), builds))
    print("build: " + ", ".join(name for name, _ in builds)
          + f" in {time.perf_counter() - t0:.2f} s ({m.build.load.build_s:.1f}"
          f" s of nvcc summed over the builds)")


def ptxas_lines(m, name, kernel="", defines=()):
    """ptxas's register and spill lines of csrc/<name>.cu built with the
    macros ``defines``, each tagged with the kernel it reports on; only
    the kernels whose (mangled) name holds ``kernel`` (or one of them, a
    tuple)."""
    entry = "?"
    tag = f"{name} {' '.join(defines)}".strip()
    kernels = (kernel,) if isinstance(kernel, str) else kernel
    for line in m.build.build_log(name, defines).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif ("registers" in line or "spill" in line) and any(
                k in entry for k in kernels):
            print(f"ptxas {tag} {entry}: {line.strip()}")


# march.cu's builds (march_library's layouts): the generic one (None), the
# room scenes' layout (march_layout: 1 sphere, 6 planes, 1 box; 9 float4
# rows), and the room padded with inert slots to march_layout's limit of
# UNROLL_ROWS_MAX (20 rows: 4,8,4) and past it (32 rows: 8,8,8), each timed
# against the generic build on the same padded scene.
ROOM_LAYOUT = (1, 6, 1)
PADDED_LAYOUTS = ((4, 8, 4), (8, 8, 8))
MARCH_LAYOUTS = (None, ROOM_LAYOUT) + PADDED_LAYOUTS


def march_ptxas(m, kernel):
    for layout in MARCH_LAYOUTS:
        ptxas_lines(m, "march", kernel, m.M.march_defines(layout))


def lanes_def(lanes):
    return (f"LANES={lanes}",)


def gi_rays(torch, m, r, dev):
    """(radiance-pass rays, screen-pass rays) of the GI renderer, each a
    seeded subset of CHECK_RAYS rays, then both passes' full ray sets."""
    rr = r.probes.radiance_resolution
    o_rad = m.probes.probe_world_positions(r.probes, dev).repeat(rr * rr, 1)
    d_rad = m.probes.texel_directions(rr, dev).repeat_interleave(
        r.probes.num_probes, dim=0)
    o_scr, d_scr = m.bench.screen_rays(r)
    g = torch.Generator().manual_seed(SEED)

    def subset(o, d):
        ids = torch.randperm(o.shape[0], generator=g)[:CHECK_RAYS].to(dev)
        return o[ids].contiguous(), d[ids].contiguous()

    return (subset(o_rad, d_rad), subset(o_scr, d_scr),
            (o_rad.contiguous(), d_rad.contiguous()),
            (o_scr.contiguous(), d_scr.contiguous()))


def compare(torch, k, ref):
    """Kernel outputs k vs plain outputs ref: (max discrete mismatch
    share, max abs error of the continuous outputs on agreeing rays).
    A material id is held on its bounce's hits; off them the kernel's is
    the plain version's where it classified the bounce, else 0
    (ops/march.py:geometry), and one that is neither counts against it."""
    refl = ref["refl"] is not None
    hits = {"mid": ref["hit"]}
    discrete = [("hit", k["hit"], ref["hit"]), ("idx", k["idx"], ref["idx"]),
                ("mid", k["mid"], ref["mid"])]
    if refl:
        kr, rr = k["refl"], ref["refl"]
        hits["r_mid"] = rr["hit"]
        discrete += [("r_hit", kr["hit"], rr["hit"]),
                     ("r_mid", kr["mid"], rr["mid"]),
                     ("best_pid", kr["best_pid"], rr["best_pid"])]
    agree = torch.ones_like(ref["hit"])
    shares = {}
    for name, a, b in discrete:
        same = a == b
        if name in hits:
            same |= ~hits[name] & (a == 0)
        shares[name] = 1.0 - same.float().mean().item()
        agree &= same
    hit = agree & ref["hit"]
    cont = [("t", k["t"], ref["t"], agree),
            ("normal", k["normal"], ref["normal"], hit[:, None]),
            ("ao", k["ao"], ref["ao"], hit),
            ("shadows", k["shadows"], ref["shadows"], hit[None]),
            ("vis8", k["vis8"], ref["vis8"], hit[None])]
    if refl:
        rhit = agree & rr["hit"]
        cont += [("r_t", kr["t"], rr["t"], agree),
                 ("r_normal", kr["normal"], rr["normal"], rhit[:, None]),
                 ("r_shadows", kr["shadows"], rr["shadows"], rhit[None]),
                 ("r_vis8", kr["vis8"], rr["vis8"], rhit[None]),
                 ("best_dir", kr["best_dir"], rr["best_dir"],
                  rhit[:, None])]
    errs = {}
    for name, a, b, mask in cont:
        diff = torch.where(mask, (a - b).abs(), 0.0)
        errs[name] = diff.max().item() if diff.numel() else 0.0
    return shares, errs


def check(label, n_rays, n_hits, shares, errs):
    """Print the kernel-vs-plain agreement and fail beyond the limits;
    returns the largest continuous difference."""
    print(f"check {label}: {n_rays} rays, {n_hits} hits; "
          f"discrete mismatch {json.dumps(shares)}; "
          f"max abs err {json.dumps(errs)}")
    worst = max(shares.values())
    if worst > DISCRETE_MAX_FRAC:
        fail(f"{label}: discrete outputs differ on {worst:.2e} of rays "
             f"(limit {DISCRETE_MAX_FRAC})")
    largest = max(errs.values(), default=0.0)
    if largest > CONT_ATOL:
        fail(f"{label}: continuous outputs differ by {largest:.2e} "
             f"(limit {CONT_ATOL})")
    return largest


def check_geometry(torch, label, n_rays, k, ref):
    shares, errs = compare(torch, k, ref)
    return check(label, n_rays, int(ref["hit"].sum()), shares, errs)


def cuda_ms(torch, fn, iters):
    """Mean ms of fn() over iters launches between two CUDA events, after
    as many warm-up calls: a launch of 0.07 ms read twice that after one
    warm-up behind a plain version's run of many small ops."""
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def counted(torch, m, fn):
    """(fn(), float operations of its scene evaluations): fn runs a plain
    version, whose evaluations ops/march.py counts (triangles as exact
    pruning must evaluate them)."""
    with m.M.counting():
        out = fn()
        torch.cuda.synchronize()
    return out, m.M.scene_eval_flops()


def bound(flops, n_bytes):
    """(ms, what bounds it): the least time the card could take."""
    t_ops = flops / PEAK_FP32_PER_S
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def time_pair(torch, kernel, plain, iters=10):
    """Kernel and plain version timed in turns (plain, kernel, kernel,
    plain): ((kernel ms, kernel ms), (plain ms, plain ms))."""
    plain1 = cuda_ms(torch, plain, 1)
    kern1 = cuda_ms(torch, kernel, iters)
    kern2 = cuda_ms(torch, kernel, iters)
    plain2 = cuda_ms(torch, plain, 1)
    return (kern1, kern2), (plain1, plain2)


def time_turns(torch, fns, iters=10):
    """Each of fns timed twice, in turns (a, b, ..., b, a): the lower ms
    of each."""
    first = [cuda_ms(torch, fn, iters) for fn in fns]
    second = [cuda_ms(torch, fn, iters) for fn in reversed(fns)][::-1]
    return [min(a, b) for a, b in zip(first, second)]


def scene_bytes(packed):
    """Bytes of the packed scene's tables."""
    return 4 * (packed.rows.numel() + packed.info.numel()
                + packed.chunks.numel() + packed.aabbs.numel()
                + packed.cap_boxes.numel())


def time_lanes(torch, m, run, packed, n, label, bound_txt, card):
    """The geometry kernel at each of TIMED_LANES lanes per ray, in turns;
    run(library) launches it.  Returns ({lanes: ms}, the wrapper's
    choice)."""
    ms = dict(zip(TIMED_LANES, time_turns(
        torch, [lambda x=x: run(m.M.geometry_library(x))
                for x in TIMED_LANES])))
    chosen = m.M.geometry_lanes(packed, n)
    print(f"lanes {label} ({n} rays): "
          + ", ".join(f"{x} lanes {t:.3f} ms" for x, t in ms.items())
          + f"; the wrapper launches {chosen}; {bound_txt}; [{card}]")
    return ms, chosen


def step_stats(torch, label, steps):
    """The march steps of a launch's rays (the plain version's count):
    mean, the 50/90/95/99% quantiles, largest, and the SIMT efficiency of
    one thread a ray, a warp of 32 consecutive rays waiting for its
    slowest: sum of steps / sum over warps of 32 x the warp's largest.
    Printed and returned."""
    s = steps.to(torch.int64)
    w = torch.nn.functional.pad(s, (0, -s.numel() % 32))
    qs = torch.quantile(s.float(), torch.tensor(
        [0.5, 0.9, 0.95, 0.99], device=s.device)).tolist()
    out = {"rays": s.numel(), "marched": int((s > 0).sum()),
           "mean": float(s.float().mean()),
           "quantiles": dict(zip(("50", "90", "95", "99"), qs)),
           "max": int(s.max()), "total": int(s.sum())}
    out["simt"] = out["total"] / (32 * int(w.reshape(-1, 32).amax(dim=1)
                                             .sum()))
    print(f"steps {label}: {out['rays']} rays, {out['marched']} marched, "
          f"mean {out['mean']:.3f}, quantiles 50/90/95/99% "
          + "/".join(f"{q:g}" for q in qs) + f", max {out['max']}, total "
          f"{out['total']}; SIMT efficiency {out['simt']:.4f} at one lane "
          f"a ray")
    return out


def pad_scene(torch, m, packed, counts):
    """The packed scene (no triangles) with inert slots appended to its
    typed runs up to counts (spheres, planes, boxes), each packed as
    pack_scene packs a dead dynamic-count slot, and to the plain versions'
    columns: the same scene distances from more slots a step."""
    M = m.M
    big = M.BIG
    add = [c - have for c, have in zip(counts, packed.counts)]
    if packed.n_chunks or min(add) < 0:
        fail(f"cannot pad layout {packed.counts} to {counts}")
    dev = packed.rows.device
    dead = [((0.0, 0.0, 0.0, -big),), ((0.0, 0.0, 0.0, big),),
            ((0.0, 0.0, 0.0, 0.0), (-big, -big, -big, 0.0))]
    rows, info = [], []
    row = slot = 0
    for code, n in enumerate(packed.counts):
        # a box's run is every center, then every half-side
        for blank in dead[code]:
            rows += [packed.rows[row:row + n],
                     torch.tensor(blank, device=dev).expand(add[code], 4)]
            row += n
        info += [packed.info[slot:slot + n],
                 torch.zeros((add[code], 2), dtype=torch.int32, device=dev)]
        slot += n
    first = [0, counts[0], counts[0] + counts[1]]
    entries, gidx, mid = [], [], []
    col = 0
    for ptype, _, n, static in packed.entries:
        code = M.KERNEL_TYPES[ptype][0]
        entries.append((ptype, first[code], counts[code], static))
        for out, cols in ((gidx, packed.col_gidx), (mid, packed.col_mid)):
            out += [cols[col:col + n],
                    torch.zeros(add[code], dtype=cols.dtype, device=dev)]
        col += n
    col_gidx = torch.cat(gidx)
    return dataclasses.replace(
        packed, entries=tuple(entries), rows=torch.cat(rows).contiguous(),
        counts=tuple(counts), info=torch.cat(info).contiguous(),
        col_gidx=col_gidx, col_mid=torch.cat(mid),
        col_slot=torch.full_like(col_gidx, -1, dtype=torch.int64))


def layout_name(counts):
    return ",".join(map(str, counts))


def march_candidates(torch, m, packed):
    """{name: (march.cu build, packed scene)}: the generic build and, on a
    scene with a layout (march_layout), the layout's build the wrappers
    launch, then the scene padded to each of PADDED_LAYOUTS in the generic
    build and in the padded layout's."""
    M = m.M
    layout = M.march_layout(packed)
    out = {"generic": (M.march_library(), packed)}
    if layout is None:
        return out
    out[f"layout {layout_name(layout)}"] = (M.march_library(layout), packed)
    for counts in PADDED_LAYOUTS:
        padded = pad_scene(torch, m, packed, counts)
        out[f"generic, padded to {layout_name(counts)}"] = (
            M.march_library(), padded)
        out[f"layout {layout_name(counts)}, padded"] = (
            M.march_library(counts), padded)
    return out


def launched(m, packed):
    """The candidate the wrappers launch on this scene."""
    layout = m.M.march_layout(packed)
    return "generic" if layout is None else f"layout {layout_name(layout)}"


def check_raycast(torch, label, k, ref):
    """The raycast kernel's (t, hit) against the plain version's; returns
    the largest |t| difference on rays whose hit agrees."""
    (kt, khit), (rt, rhit) = k[:2], ref[:2]
    agree = khit == rhit
    err = float(torch.where(agree, (kt - rt).abs(), 0.0).max())
    check(label, kt.shape[0], int(rhit.sum()),
          {"hit": 1.0 - agree.float().mean().item()}, {"t": err})
    return err


def check_visibility(torch, label, k, ref):
    """The visibility kernel's 0/1 against the plain version's; returns
    the largest difference."""
    check(label, k.shape[0], int((ref == 0).sum()),
          {"vis": 1.0 - (k == ref).float().mean().item()}, {})
    return float((k - ref).abs().max())


def check_softshadows(torch, label, k, ref):
    """The softshadow kernel's factors against the plain version's;
    returns the largest difference on rays blocked on both or neither."""
    same = (k == 0) == (ref == 0)
    err = float(torch.where(same, (k - ref).abs(), 0.0).max())
    check(label, k.shape[0], int((ref == 0).sum()),
          {"blocked": 1.0 - same.float().mean().item()}, {"res": err})
    return err


def hold_builds(torch, label, run, ref, check_fn, cands):
    """Holds the kernel run(library, packed) at each of cands
    (march_candidates) to the plain outputs ref; returns the largest
    difference."""
    err = 0.0
    for name, (lib, packed) in cands.items():
        k = run(lib, packed)
        torch.cuda.synchronize()
        err = max(err, check_fn(torch, f"{label}, {name}", k, ref))
        del k
    return err


def time_builds(torch, m, run, label, n, b_ms, card, cands, packed):
    """The kernel run(library, packed) at each of cands (march_candidates
    on packed), timed in turns beside the bound: {name: ms}."""
    ms = dict(zip(cands, time_turns(
        torch, [lambda c=c: run(*c) for c in cands.values()])))
    print(f"builds {label} ({n} rays): "
          + ", ".join(f"{k} {t:.4f} ms" for k, t in ms.items())
          + f"; the wrapper launches {launched(m, packed)}; bound "
          f"{b_ms:.5f} ms; [{card}]")
    return ms


KERNELS = ("geometry", "raycast", "visibility", "softshadows")
# The launch counts (ops/launch.py) at the last reset_launches.
_launch_base = {}


def reset_launches(m):
    _launch_base.update(m.M.launch_counts())


def launch_counts(m):
    """The march kernels' launches since the last reset_launches."""
    now = m.M.launch_counts()
    return {name: now[name] - _launch_base.get(name, 0) for name in KERNELS}


def hold_golden(m, img, goldens, name, label):
    stats = m.image_stats(img, goldens[name])
    print(f"golden {label}: {json.dumps(stats)}")
    if stats["breached"]:
        fail(f"{label} golden gates breached: {stats['breached']}")


def drive(torch, m, r, label, frames, per_frame, card):
    """The main path of renderer r: a warm-up frame (on the kernel route
    the capture of the compiled frame), then ``frames`` frames (replays)
    timed with CUDA events, the launch counts set to 0 just before and read
    just after.  Fails unless each kernel launched per_frame[name] (0 if
    absent) times per frame and the last image is finite with nonzero
    variance.  Returns (the launches, ms/frame, rays/s)."""
    r.render()
    timer = m.FrameTimer(r.device)
    reset_launches(m)
    for _ in range(frames):
        with timer.frame():
            img = r.render()
    launches = launch_counts(m)
    img = img.cpu()
    want = {name: per_frame.get(name, 0) * frames for name in KERNELS}
    if launches != want:
        fail(f"{label}: launches {launches} in {frames} frames, expected "
             f"{want}")
    if not bool(torch.isfinite(img).all()) or float(img.var()) <= 0.0:
        fail(f"{label} image is not finite with nonzero variance")
    n_lights = m.M.pack_light_positions(r.spec, r.scene_data)[1]
    n_rays = m.rays_per_frame(r.width, r.height, r.probes, n_lights,
                              r.screen_cfg, r.volumetrics)
    print(f"{label}: {frames} frames, {timer.mean * 1e3:.3f} ms/frame "
          f"({', '.join(f'{t * 1e3:.3f}' for t in timer.times)}), "
          f"{n_rays / timer.mean / 1e6:.1f} M rays/s ({n_rays} rays/frame); "
          f"launches {json.dumps(launches)}; "
          f"image mean {float(img.mean()):.5f} var {float(img.var()):.6f}; "
          f"[{card}]")
    return launches, timer.mean * 1e3, n_rays / timer.mean


def profile_frames(m, r, label, card, frames=3, averaged=False):
    """Renderer r's frames under torch.profiler: prints the device's busy
    time per frame (the trace's device events, utils/profiling.py:
    kernel_ops), the idle share and the heaviest ops; with ``averaged``
    also the same trace's busy time as key_averages() sums it.  Returns
    (busy, wall, the key_averages busy or None) ms per frame."""
    prof, wall = m.trace_calls(r.render, frames)
    ops = m.kernel_ops(prof, frames)
    busy = sum(ops.values())
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:5]
    print(f"{label} under torch.profiler ({frames} frames): device busy "
          f"{busy:.3f} ms/frame of {wall:.3f} ms/frame, idle share "
          f"{1.0 - busy / wall:.3f}; heaviest: "
          + "; ".join(f"{name[:60]} {ms:.3f}" for name, ms in top)
          + f"; [{card}]")
    avg = None
    if averaged:
        t0 = time.perf_counter()
        avg = m.averaged_busy(prof, frames)
        print(f"{label}, the same trace summed by key_averages(): device "
              f"busy {avg:.3f} ms/frame, idle share {1.0 - avg / wall:.3f} "
              f"(the device events: {busy:.3f}, {1.0 - busy / wall:.3f}); "
              f"the parse took {time.perf_counter() - t0:.1f} s")
    return busy, wall, avg


def ls_rays(torch, m, r):
    """light_shafts' scattering rays (o, d), the froxel-to-light rays
    (pts, ldir, ldist) of its one light, and its radiance at the froxels
    and their camera rays' directions (radiance, dirs), built as the
    passes build them."""
    vol = r.volumetrics
    cam = r.camera
    dev = r.device
    sx, sy = vol.scattering_resolution
    o, d = m.camera_rays(m.pixel_grid(sx, sy, dev), cam.position,
                         cam.orientation)
    vx, vy, vz = vol.visibility_resolution
    fo, fd = m.camera_rays(m.pixel_grid(vx, vy, dev), cam.position,
                           cam.orientation)
    depths = torch.arange(vz, dtype=torch.float32, device=dev) \
        * vol.visibility_step_size
    pts = (fo[None] + fd[None] * depths[:, None, None, None]).reshape(-1, 3)
    (ltype, _, n, _), = r.spec.light_bounds()
    if n != 1:
        fail(f"light_shafts has {n} live lights, expected 1")
    params = {k: v[0] for k, v in r.scene_data.lights[ltype.name].items()}
    radiance, ldir, ldist = ltype.sample(params, pts, torch.zeros_like(pts))
    dirs = fd[None].expand(vz, vy, vx, 3).reshape(-1, 3)
    return ((o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()),
            (pts.contiguous(), ldir.contiguous(), ldist.contiguous()),
            (radiance, dirs))


def pass_split(torch, m, r, frames):
    """ms per pass of renderer r's frame (CUDA events), mean over frames:
    the passes of pipeline.render_frame called one by one and, with
    volumetrics, the composite alone on a frame's scattering map."""
    P = m.pipeline
    spec, data, cam, vol, cfg = (r.spec, r.scene_data, r.camera,
                                 r.volumetrics, r.screen_cfg)
    state = r.state
    names = ["radiance", "irradiance"] + (
        ["visibility", "scattering"] if vol.enabled else []) + ["screen"]
    sums = dict.fromkeys(names, 0.0)
    for _ in range(frames):
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(names) + 1)]
        ev[0].record()
        rad = P.radiance_pass(spec, data, r.probes, r.probe_cfg,
                              state.irradiance, state.radiance)
        ev[1].record()
        irr = m.probes.integrate_irradiance(r.probes, rad)
        ev[2].record()
        scat = state.scattering
        if vol.enabled:
            ctx = m.SceneCtx(spec, data)
            vis = m.vol.visibility_pass(spec, data, vol, ctx, cam.position,
                                        cam.orientation,
                                        max_steps=cfg.max_march_steps)
            ev[3].record()
            scat = m.vol.scattering_pass(spec, data, vol, ctx, vis,
                                         cam.position, cam.orientation,
                                         max_steps=cfg.max_march_steps)
            ev[4].record()
        P.screen_pass(spec, data, r.probes, vol, cfg, r.width, r.height,
                      cam, irr, rad, scat)
        ev[-1].record()
        ev[-1].synchronize()
        for i, name in enumerate(names):
            sums[name] += ev[i].elapsed_time(ev[i + 1])
        state = P.FrameState(radiance=rad, irradiance=irr, scattering=scat)
    split = {k: v / frames for k, v in sums.items()}
    if not vol.enabled:
        return split
    # the composite alone, on the last scattering map with seeded colors
    # and ray lengths (screen above includes it)
    n = r.width * r.height
    g = torch.Generator(device=r.device).manual_seed(SEED)
    color = torch.rand((n, 3), generator=g, device=r.device)
    ray_len = torch.rand(n, generator=g, device=r.device) * vol.max_depth
    split["composite"] = cuda_ms(
        torch, lambda: m.vol.composite(vol, state.scattering, color,
                                       ray_len, r.width, r.height,
                                       spec.max_dist), frames)
    return split


def geometry_passes(torch, m, r, label, card):
    """The geometry kernel against its plain version on renderer r's
    radiance-pass rays (no reflection) and screen-pass rays (its screen
    config; the reflection folded in for mode 2): seeded subsets of
    CHECK_RAYS rays, then both passes' full ray sets, where every lane
    count the wrapper can choose is held to the plain version and the
    kernel is timed with its bound, as the wrapper launches it and at each
    of TIMED_LANES.  Returns ({pass: ms, plain_ms, bound_ms, bound_by,
    lanes, ms_by_lanes, launch}, largest continuous difference); launch(
    library) launches the kernel at the pass's full shape."""
    M = m.M
    ctx = m.SceneCtx(r.spec, r.scene_data)
    rad_check, scr_check, rad_full, scr_full = gi_rays(torch, m, r, r.device)
    passes = {"radiance": (m.PROBE_SHADE_CONFIG, False),
              "screen": (r.screen_cfg,
                         r.screen_cfg.indirect_specular_mode == 2)}

    def run(fn, rays, name, **measure):
        cfg, refl = passes[name]
        return fn(ctx.packed, ctx.lpos_vec, ctx.n_light_slots, rays[0],
                  rays[1], ctx.max_dist, probe_spacing=r.probes.grid_spacing,
                  probe_dims=r.probes.grid_dimensions,
                  surface_offset=m.SURFACE_OFFSET,
                  ao_steps=cfg.ambient_occlusion_steps,
                  max_steps=cfg.max_march_steps,
                  mat_rough_vec=ctx.rough_vec if refl else None,
                  refl_shadows=cfg.add_indirect_specular, **measure)

    max_err = 0.0
    for name, rays in (("radiance", rad_check), ("screen", scr_check)):
        k = run(M.geometry, rays, name)
        torch.cuda.synchronize()
        ref = run(M.geometry_reference, rays, name)
        torch.cuda.synchronize()
        max_err = max(max_err, check_geometry(
            torch, f"{label}{name}", rays[0].shape[0], k, ref))

    geo = {}
    for name, rays in (("radiance", rad_full), ("screen", scr_full)):
        n = rays[0].shape[0]
        ref, flops = counted(torch, m,
                             lambda: run(M.geometry_reference, rays, name))
        for lanes in M.LANE_CHOICES:
            k = run(M.geometry, rays, name,
                    library=M.geometry_library(lanes))
            torch.cuda.synchronize()
            max_err = max(max_err, check_geometry(
                torch, f"{label}{name} full, {lanes} lanes", n, k, ref))
            del k
        del ref
        (k1, k2), (p1, p2) = time_pair(
            torch, lambda: run(M.geometry, rays, name),
            lambda: run(M.geometry_reference, rays, name))
        refl = passes[name][1]
        n_l = ctx.n_light_slots
        # per ray in: o, d; out: t, hit, idx, mid, normal, ao, shadows,
        # vis8, and with the reflection its t, hit, mid, normal, shadows,
        # vis8, best_pid, best_dir; the scene, lights, roughness once
        per_ray = 24 + 4 * (10 + n_l + 8) + (4 * (14 + n_l + 8) if refl
                                             else 0)
        n_bytes = n * per_ray + scene_bytes(ctx.packed) + 4 * (
            ctx.lpos_vec.numel() + ctx.rough_vec.numel())
        b_ms, b_by = bound(flops, n_bytes)
        print(f"time geometry {label}{name} ({n} rays): kernel "
              f"{k1:.3f}/{k2:.3f} ms, plain {p1:.1f}/{p2:.1f} ms; bound "
              f"{b_ms:.5f} ms ({b_by}: {flops:.4e} flops, {n_bytes} "
              f"bytes); [{card}]")

        def launch(library, rays=rays, name=name):
            return run(M.geometry, rays, name, library=library)

        by_lanes, chosen = time_lanes(
            torch, m, launch, ctx.packed, n, f"{label}{name}",
            f"bound {b_ms:.5f} ms", card)
        geo[name] = dict(ms=min(k1, k2), plain_ms=min(p1, p2),
                         bound_ms=b_ms, bound_by=b_by, lanes=chosen,
                         ms_by_lanes=by_lanes)
    return geo, max_err


def reflection_rays(torch, m, r, o, d):
    """Specular modes 1 and 3's reflection rays for renderer r's screen
    rays o, d, built as shading.shade_hits builds them: the primary
    geometry launch (not counted on any path), the roughness < 0.75 gate,
    the origin off the surface and the reflected direction.  Returns
    (hit points, origins, directions, enabled)."""
    ctx = m.SceneCtx(r.spec, r.scene_data)
    g = ctx.geometry(o, d, r.probes, r.screen_cfg)
    pos = o + g["t"][:, None] * d
    _, _, rough = m.material_lookup(r.scene_data, g["mid"])
    return (pos, (pos + g["normal"] * m.SURFACE_OFFSET).contiguous(),
            m.reflect(d, g["normal"]).contiguous(),
            g["hit"] & (rough < 0.75))


# test_examples.py's tiny probes, for the card-against-CPU frames.
TINY_PROBES = dict(radiance_resolution=8, irradiance_resolution=4,
                   probe_count=(4, 2), grid_dimensions=(2, 2, 2),
                   grid_spacing=(4.0, 4.0, 4.0))


def mesh_rays(torch, m, r, dev, n, seed):
    """n seeded rays of obj_mesh's renderer r, half from the camera, half
    from the camera or a probe position, toward points of the mesh's
    bounding box (most hit it)."""
    g = torch.Generator().manual_seed(seed)
    tri = r.scene_data.prims["triangle"]
    n_tri = r.builder._prim_counts["triangle"]
    v = torch.cat([tri[k][:n_tri] for k in ("v1", "v2", "v3")]).cpu()
    lo, hi = v.amin(0), v.amax(0)
    cam = torch.as_tensor(r.camera_position)
    starts = torch.cat([cam[None],
                        m.probes.probe_world_positions(r.probes, "cpu")])
    o = starts[torch.randint(0, starts.shape[0], (n,), generator=g)]
    o[: n // 2] = cam
    d = lo + torch.rand(n, 3, generator=g) * (hi - lo) - o
    d = d / d.norm(dim=1, keepdim=True)
    return o.to(dev).contiguous(), d.to(dev).contiguous()


def mesh_phases(torch, m, dev, card):
    """Phases 19-23, obj_mesh on the 968-triangle torus.  Returns the
    geometry kernel's obj_mesh numbers, the march kernels' largest
    differences on mesh rays and the launches of the 800x800 frames."""
    M, S = m.M, m.S

    # ---- 19. ptxas's report for the triangle variants (template
    # arguments CHUNKS = TRI_CHUNKS, STAGED true)
    for lanes in M.LANE_CHOICES:
        ptxas_lines(m, "geometry", "Li1ELb1EEEv", lanes_def(lanes))
    ptxas_lines(m, "march", "Li1ELb1EEEv")

    # ---- 20. the scene: 968 triangles in 121 chunks
    r = S.obj_mesh(width=800, height=800, obj_path=S.TORUS_OBJ, device=dev)
    ctx = m.SceneCtx(r.spec, r.scene_data)
    packed = ctx.packed
    n_tri = int(packed.chunk_live.sum())
    if (n_tri, packed.n_chunks) != (968, 121):
        fail(f"obj_mesh packs {n_tri} triangles in {packed.n_chunks} "
             f"chunks, expected 968 in 121")
    print(f"obj_mesh: {n_tri} triangles in {packed.n_chunks} chunks and "
          f"{packed.n_supers} super-chunks; triangle table "
          f"{4 * packed.chunks.numel()} bytes in device memory, boxes "
          f"{4 * packed.aabbs.numel()} bytes in shared memory")

    # ---- 21. the kernels against their plain versions on mesh rays
    rad_sub, scr_sub, rad_full, scr_full = gi_rays(torch, m, r, dev)
    passes = {"radiance": (m.PROBE_SHADE_CONFIG, False),
              "screen": (r.screen_cfg, True)}

    def run(fn, rays, name, scene=packed, **measure):
        cfg, refl = passes[name]
        return fn(scene, ctx.lpos_vec, ctx.n_light_slots, rays[0], rays[1],
                  ctx.max_dist, probe_spacing=r.probes.grid_spacing,
                  probe_dims=r.probes.grid_dimensions,
                  surface_offset=m.SURFACE_OFFSET,
                  ao_steps=cfg.ambient_occlusion_steps,
                  max_steps=cfg.max_march_steps,
                  mat_rough_vec=ctx.rough_vec if refl else None,
                  refl_shadows=cfg.add_indirect_specular, **measure)

    # the seeded subsets, then the full shapes, where the plain version's
    # work is counted for the bound and every lane count the wrapper can
    # choose is held to it
    geo_err = 0.0
    work = {}
    for name, rays, full in (("radiance", rad_sub, False),
                             ("screen", scr_sub, False),
                             ("radiance", rad_full, True),
                             ("screen", scr_full, True)):
        if full:
            ref, flops = counted(torch, m, lambda: run(M.geometry_reference,
                                                        rays, name))
            work[name] = (flops, M.scene_eval_flops(pruned=False),
                          dict(M.pruned_evals),
                          M.scene_evals[M.TRIANGLE_CODE])
        else:
            ref = run(M.geometry_reference, rays, name)
            torch.cuda.synchronize()
        for lanes in M.LANE_CHOICES if full else (None,):
            k = run(M.geometry, rays, name,
                    library=lanes and M.geometry_library(lanes))
            torch.cuda.synchronize()
            geo_err = max(geo_err, check_geometry(
                torch, f"obj_mesh {name}"
                + (f" full, {lanes} lanes" if full else ""),
                rays[0].shape[0], k, ref))
            del k
        del ref

    o, d = mesh_rays(torch, m, r, dev, CHECK_RAYS, SEED)
    g = torch.Generator().manual_seed(SEED + 1)
    mx = (torch.rand(CHECK_RAYS, generator=g) * 20.0).to(dev)
    mn = (torch.rand(CHECK_RAYS, generator=g) * 0.5).to(dev)
    en = torch.ones(CHECK_RAYS, dtype=torch.bool, device=dev)
    k = M.raycast(packed, o, d, r.spec.max_dist)
    torch.cuda.synchronize()
    rc_err = check_raycast(torch, "raycast obj_mesh", k,
                           M.raycast_reference(packed, o, d,
                                               r.spec.max_dist))
    kvis = M.visibility(packed, o, d, mx, enabled=en)
    torch.cuda.synchronize()
    vis_err = check_visibility(
        torch, "visibility obj_mesh", kvis,
        M.visibility_reference(packed, o, d, mx, enabled=en))
    sh_err = 0.0
    for k_pen in (64.0, 0.5):
        ksh = M.softshadows(packed, o, d, mn, mx, k_pen, enabled=en)
        torch.cuda.synchronize()
        sh_err = max(sh_err, check_softshadows(
            torch, f"softshadows obj_mesh k={k_pen}", ksh,
            M.softshadows_reference(packed, o, d, mn, mx, k_pen,
                                    enabled=en)))

    # ---- 22. card against CPU: 32x32, the tiny probes, 2 frames
    imgs = [S.obj_mesh(width=32, height=32, obj_path=S.TORUS_OBJ,
                       probes=m.ProbeSettings(**TINY_PROBES), device=x)
            .converge(frames=2).cpu().numpy() for x in (dev, "cpu")]
    stats = m.image_stats(*imgs)
    print(f"obj_mesh 32x32, cuda vs cpu: {json.dumps(stats)}")
    if stats["breached"]:
        fail(f"obj_mesh: card vs CPU gates breached: {stats['breached']}")

    # ---- 23. obj_mesh 800x800: the main path, counted and timed
    frames = 5
    launches = drive(torch, m, r, "obj_mesh 800x800", frames,
                     {"geometry": 2}, card)[0]
    n_rays = m.rays_per_frame(r.width, r.height, r.probes,
                              ctx.n_light_slots, r.screen_cfg, r.volumetrics)
    if n_rays != 15_088_640:
        fail(f"obj_mesh rays_per_frame {n_rays}, expected 15,088,640")
    split = pass_split(torch, m, r, 3)
    print(f"obj_mesh 800x800 per pass (ms, CUDA events, mean of 3): "
          f"{json.dumps({k: round(v, 3) for k, v in split.items()})}; "
          f"[{card}]")
    profile_frames(m, r, "obj_mesh 800x800", card)

    # one box level, against which the second is timed: every super-chunk
    # box opened to all of space, so the same kernel tests every chunk box
    # in slot order (still exact)
    aabbs = packed.aabbs.clone()
    aabbs[1:1 + packed.n_supers, 0:3] = -M.BIG
    aabbs[1:1 + packed.n_supers, 4:7] = M.BIG
    one_level = dataclasses.replace(packed, aabbs=aabbs)

    out = {"launches": launches["geometry"], "max_abs_err": geo_err}
    for name, sub, full in (("radiance", rad_sub, rad_full),
                            ("screen", scr_sub, scr_full)):
        n_sub, n_full = sub[0].shape[0], full[0].shape[0]
        k, k1_level = (run(M.geometry, full, name),
                       run(M.geometry, full, name, one_level))
        torch.cuda.synchronize()
        check_geometry(torch, f"obj_mesh {name} one box level vs two",
                       n_full, k1_level, k)
        del k, k1_level
        k_full = (cuda_ms(torch, lambda: run(M.geometry, full, name), 3),)
        k_one = tuple(cuda_ms(torch, lambda: run(M.geometry, full, name,
                                                 one_level), 3)
                      for _ in range(2))
        k_full += (cuda_ms(torch, lambda: run(M.geometry, full, name), 3),)
        (k1, k2), (p1, p2) = time_pair(
            torch, lambda: run(M.geometry, sub, name),
            lambda: run(M.geometry_reference, sub, name), iters=3)
        flops, unculled, pruned, tri_evals = work[name]
        n_l = ctx.n_light_slots
        refl = passes[name][1]
        per_ray = 24 + 4 * (10 + n_l + 8) + (4 * (14 + n_l + 8) if refl
                                             else 0)
        n_bytes = n_full * per_ray + scene_bytes(packed) + 4 * (
            ctx.lpos_vec.numel() + ctx.rough_vec.numel())
        b_ms, b_by = bound(flops, n_bytes)
        u_ms, u_by = bound(unculled, n_bytes)
        print(f"time geometry obj_mesh {name}: kernel {k_full[0]:.3f}/"
              f"{k_full[1]:.3f} ms at {n_full} rays, {k1:.3f}/{k2:.3f} ms "
              f"at the {n_sub}-ray subset; plain {p1:.1f}/{p2:.1f} ms at "
              f"the subset; bound at {n_full} rays {b_ms:.5f} ms ({b_by}: "
              f"{flops:.4e} flops: {pruned['aabb']} box tests, "
              f"{pruned['triangles']} of {tri_evals} triangle "
              f"evaluations; {n_bytes} bytes), unculled {u_ms:.4f} ms "
              f"({u_by}: {unculled:.4e} flops); one box level (timed "
              f"between the two kernel times) {k_one[0]:.3f}/{k_one[1]:.3f} "
              f"ms; [{card}]")

        def launch(library, full=full, name=name, **measure):
            return run(M.geometry, full, name, library=library, **measure)

        by_lanes, chosen = time_lanes(
            torch, m, launch, packed, n_full, f"obj_mesh {name}",
            f"bound {b_ms:.5f} ms", card)

        # the kernel's own count of its work (a COUNT_WORK build, launched
        # here only) beside the plain version's count of what exact pruning
        # needs on the same rays
        for lanes in M.LANE_CHOICES:
            done = torch.zeros(M.WORK_COUNTS, dtype=torch.int64, device=dev)
            launch(M.geometry_library(lanes, count_work=True), work=done)
            evals, tests, tris, _ = done.tolist()
            plain_evals = tri_evals // n_tri
            print(f"work obj_mesh {name}, {lanes} lanes: the kernel made "
                  f"{evals} scene evaluations, {tests} box tests "
                  f"({tests / evals:.2f} each) and {tris} triangle "
                  f"evaluations ({tris / evals:.2f} each); the plain "
                  f"version {plain_evals} evaluations, exact pruning "
                  f"needing {pruned['aabb']} box tests "
                  f"({pruned['aabb'] / plain_evals:.2f} each) and "
                  f"{pruned['triangles']} triangles "
                  f"({pruned['triangles'] / plain_evals:.2f} each)")
            out.setdefault("work", {})[f"{name}_{lanes}"] = dict(
                evals=evals, box_tests=tests, triangles=tris)
        out[name] = dict(ms=min(k_full), sub_ms=min(k1, k2),
                         plain_ms=min(p1, p2), bound_ms=b_ms, bound_by=b_by,
                         unculled_bound_ms=u_ms, lanes=chosen,
                         ms_by_lanes=by_lanes,
                         plain_evals=tri_evals // n_tri,
                         pruned_box_tests=pruned["aabb"],
                         pruned_triangles=pruned["triangles"])
    return out, rc_err, vis_err, sh_err


# Phase 25: card gradients against CPU gradients, per float leaf by
# relative norm.  The kernels equal their plain versions (phases 3, 8, 13,
# 14), so what differs is PyTorch's own arithmetic on the card: matmul and
# reduction order, and the atomics of the gathers' backward (run to run).
# Measured 1.6e-6 at most (GI mode 2; NVIDIA H100 80GB HBM3, 700.00 W);
# the limit leaves room for a pixel whose discrete pick (the mode-2 probe,
# a silhouette) flips at a near-tie between the two devices.
GRAD_REL_LIMIT = 1e-3
# test_torch_pipeline.py's small volumetrics, for light_shafts' gradients
SMALL_VOL = dict(visibility_resolution=(8, 8, 8), visibility_step_size=0.5,
                 scattering_resolution=(12, 12), scattering_step_size=0.5)
# The train step's sizes, scene and target: bench.py:bench_train_step's.
TRAIN_SIZES = (256, 512)
TRAIN_STEPS = 5


def rel_norm(torch, a, b):
    """‖a − b‖ / ‖b‖ (‖a‖ where b is 0)."""
    nb = float(torch.linalg.vector_norm(b.double()))
    diff = float(torch.linalg.vector_norm((a - b).double()))
    return diff / nb if nb > 0 else float(torch.linalg.vector_norm(
        a.double()))


def to_device(m, dev, data, camera, state):
    """A scene's data, camera and feedback state moved to ``dev``."""
    P = m.pipeline
    return (m.tree_map(lambda x: x.to(dev), data),
            P.Camera(position=camera.position.to(dev),
                     orientation=camera.orientation.to(dev)),
            P.FrameState(**{f.name: getattr(state, f.name).to(dev)
                            for f in dataclasses.fields(P.FrameState)}))


def gradient_phase(torch, m, dev, card):
    """Phase 25: the train step's loss gradient on the card and on the CPU
    from the same scene data and atlases (a frame rendered on the CPU with
    test_examples.py's tiny probes), per float leaf; fails beyond
    GRAD_REL_LIMIT, on a non-finite gradient, or unless each kernel of the
    path launched as often as a frame launches it.  Returns {case:
    numbers}."""
    S, spmd = m.S, m.spmd
    probes = m.ProbeSettings(**TINY_PROBES)
    cases = (
        ("GI mode 2 64x64", S.global_illumination, 64, {},
         {"geometry": 2}),
        ("GI mode 1 32x32", S.global_illumination, 32,
         {"screen_cfg": m.ShadeConfig(indirect_specular_mode=1)},
         {"geometry": 2, "raycast": 1, "softshadows": 1}),
        ("GI mode 3 32x32", S.global_illumination, 32,
         {"screen_cfg": m.ShadeConfig(indirect_specular_mode=3)},
         {"geometry": 3}),
        ("light_shafts 32x32", S.light_shafts, 32,
         {"volumetrics": m.VolumetricsSettings(**SMALL_VOL)},
         {"geometry": 2, "raycast": 1, "visibility": 1}))
    out = {}
    for label, build_scene, size, kw, per_step in cases:
        r = build_scene(width=size, height=size, probes=probes,
                        device="cpu", **kw)
        r.render()
        value_and_grad = spmd.make_value_and_grad(
            r.spec, probes, r.volumetrics, size, size,
            screen_cfg=r.screen_cfg, probe_cfg=r.probe_cfg)
        target = torch.zeros((size, size, 3))
        args = (r.scene_data, r.camera, r.state)
        loss_c, grads_c, _ = value_and_grad(*args, target)
        reset_launches(m)
        loss_d, grads_d, _ = value_and_grad(*to_device(m, dev, *args),
                                            target.to(dev))
        torch.cuda.synchronize()
        launches = launch_counts(m)
        want = {name: per_step.get(name, 0) for name in KERNELS}
        names = [path for path, leaf in m.tree_items(r.scene_data)
                 if leaf.is_floating_point()]
        rel = {name: rel_norm(torch, gd.cpu(), gc)
               for name, gd, gc in zip(names, grads_d, grads_c)}
        finite = all(bool(torch.isfinite(g).all())
                     for g in grads_c + grads_d)
        worst = max(rel.values())
        print(f"gradients {label}, card vs cpu: loss {float(loss_d):.8f} / "
              f"{float(loss_c):.8f}; largest relative norm {worst:.3e} "
              f"(limit {GRAD_REL_LIMIT}); per leaf "
              + json.dumps({k: float(f"{v:.3e}") for k, v in rel.items()})
              + f"; launches {json.dumps(launches)}; [{card}]")
        if not finite:
            fail(f"gradients {label}: not finite")
        if not worst <= GRAD_REL_LIMIT:
            fail(f"gradients {label}: card vs CPU {worst:.3e} beyond "
                 f"{GRAD_REL_LIMIT}")
        if launches != want:
            fail(f"gradients {label}: launches {launches}, expected {want}")
        out[label] = dict(loss=float(loss_d), loss_cpu=float(loss_c),
                          max_rel=worst, rel=rel, launches=launches)
    return out


def train_phase(torch, m, dev, card, size):
    """Phase 26 at size²: bench.py's train step (global_illumination at
    full width, its 36 probes x 32² texels, mode 2 with AO, a black
    target, lr 0.01) both ways: compiled (the step make_train_step gives
    on the kernel route, a CUDA graph captured at its first step and
    replayed) and eager (inside pipeline.eager()), after a warm-up step
    each, TRAIN_STEPS steps a turn timed with CUDA events in turns
    (eager, compiled, compiled, eager), each turn's launches counted; then
    the differentiable forward alone as often, eager (render_frame, no
    graph) and compiled (compiled_frame with the differentiable configs),
    in turns.  Fails on a non-finite loss, on parameters that did not
    move, or unless each step launched the geometry kernel twice and no
    other kernel, either way.  Returns the numbers and {way: (a function
    making one more step, the forward)}."""
    S, spmd, P = m.S, m.spmd, m.pipeline
    r = S.global_illumination(width=size, height=size, device=dev)
    step = spmd.make_train_step(r.spec, r.probes, r.volumetrics, size, size,
                                screen_cfg=r.screen_cfg)
    target = torch.zeros((size, size, 3), device=dev)
    cam = r.camera
    run = {"data": r.scene_data, "state": r.state}

    def compiled_step():
        loss, run["data"], run["state"] = step(run["data"], cam,
                                               run["state"], target)
        return loss

    def eager_step():
        with P.eager():
            return compiled_step()

    screen = dataclasses.replace(r.screen_cfg, differentiable=True)
    probe = dataclasses.replace(r.probe_cfg, differentiable=True)

    def eager_forward():
        with torch.no_grad():
            return P.render_frame(r.spec, r.probes, r.volumetrics, size,
                                  size, run["data"], cam, run["state"],
                                  screen_cfg=screen, probe_cfg=probe)[0]

    def compiled_forward():
        with torch.no_grad():
            return P.compiled_frame(
                r.spec, r.probes, r.volumetrics, size, size, run["data"],
                cam, run["state"], screen_cfg=screen, probe_cfg=probe)(
                    run["data"], cam, run["state"])[0]

    ways = {"eager": (eager_step, eager_forward),
            "compiled": (compiled_step, compiled_forward)}
    for fn, _ in ways.values():
        fn()
    captured = step.compiled_step
    before = [x.clone() for x in spmd.split_float_leaves(run["data"])[0]]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    timers = {way: m.FrameTimer(dev) for way in ways}
    launches = {way: [] for way in ways}
    losses = {way: [] for way in ways}
    for way in ("eager", "compiled", "compiled", "eager"):
        reset_launches(m)
        for _ in range(TRAIN_STEPS):
            with timers[way].frame():
                loss = ways[way][0]()
            losses[way].append(float(loss))
        launches[way].append(launch_counts(m))
    # the steps' own peak, above what the script already held (the graph
    # pool among it): the eager steps' working memory
    peak = torch.cuda.max_memory_allocated(dev) - held
    after = spmd.split_float_leaves(run["data"])[0]
    moved = max(float((a - b).abs().max()) for a, b in zip(after, before))
    for _, fwd in ways.values():
        fwd()
    fwd_timers = {way: m.FrameTimer(dev) for way in ways}
    for way in ("eager", "compiled", "compiled", "eager"):
        for _ in range(TRAIN_STEPS):
            with fwd_timers[way].frame():
                ways[way][1]()
    ms = {way: t.mean * 1e3 for way, t in timers.items()}
    fwd_ms = {way: t.mean * 1e3 for way, t in fwd_timers.items()}
    rays = m.rays_per_frame(size, size, r.probes, 1, r.screen_cfg,
                            r.volumetrics)
    out = dict(ms_per_step=ms["compiled"], eager_ms_per_step=ms["eager"],
               forward_ms=fwd_ms["compiled"],
               eager_forward_ms=fwd_ms["eager"],
               backward_update_ms=ms["compiled"] - fwd_ms["compiled"],
               eager_backward_update_ms=ms["eager"] - fwd_ms["eager"],
               step_ms={way: [t * 1e3 for t in timers[way].times]
                        for way in ways},
               forward_each_ms={way: [t * 1e3 for t in fwd_timers[way].times]
                                for way in ways},
               rays_per_step=rays, rays_per_s=rays / (ms["compiled"] / 1e3),
               losses=losses, largest_change=moved,
               peak_mib=peak / 2 ** 20, held_mib=held / 2 ** 20,
               launches=launches["compiled"][0],
               launches_by_turn=launches,
               launches_per_captured_step=captured.launches,
               capture_s=captured.capture_s, warmup_s=captured.warmup_s,
               pool_mib=captured.pool_bytes / 2 ** 20)
    print(f"train GI {size}x{size}: compiled {ms['compiled']:.3f} ms/step, "
          f"eager {ms['eager']:.3f} (CUDA events, {TRAIN_STEPS} steps a "
          f"turn in turns; compiled steps "
          + ", ".join(f"{x:.2f}" for x in out["step_ms"]["compiled"])
          + ", eager " + ", ".join(f"{x:.1f}"
                                   for x in out["step_ms"]["eager"])
          + f" ms); forward compiled {fwd_ms['compiled']:.3f} ms, eager "
          f"{fwd_ms['eager']:.3f}; backward+update compiled "
          f"{out['backward_update_ms']:.3f} ms, eager "
          f"{out['eager_backward_update_ms']:.3f}; "
          f"{rays / (ms['compiled'] / 1e3) / 1e6:.1f} M rays/s compiled "
          f"({rays} rays/step); capture {captured.capture_s:.3f} s "
          f"(warm-up {captured.warmup_s:.3f}), graph pool "
          f"{out['pool_mib']:.1f} MiB; losses {json.dumps(losses)}; "
          f"largest parameter change {moved:.3e}; eager peak memory "
          f"{peak / 2 ** 20:.1f} MiB above the {held / 2 ** 20:.1f} MiB "
          f"held before; launches a captured step "
          f"{json.dumps(captured.launches)}, each turn of {TRAIN_STEPS} "
          f"steps {json.dumps(launches)}; [{card}]")
    if not all(math.isfinite(x) for v in losses.values() for x in v):
        fail(f"train {size}x{size}: non-finite loss {losses}")
    if not moved > 0.0 or not math.isfinite(moved):
        fail(f"train {size}x{size}: parameters did not move ({moved})")
    want = {name: (2 * TRAIN_STEPS if name == "geometry" else 0)
            for name in KERNELS}
    if any(n != want for v in launches.values() for n in v):
        fail(f"train {size}x{size}: launches {launches}, expected {want} "
             f"a turn")
    return out, ways


def train_profile(torch, m, ways, label, card, step_ms):
    """Phase 27: the train step under torch.profiler (3 steps), compiled
    and eager: the device's busy ms per step, its idle share under the
    profiler and by CUDA events (1 − busy / phase 26's ms per step), and
    the heaviest device ops of the forward (profiled alone) and of the
    rest of the step (the step's time per op less the forward's)."""
    def top(d):
        return [(k[:60], round(v, 4))
                for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:6]]

    out = {}
    for way, (one_step, forward) in ways.items():
        busy, wall, ops = m.device_ops(one_step, 3)
        f_busy, f_wall, f_ops = m.device_ops(forward, 3)
        back = {k: v - f_ops.get(k, 0.0) for k, v in ops.items()}
        out[way] = dict(busy_ms=busy, wall_ms=wall,
                        idle_share=1.0 - busy / wall,
                        idle_share_events=1.0 - busy / step_ms[way],
                        forward_busy_ms=f_busy, forward_wall_ms=f_wall,
                        top_forward=top(f_ops), top_backward=top(back))
        print(f"train {label} {way} under torch.profiler (3 steps): device "
              f"busy {busy:.3f} ms/step of {wall:.3f} ms/step, idle share "
              f"{1.0 - busy / wall:.3f} (by CUDA events: "
              f"{1.0 - busy / step_ms[way]:.3f} of {step_ms[way]:.3f} "
              f"ms/step); forward alone {f_busy:.3f} of {f_wall:.3f} ms; "
              "heaviest forward: "
              + "; ".join(f"{k} {v}" for k, v in out[way]["top_forward"])
              + "; heaviest backward+update: "
              + "; ".join(f"{k} {v}" for k, v in out[way]["top_backward"])
              + f"; [{card}]")
    return out


# Phases 28-31: the scenes the kernels do not take (bvh_test and
# obj_mesh's baked mode, on the generic route) and ball_game.
BAKE_DIMS = (48, 48, 48)
# Card bake against CPU bake: both run the same float32 operations.
BAKE_ATOL = 1e-5
GENERIC_FRAMES = 2
BALL_FRAMES = 5
BALL_THROWS = 12


def ball_game(m, size, dev):
    """ball_game at size x size after the golden's script
    (tools/make_goldens.py): a ball thrown, 2 physics steps.  Returns
    (renderer, step_physics, throw_ball).  Specialised to its live counts
    (specialize_counts=True), so that phases 29 and 31 read the live slots
    and the lanes they give off the spec; phase 40 renders it both
    ways."""
    r, step, throw = m.S.ball_game(width=size, height=size, device=dev,
                                   specialize_counts=True)
    throw((2.0, 2.0, 0.0), (2.0, 2.0, 4.0))
    for _ in range(2):
        step()
    return r, step, throw


def throw_more(step, throw):
    """BALL_THROWS more balls across the room, then a physics step."""
    for k in range(BALL_THROWS):
        throw((0.5 + 0.4 * k, 3.0 + 0.2 * (k % 3), 1.0 + 0.3 * k),
              (0.5, 1.0, 1.0))
    step()


def on_cpu(m, r):
    """Renderer r's scene on the CPU: its spec (a baked grid with it) and
    its host mirror, without building the scene again."""
    c = m.Renderer(r.base_spec, r.width, r.height, probes=r.probes,
                   volumetrics=r.volumetrics, screen_cfg=r.screen_cfg,
                   probe_cfg=r.probe_cfg, device="cpu")
    c.builder = r.builder
    c.camera_position = r.camera_position
    c.camera_orientation = r.camera_orientation
    return c


def screen_steps(torch, m, r):
    """(mean, largest) march steps of the generic route's primary raycast
    (the plain march over SceneCtx.sdf_b) on renderer r's screen rays."""
    cam = r.camera
    o, d = m.camera_rays(m.pixel_grid(r.width, r.height, r.device),
                         cam.position, cam.orientation)
    ctx = m.SceneCtx(r.spec, r.scene_data)
    steps = m.rm.raycast(ctx.sdf_b, o.reshape(-1, 3), d.reshape(-1, 3),
                         r.spec.max_dist,
                         max_steps=r.screen_cfg.max_march_steps,
                         return_steps=True)[3]
    return float(steps.float().mean()), int(steps.max())


def scene_phases(torch, np, m, dev, card, goldens):
    """Phases 28-31.  Returns (the scenes JSON's dict, geometry_passes'
    dict and largest difference on ball_game's 800x800 rays)."""
    M, S = m.M, m.S
    out = {}

    # ---- 28. bvh_test 128x128 against the JAX golden, generic route
    r = S.bvh_test(width=128, height=128, device=dev)
    if M.kernel_scene(r.spec):
        fail("bvh_test: the kernels take the scene; expected the generic "
             "route")
    reset_launches(m)
    t0 = time.perf_counter()
    img = r.converge(frames=2).cpu().numpy()
    secs = time.perf_counter() - t0
    launches = launch_counts(m)
    print(f"bvh_test 128x128: 2 frames in {secs:.2f} s (host clock, with "
          f"the first frame's set-up), launches {json.dumps(launches)}; "
          f"[{card}]")
    if any(launches.values()):
        fail(f"bvh_test launched a kernel: {launches}")
    hold_golden(m, img, goldens, "bvh_test", "bvh_test 128x128")

    # ---- 29. ball_game 128x128 against the JAX golden, then balls thrown
    # past LANES_MIN_SLOTS with no build after the first frame
    # 2 geometry launches a frame; the first frame of each live count
    # (specialised: a new compiled frame) runs its eager warm-up too
    r, step, throw = ball_game(m, 128, dev)
    reset_launches(m)
    r.render()
    torch.cuda.synchronize()
    first = (m.build.load.builds, m.build.load.cache_info().misses)
    img = r.render().cpu().numpy()
    slots = [sum(r.spec.live_prims)]
    launches = launch_counts(m)
    if launches != {"geometry": 6, "raycast": 0, "visibility": 0,
                    "softshadows": 0}:
        fail(f"ball_game 128x128: launches {launches} in 2 frames and a "
             f"warm-up")
    hold_golden(m, img, goldens, "ball_game", "ball_game 128x128")
    throw_more(step, throw)
    reset_launches(m)
    for _ in range(2):
        img = r.render()
    img = img.cpu()
    slots.append(sum(r.spec.live_prims))
    launches = launch_counts(m)
    later = (m.build.load.builds, m.build.load.cache_info().misses)
    print(f"ball_game 128x128: live slots {slots[0]} then {slots[1]}; "
          f"launches {json.dumps(launches)} in 2 frames; nvcc builds and "
          f"libraries loaded {first} after the first frame, {later} after "
          f"the last")
    if slots != [8, 8 + BALL_THROWS] or launches["geometry"] != 6 or not (
            bool(torch.isfinite(img).all()) and float(img.var()) > 0.0):
        fail(f"ball_game after {BALL_THROWS} throws: slots {slots}, "
             f"launches {launches}")
    if later != first:
        fail(f"ball_game: a build or a library load after the first frame "
             f"({first} -> {later})")
    out["ball_game_128"] = dict(live_slots=slots, builds_after_first=[
        later[0] - first[0], later[1] - first[1]])

    # ---- 30. obj_mesh baked: the 48^3 bake on the card against the CPU,
    # then 32x32 frames card against CPU
    mesh = m.mesh.load_obj(S.TORUS_OBJ)
    lo, hi = mesh.bounding_box()
    margin = 0.1 * float(np.max(hi - lo))
    lo, hi = lo - margin, hi + margin
    bake_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d_card, n_card = m.mesh.bake_distance_map(mesh, BAKE_DIMS, lo, hi,
                                                  device=dev)
        bake_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    d_cpu, n_cpu = m.mesh.bake_distance_map(mesh, BAKE_DIMS, lo, hi,
                                            device="cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    err = float(np.abs(d_card - d_cpu).max())
    other = float((np.abs(n_card - n_cpu).max(axis=-1) > 1e-6).mean())
    print(f"bake {BAKE_DIMS} of {mesh.num_triangles} triangles: card "
          f"{bake_ms[0]:.1f} / {bake_ms[1]:.1f} ms (host clock, to numpy), "
          f"CPU {cpu_ms:.1f} ms; largest distance difference {err:.3e}; "
          f"{other:.4f} of the points chose a face of another normal "
          f"(equally close faces); [{card}]")
    if not err <= BAKE_ATOL:
        fail(f"baked distances: card against CPU {err} > {BAKE_ATOL}")
    r = S.obj_mesh(width=32, height=32, obj_path=S.TORUS_OBJ, mode="baked",
                   probes=m.ProbeSettings(**TINY_PROBES), device=dev)
    imgs = [x.converge(frames=2).cpu().numpy() for x in (r, on_cpu(m, r))]
    stats = m.image_stats(*imgs)
    print(f"obj_mesh baked 32x32, cuda vs cpu: {json.dumps(stats)}")
    if stats["breached"]:
        fail(f"obj_mesh baked: card vs CPU gates breached: "
             f"{stats['breached']}")
    out["bake"] = dict(dims=list(BAKE_DIMS), card_ms=bake_ms, cpu_ms=cpu_ms,
                       max_abs_err=err, other_face_share=other)

    # ---- 31. the three scenes at 800x800: counted and timed.  ball_game
    # first renders a frame at 8 live slots (the screen pass at 1 lane a
    # ray, the radiance pass at 8), then takes the throws: at 20 slots the
    # screen pass launches at 8 lanes, the build the radiance pass loaded
    ball, step, throw = ball_game(m, 800, dev)
    n_probe_rays = ball.probes.num_probes \
        * ball.probes.radiance_resolution ** 2

    def ball_lanes():
        packed = m.SceneCtx(ball.spec, ball.scene_data).packed
        return {"radiance": M.geometry_lanes(packed, n_probe_rays),
                "screen": M.geometry_lanes(packed, 800 * 800)}

    slots, lanes, loads = [], [], []
    for throws in (False, True):
        if throws:
            throw_more(step, throw)
        loads.append((m.build.load.builds,
                      m.build.load.cache_info().misses))
        ball.render()
        torch.cuda.synchronize()
        slots.append(sum(ball.spec.live_prims))
        lanes.append(ball_lanes())
    later = (m.build.load.builds, m.build.load.cache_info().misses)
    print(f"ball_game 800x800: live slots {slots[0]} then {slots[1]}, "
          f"lanes {json.dumps(lanes[0])} then {json.dumps(lanes[1])}; nvcc "
          f"builds and libraries loaded {loads[1]} before the frame after "
          f"the throws, {later} after it")
    if slots != [8, 8 + BALL_THROWS] or lanes != [
            {"radiance": 8, "screen": 1}, {"radiance": 8, "screen": 8}]:
        fail(f"ball_game 800x800: slots {slots}, lanes {lanes}")
    if later != loads[1]:
        fail(f"ball_game 800x800: a build or a library load in the frame "
             f"after the throws ({loads[1]} -> {later})")
    # the geometry kernel against its plain version at the shapes ball_game
    # gives it after the throws (20 slots, the mode-2 fold on the screen)
    geo_ball, ball_err = geometry_passes(torch, m, ball, "ball_game ", card)
    cells = (("bvh_test", S.bvh_test(width=800, height=800, device=dev),
              GENERIC_FRAMES, {}),
             ("obj_mesh baked", S.obj_mesh(
                 width=800, height=800, obj_path=S.TORUS_OBJ, mode="baked",
                 device=dev), GENERIC_FRAMES, {}),
             ("ball_game", ball, BALL_FRAMES, {"geometry": 2}))
    for label, rr, frames, per_frame in cells:
        generic = not per_frame
        launches, ms, rays_s = drive(torch, m, rr, f"{label} 800x800",
                                     frames, per_frame, card)
        split = pass_split(torch, m, rr, 1 if generic else 3)
        print(f"{label} 800x800 per pass (ms, CUDA events, mean of "
              f"{1 if generic else 3}): "
              f"{json.dumps({k: round(v, 3) for k, v in split.items()})}; "
              f"[{card}]")
        # bvh_test's trace (~3 M events) is not read by key_averages():
        # that parse would take minutes
        busy, wall, avg = profile_frames(
            m, rr, f"{label} 800x800", card, frames=1 if generic else 3,
            averaged=label != "bvh_test")
        cell = dict(ms_per_frame=ms, rays_per_s=rays_s, frames=frames,
                    launches=launches,
                    split_ms=split, busy_ms=busy, profiled_wall_ms=wall,
                    idle_share=1.0 - busy / wall,
                    averaged_busy_ms=avg,
                    live_slots=sum(rr.spec.live_prims))
        if generic:
            mean, largest = screen_steps(torch, m, rr)
            print(f"{label} 800x800 screen primary march: mean {mean:.2f} "
                  f"steps, largest {largest}")
            cell["screen_steps"] = dict(mean=mean, largest=largest)
        else:
            cell["lanes"] = lanes[1]
            cell["lanes_at_8_slots"] = lanes[0]
        out[label] = cell
    return out, geo_ball, ball_err


# Phase 32: a kernel scene that the geometry kernel does not take.
LAMP_ORIGIN = (5.0, 3.0, 6.0)


def lamp(m):
    """A point light whose position field is named 'origin': it has no
    vec3 'position', so no fused geometry launch takes a scene it lights
    (SceneCtx.fused_available)."""
    def sample(params, pos, normal):
        to_l = params["origin"] - pos
        dist = m.length(to_l)
        radiance = params["color"] / (dist * dist * 0.03)[..., None]
        return radiance, to_l / dist[..., None], dist
    return m.lights.LightType(name="lamp", fields=(
        ("origin", "vec3"), ("color", "vec3")), sample=sample)


def lamp_room(np, m, size, dev, **kwargs):
    """The global_illumination room at size x size, its spot light
    replaced by lamp(m) at LAMP_ORIGIN: the kernels take the scene, the
    geometry kernel does not, so the shade takes its unfused branches."""
    r = m.S.global_illumination(width=size, height=size, device=dev,
                                **kwargs)
    ltype = lamp(m)
    r.base_spec = dataclasses.replace(r.base_spec, lights=((ltype, 1),))
    r.builder.spec = r.base_spec
    r.builder._lights = {ltype.name: {
        name: np.zeros((1, 3), np.float32) for name, _ in ltype.fields}}
    r.builder._light_counts = {ltype.name: 0}
    r.add_light(ltype, origin=LAMP_ORIGIN, color=(0.9, 0.9, 0.9))
    return r


# The unfused shade's launches per frame, in order, with the batch each
# marches: the radiance pass's primaries (R rays), their shadow rays (one
# light slot) and 8 probe corners a point; the screen pass's primaries
# (S rays), shadows, corners; mode 2's reflection rays (S), their corners
# and their shadow rays.
LAMP_CALLS = ("raycast R", "softshadows R", "visibility 8R", "raycast S",
              "softshadows S", "visibility 8S", "raycast S", "visibility 8S",
              "softshadows S")


def lamp_phase(torch, np, m, dev, card):
    """Phase 32: the lamp room at 800x800 on the kernel route through the
    unfused shade: 2 timed frames with the launches counted (3 raycast, 3
    softshadows, 3 visibility and no geometry launch a frame), then one
    frame's launches recorded with their inputs, and each held to its
    plain version on those inputs; the screen pass's three launches timed
    against their plain versions beside the bound.  Returns ({kernel:
    {launches, max_abs_err, ms, plain_ms, bound_ms, bound_by}}, the
    timed frames' launches)."""
    M = m.M
    r = lamp_room(np, m, 800, dev)
    ctx = m.SceneCtx(r.spec, r.scene_data)
    if not ctx.use_kernel or ctx.fused_available:
        fail("the lamp room: expected a kernel scene without the geometry "
             "kernel")
    per_frame = {"raycast": 3, "softshadows": 3, "visibility": 3}
    launches = drive(torch, m, r, "GI lamp 800x800", 2, per_frame, card)[0]
    # each march of a frame recorded where SceneCtx hands it to its kernel
    # wrapper: (name, the wrapper's arguments, its keywords, its outputs)
    real = {name: getattr(m.SceneCtx, name) for name in per_frame}
    calls = []

    def recorder(name):
        def record(ctx, *args, **kwargs):
            out = real[name](ctx, *args, **kwargs)
            calls.append((name, (ctx.packed,) + args, kwargs, out))
            return out
        return record

    for name in real:
        setattr(m.SceneCtx, name, recorder(name))
    try:
        # an eager frame: a replay calls no wrapper to record
        with m.pipeline.eager():
            r.render()
        torch.cuda.synchronize()
    finally:
        for name, fn in real.items():
            setattr(m.SceneCtx, name, fn)
    n_rad = r.probes.num_probes * r.probes.radiance_resolution ** 2
    n_scr = r.width * r.height
    sizes = {"R": n_rad, "8R": 8 * n_rad, "S": n_scr, "8S": 8 * n_scr}
    want = [(c.split()[0], sizes[c.split()[1]]) for c in LAMP_CALLS]
    got = [(name, args[1].shape[0]) for name, args, _, _ in calls]
    if got != want:
        fail(f"the lamp room's launches {got}, expected {want}")
    ks = {args[5] for name, args, _, _ in calls if name == "softshadows"}
    if ks != {m.lighting.SHADOW_K}:
        fail(f"the lamp room's shadow marches at k {ks}")
    checks = {"raycast": check_raycast, "visibility": check_visibility,
              "softshadows": check_softshadows}
    res = {name: dict(launches=launches[name], max_abs_err=0.0)
           for name in per_frame}
    cands = march_candidates(torch, m, ctx.packed)
    res["visibility"]["steps"] = {}

    def vis_run(args, kwargs):
        """run(lib, packed) of the recorded visibility call."""
        _, o, d, mx = args
        en = M._check_rays(args[0], o, d, kwargs.get("enabled"))
        return lambda lib, packed: M._visibility(
            lib, packed, o, d, mx, en, max_steps=kwargs["max_steps"])

    for i, (name, args, kwargs, out) in enumerate(calls):
        label = f"{name} lamp room {LAMP_CALLS[i]}"
        if name == "visibility":
            ref, steps = M.visibility_reference(*args, **kwargs,
                                                return_steps=True)
        else:
            ref = getattr(M, f"{name}_reference")(*args, **kwargs)
        torch.cuda.synchronize()
        err = checks[name](torch, label, out, ref)
        if name == "visibility":
            res[name]["steps"][f"{i}: {LAMP_CALLS[i]}"] = step_stats(
                torch, label, steps)
            err = max(err, hold_builds(torch, label, vis_run(args, kwargs),
                                       ref, check_visibility, cands))
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        del ref
    # the screen pass's launches, timed through the wrapper; per ray in:
    # o, d, enabled and (visibility) max_dist or (softshadows) min_dist,
    # max_dist; out: t, hit (raycast), vis or the factor
    per_ray = {"raycast": 24 + 1 + 4 + 1, "visibility": 24 + 1 + 4 + 4,
               "softshadows": 24 + 1 + 4 + 4 + 4}
    for name, args, kwargs, _ in calls[3:6]:
        plain = getattr(M, f"{name}_reference")
        flops = counted(torch, m, lambda: plain(*args, **kwargs))[1]
        (k1, k2), (p1, p2) = time_pair(
            torch, lambda: getattr(M, name)(*args, **kwargs),
            lambda: plain(*args, **kwargs), iters=5)
        n = args[1].shape[0]
        b_ms, b_by = bound(flops, n * per_ray[name] + scene_bytes(args[0]))
        print(f"time {name} lamp room screen ({n} rays): kernel "
              f"{k1:.4f}/{k2:.4f} ms, plain {p1:.1f}/{p2:.1f} ms; bound "
              f"{b_ms:.5f} ms ({b_by}: {flops:.4e} flops); [{card}]")
        res[name].update(ms=min(k1, k2), plain_ms=min(p1, p2),
                         bound_ms=b_ms, bound_by=b_by)
    return res, launches


# Phase 33: the path tracers (render/pathtrace.py) at full width, the
# reference's defaults: AO 3 steps, 100 samples, 3 bounces, 300 steps.
PT_SIZE = 800
PT_SAMPLES = 100
PT_BOUNCES = 3
PT_STEPS = 300
PT_TIMED = 2
# the many-sample launches held to the plain version: the primary query's
# and two seeded samples' (all 202 would cost ~40 s of plain marches)
PT_HELD_SAMPLES = 2
PT_SMALL = 32
PT_SMALL_SAMPLES = 4
# per ray in and out of a launch, bytes: o, d, enabled, then (raycast) t,
# hit or (softshadows) min_dist, max_dist, the factor
PT_PER_RAY = {"raycast": 24 + 1 + 4 + 1, "softshadows": 24 + 1 + 4 + 4 + 4}
PT_CHECKS = {"raycast": check_raycast, "softshadows": check_softshadows}


def pt_modes(m, generator=None, samples=PT_SAMPLES):
    """{mode: (its function of (spec, data, o, d), its queries a call)}."""
    PT = m.PT
    return {
        "direct": (lambda s, dt, o, d: PT.pixel_color_direct(
            s, dt, o, d, max_steps=PT_STEPS), 1),
        "many": (lambda s, dt, o, d: PT.pixel_color_many(
            s, dt, o, d, generator, gi_samples=samples,
            max_steps=PT_STEPS), 1 + samples),
        "path": (lambda s, dt, o, d: PT.pixel_color_path(
            s, dt, o, d, generator, gi_bounces=PT_BOUNCES,
            max_steps=PT_STEPS), PT_BOUNCES + 1)}


def pt_rays(m, r, dev):
    """The renderer's camera rays, flat in scanline order."""
    cam = r.camera
    o, d = m.camera_rays(m.pixel_grid(r.width, r.height, dev),
                         cam.position, cam.orientation)
    return o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()


def record_marches(m, fn, keep):
    """fn() with each SceneCtx.raycast and SceneCtx.softshadows launch
    recorded where keep(name, i) (i counts that method's calls): [(name,
    i, the wrapper's arguments, its keywords, its outputs)]."""
    real = {name: getattr(m.SceneCtx, name) for name in PT_CHECKS}
    calls = []
    seen = dict.fromkeys(real, 0)

    def recorder(name):
        def record(ctx, *args, **kwargs):
            out = real[name](ctx, *args, **kwargs)
            if keep(name, seen[name]):
                calls.append((name, seen[name], (ctx.packed,) + args,
                              kwargs, out))
            seen[name] += 1
            return out
        return record

    for name in real:
        setattr(m.SceneCtx, name, recorder(name))
    try:
        fn()
    finally:
        for name, f in real.items():
            setattr(m.SceneCtx, name, f)
    return calls


def pathtrace_phase(torch, np, m, dev, card):
    """Phase 33: pixel_color_direct, _many and _path on the GI room at
    800x800 (640,000 camera rays): per mode a warm-up call, then 2 calls
    timed with CUDA events and the launches counted (raycast and
    softshadows 1, 1 + 100 and 3 + 1 times per live light slot, no other
    kernel), one call under torch.profiler, and one call's launches
    recorded and held to the plain versions on their own inputs (every
    launch of direct and path; of many the primary query's and two
    seeded samples'), with the plain marches' steps; one held bounce
    launch of each kernel per mode timed against its plain version beside
    the bound.  Then direct, and many at 4 samples from one CPU generator,
    at 32x32 on the card and on the CPU under the golden gates.  Returns
    ({mode: numbers}, {kernel: {launches_pathtrace_<mode>, max_abs_err,
    <mode> timings}})."""
    M = m.M
    r = m.S.global_illumination(width=PT_SIZE, height=PT_SIZE, device=dev)
    spec, data = r.spec, r.scene_data
    o, d = pt_rays(m, r, dev)
    n = o.shape[0]
    slots = M.pack_light_positions(spec, data)[1]
    rng = np.random.RandomState(SEED)
    held = set(1 + rng.choice(PT_SAMPLES, PT_HELD_SAMPLES, replace=False))
    out, kern = {}, {name: {"max_abs_err": 0.0} for name in PT_CHECKS}
    for mode, (fn, queries) in pt_modes(m).items():
        call = lambda fn=fn: fn(spec, data, o, d)          # noqa: E731
        img = call()
        timer = m.FrameTimer(dev)
        reset_launches(m)
        for _ in range(PT_TIMED):
            with timer.frame():
                img = call()
        launches = launch_counts(m)
        want = {name: 0 for name in KERNELS}
        want.update(raycast=queries * PT_TIMED,
                    softshadows=queries * slots * PT_TIMED)
        if launches != want:
            fail(f"pathtrace {mode}: launches {launches} in {PT_TIMED} "
                 f"calls, expected {want}")
        img = img.cpu()
        if img.shape != (n, 3) or not bool(torch.isfinite(img).all()):
            fail(f"pathtrace {mode}: output not finite of shape ({n}, 3)")
        rays = (want["raycast"] + want["softshadows"]) // PT_TIMED * n
        prof, wall = m.trace_calls(call, 1)
        busy = sum(m.kernel_ops(prof, 1).values())
        del prof
        cell = dict(ms=timer.mean * 1e3, each_ms=[t * 1e3
                                                  for t in timer.times],
                    rays_per_call=rays, rays_per_s=rays / timer.mean,
                    launches=launches, busy_ms=busy, profiled_wall_ms=wall,
                    idle_share=1.0 - busy / wall,
                    image_mean=float(img.mean()))
        print(f"pathtrace {mode} {PT_SIZE}x{PT_SIZE}: "
              f"{cell['ms']:.3f} ms/call ("
              + ", ".join(f"{x:.1f}" for x in cell["each_ms"])
              + f"), {rays / timer.mean / 1e6:.1f} M rays/s ({rays} rays a "
              f"call through the kernels); launches "
              f"{json.dumps(launches)} in {PT_TIMED} calls; under "
              f"torch.profiler device busy {busy:.3f} of {wall:.3f} ms, "
              f"idle share {1.0 - busy / wall:.3f}; image mean "
              f"{cell['image_mean']:.6f}; [{card}]")
        for name in PT_CHECKS:
            kern[name][f"launches_pathtrace_{mode}"] = launches[name]

        # one call's launches held to the plain versions
        def keep(name, i, mode=mode):
            q = i if name == "raycast" else i // slots
            return mode != "many" or q == 0 or q in held
        calls = record_marches(m, call, keep)
        torch.cuda.synchronize()
        bounce = 0 if mode == "direct" else 1
        cell["held"] = {}
        for name, i, args, kwargs, k_out in calls:
            q = i if name == "raycast" else i // slots
            plain = getattr(M, f"{name}_reference")
            ref, flops = counted(torch, m, lambda: plain(
                *args, return_steps=True, **kwargs))
            label = f"{name} pathtrace {mode} query {q}"
            err = PT_CHECKS[name](torch, label, k_out, ref[:-1] if
                                  name == "raycast" else ref[0])
            kern[name]["max_abs_err"] = max(kern[name]["max_abs_err"], err)
            entry = dict(max_abs_err=err,
                         steps=step_stats(torch, label, ref[-1]))
            if q == (bounce if mode != "many" else min(held)) and \
                    i == q * (1 if name == "raycast" else slots):
                (k1, k2), (p1, p2) = time_pair(
                    torch, lambda: getattr(M, name)(*args, **kwargs),
                    lambda: plain(*args, **kwargs), iters=5)
                b_ms, b_by = bound(flops, args[1].shape[0]
                                   * PT_PER_RAY[name] + scene_bytes(args[0]))
                print(f"time {label} ({args[1].shape[0]} rays): kernel "
                      f"{k1:.4f}/{k2:.4f} ms, plain {p1:.1f}/{p2:.1f} ms; "
                      f"bound {b_ms:.5f} ms ({b_by}: {flops:.4e} flops); "
                      f"[{card}]")
                entry.update(ms=min(k1, k2), plain_ms=min(p1, p2),
                             bound_ms=b_ms, bound_by=b_by)
                kern[name].update({f"{k}_pathtrace_{mode}": v for k, v in
                                   entry.items() if k != "steps"})
                kern[name][f"steps_pathtrace_{mode}"] = entry["steps"]
            cell["held"][f"{name} {q}"] = entry
            del ref
        del calls
        out[mode] = cell

    # card against CPU at 32x32, one CPU generator for both
    small = {}
    for mode in ("direct", "many"):
        imgs = []
        for device in (dev, "cpu"):
            rs = m.S.global_illumination(width=PT_SMALL, height=PT_SMALL,
                                         device=device)
            gen = torch.Generator().manual_seed(SEED)
            fn = pt_modes(m, gen, PT_SMALL_SAMPLES)[mode][0]
            c = fn(rs.spec, rs.scene_data, *pt_rays(m, rs, device))
            c = c.clamp_min(0.0).reshape(PT_SMALL, PT_SMALL, 3).cpu()
            imgs.append((((c + 1e-8) / (c + 1.0)) ** 0.4545).numpy())
        stats = m.image_stats(*imgs)
        print(f"pathtrace {mode} {PT_SMALL}x{PT_SMALL}, cuda vs cpu: "
              f"{json.dumps(stats)}")
        if stats["breached"]:
            fail(f"pathtrace {mode} {PT_SMALL}x{PT_SMALL}: gates breached "
                 f"{stats['breached']}")
        small[mode] = stats
    out["cuda_vs_cpu_32"] = small
    return out, kern


# Phase 34: the multi-device layer and checkpoints on the one card.
SHARD_SIZE = 800
SHARD_TRAIN_SIZE = 256
# the sharded step's updated leaves against the unsharded step's, relative
# to each leaf's update: the gathers reorder the backward's sums
SHARD_STEP_REL = 1e-5


def free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def multidevice_phase(torch, m, dev, card):
    """Phase 34: a torch.distributed world of 1 (NCCL) on the card.  The
    GI frame at 800x800 through make_sharded_render (a world of 1 skips
    the sharder) and through render_frame with a RaySharder (each pass's
    rays gathered by an NCCL all-gather), both equal to
    Renderer.render()'s; phase 26's GI train step at 256x256 with and
    without the mesh (gathers and the gradient all-reduce over NCCL),
    equal in loss and updated leaves; the GI scene, state and camera
    saved from the card and loaded back, bit-equal, rendering the same
    next frame.  Returns the numbers."""
    spmd, P = m.spmd, m.pipeline
    if not spmd.init_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0,
                                 backend="nccl"):
        fail("init_distributed did not join the world of 1")
    out = {}
    try:
        mesh = spmd.make_mesh(device=dev)
        r = m.S.global_illumination(width=SHARD_SIZE, height=SHARD_SIZE,
                                    device=dev)
        args = (r.scene_data, r.camera, r.state)
        run = spmd.make_sharded_render(r.spec, r.probes, r.volumetrics,
                                       SHARD_SIZE, SHARD_SIZE, mesh,
                                       screen_cfg=r.screen_cfg,
                                       probe_cfg=r.probe_cfg)
        img_run = run(*args)[0]
        sharder = spmd.RaySharder(mesh)
        img_shard, rep = spmd.collective_report(
            sharder, lambda: P.render_frame(
                r.spec, r.probes, r.volumetrics, SHARD_SIZE, SHARD_SIZE,
                *args, screen_cfg=r.screen_cfg, probe_cfg=r.probe_cfg,
                shard=sharder)[0])
        ref = r.render()
        torch.cuda.synchronize()
        same = (run.sharder is None and torch.equal(img_run, ref)
                and torch.equal(img_shard, ref))
        skips = "skips" if run.sharder is None else "keeps"
        print(f"sharded GI {SHARD_SIZE}x{SHARD_SIZE}, world of 1 (NCCL): "
              f"make_sharded_render {skips} the sharder; the RaySharder "
              f"frame's collectives "
              f"{rep['n_collectives']} ({rep['bytes']} bytes, "
              f"{rep['in_loops']} inside a march); both frames "
              f"{'equal' if same else 'DIFFER from'} Renderer.render()'s")
        if not same or rep["in_loops"] or rep["n_collectives"] != 3:
            fail("the world-of-1 sharded frame")
        out["frame"] = dict(equal=same, collectives=rep["n_collectives"],
                            bytes=rep["bytes"])

        size = SHARD_TRAIN_SIZE
        rt = m.S.global_illumination(width=size, height=size, device=dev)
        target = torch.zeros((size, size, 3), device=dev)
        steps = {}
        for name, mesh_arg in (("unsharded", None), ("sharded", mesh)):
            step = spmd.make_train_step(rt.spec, rt.probes, rt.volumetrics,
                                        size, size,
                                        screen_cfg=rt.screen_cfg,
                                        mesh=mesh_arg)
            steps[name] = step(rt.scene_data, rt.camera, rt.state, target)
        (l0, d0, _), (l1, d1, _) = steps["unsharded"], steps["sharded"]
        # each leaf's difference relative to its update
        diff = max(rel_norm(torch, b - a0, a - a0) for a, b, a0 in zip(
            *(spmd.split_float_leaves(x)[0] for x in (d0, d1,
                                                        rt.scene_data))))
        print(f"sharded GI train step {size}x{size}, world of 1: loss "
              f"{float(l1):.8f} against {float(l0):.8f} unsharded; largest "
              f"updated-leaf difference {diff:.3e} of its update (limit "
              f"{SHARD_STEP_REL})")
        if float(l0) != float(l1) or not diff <= SHARD_STEP_REL:
            fail("the world-of-1 sharded train step differs")
        out["train"] = dict(loss=float(l1), loss_unsharded=float(l0),
                            max_leaf_diff=diff)

        import tempfile
        trees = {"scene": r.scene_data, "state": r.state,
                 "camera": r.camera}
        templates = {
            "scene": m.SceneBuilder(r.base_spec).device_data(dev),
            "state": P.initial_state(r.probes, r.volumetrics, dev),
            "camera": P.Camera(position=torch.zeros(3, device=dev),
                               orientation=torch.zeros((3, 3), device=dev))}
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "gi.npz")
            m.checkpoint.save(path, **trees)
            back = m.checkpoint.load(path, device=dev, **templates)
        bit = all(torch.equal(a, b) and a.device == b.device
                  for name in trees for a, b in zip(
                      m.tree_leaves(trees[name]), m.tree_leaves(back[name])))
        nxt = [P.render_frame(r.spec, r.probes, r.volumetrics, SHARD_SIZE,
                              SHARD_SIZE, t["scene"], t["camera"],
                              t["state"], screen_cfg=r.screen_cfg,
                              probe_cfg=r.probe_cfg)[0]
               for t in (trees, back)]
        same_next = torch.equal(*nxt)
        print(f"checkpoint GI {SHARD_SIZE}x{SHARD_SIZE} from cuda: "
              f"{len(m.tree_leaves(trees['scene']))} scene leaves, state, "
              f"camera; loaded back {'bit-equal' if bit else 'DIFFERENT'}; "
              f"next frame {'equal' if same_next else 'DIFFERENT'}")
        if not (bit and same_next):
            fail("the checkpoint round trip on the card")
        out["checkpoint"] = dict(bit_equal=bit, next_frame_equal=same_next)
    finally:
        torch.distributed.destroy_process_group()
    print(f"multi-device: a world of 1 on this host's one card; a second "
          f"process on the same card is not attempted and scaling is not "
          f"measured; [{card}]")
    return out


# Phase 35: the functions the port gained last (the parity of its public
# names with the JAX package's).
API_SIZE = 800
API_FRAMES = 5
# sample_irradiance's gather against its matmul method: the tolerance
# tests/test_probes.py holds the JAX package's two methods to
LOOKUP_ATOL = 1e-5


def read_trace(log_dir):
    """The device kernels' names in the one *.pt.trace.json that
    trace(log_dir) wrote."""
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    if len(files) != 1:
        fail(f"trace wrote {len(files)} trace files in {log_dir}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "kernel"]


def api_phase(torch, m, dev, card):
    """Phase 35 on the GI room at 800x800 after 4 frames: the gather and
    matmul lookups held together and timed; trace(log_dir) around one
    frame (launches counted: 2 geometry, no other kernel), its trace file
    naming the geometry kernel; the scene's checkpoint loaded into
    spec.empty_data(device), bit-equal and rendering the same frame;
    FrameTimer.time_fn beside frame().  Returns (the numbers, the traced
    frame's launches)."""
    import tempfile
    r = m.S.global_illumination(width=API_SIZE, height=API_SIZE, device=dev)
    r.converge(frames=4)
    o, d = gi_rays(torch, m, r, dev)[3]
    g = m.SceneCtx(r.spec, r.scene_data).geometry(o, d, r.probes,
                                                  r.screen_cfg)
    pos = (o + d * g["t"][:, None]).contiguous()
    irr = r.state.irradiance

    def lookup(method):
        return m.probes.sample_irradiance(r.probes, irr, pos, g["normal"],
                                          vis8=g["vis8"], method=method)
    methods = ("gather", "matmul")
    vals = {k: lookup(k) for k in methods}
    err = (vals["gather"] - vals["matmul"]).abs().max().item()
    finite = all(bool(torch.isfinite(v).all()) for v in vals.values())
    ms = dict(zip(methods, time_turns(
        torch, [lambda k=k: lookup(k) for k in methods], iters=5)))
    n = pos.shape[0]
    print(f"sample_irradiance GI {API_SIZE}x{API_SIZE} ({n} points, "
          f"{int(g['hit'].sum())} hits): gather {ms['gather']:.3f} ms, "
          f"matmul {ms['matmul']:.3f} ms (PyTorch ops, no kernel of the "
          f"port); max abs difference {err:.3e} (limit {LOOKUP_ATOL}); "
          f"[{card}]")
    if n != API_SIZE * API_SIZE or not finite or not err <= LOOKUP_ATOL:
        fail("sample_irradiance: gather and matmul disagree")
    out = dict(points=n, gather_ms=ms["gather"], matmul_ms=ms["matmul"],
               max_abs_diff=err)

    with tempfile.TemporaryDirectory() as tmp:
        reset_launches(m)
        with m.trace(tmp) as log_dir:
            r.render()
        launches = launch_counts(m)
        kernels = read_trace(log_dir)
        path = os.path.join(tmp, "gi.npz")
        m.checkpoint.save(path, scene=r.scene_data)
        back = m.checkpoint.load(
            path, scene=r.base_spec.empty_data(dev))["scene"]
    geo = [k for k in kernels if "geometry_kernel" in k]
    print(f"trace GI {API_SIZE}x{API_SIZE}: {len(kernels)} device kernels "
          f"in the trace file, {len(geo)} of them the geometry kernel "
          f"({geo[0] if geo else 'none'}); launches {json.dumps(launches)}")
    if len(geo) != 2 or launches != dict.fromkeys(KERNELS, 0) | \
            {"geometry": 2}:
        fail("the traced GI frame: expected 2 geometry launches, named in "
             "the trace")
    out["trace"] = dict(device_kernels=len(kernels), geometry=len(geo),
                        launches=launches)

    bit = all(a.device == b.device and torch.equal(a, b) for a, b in zip(
        m.tree_leaves(r.scene_data), m.tree_leaves(back), strict=True))
    frames = [m.pipeline.render_frame(
        r.spec, r.probes, r.volumetrics, API_SIZE, API_SIZE, data,
        r.camera, r.state, screen_cfg=r.screen_cfg,
        probe_cfg=r.probe_cfg)[0] for data in (r.scene_data, back)]
    same = torch.equal(*frames)
    print(f"checkpoint into spec.empty_data({dev}): "
          f"{len(m.tree_leaves(back))} leaves "
          f"{'bit-equal' if bit else 'DIFFERENT'}; the frame "
          f"{'equal' if same else 'DIFFERENT'}")
    if not (bit and same):
        fail("the empty_data checkpoint template")
    out["checkpoint"] = dict(bit_equal=bit, frame_equal=same)

    sec, img = m.FrameTimer(dev).time_fn(r.render, warmup=1,
                                         iters=API_FRAMES)
    timer = m.FrameTimer(dev)
    for _ in range(API_FRAMES):
        with timer.frame():
            r.render()
    if not bool(torch.isfinite(img).all()):
        fail("time_fn's frame is not finite")
    print(f"GI {API_SIZE}x{API_SIZE}: FrameTimer.time_fn {sec * 1e3:.3f} "
          f"ms/frame over {API_FRAMES} frames, frame() "
          f"{timer.mean * 1e3:.3f} ms/frame; [{card}]")
    out.update(time_fn_ms=sec * 1e3, frame_ms=timer.mean * 1e3)
    return out, launches


# Phase 36: the geometry kernel's want_shadows / want_vis.
MARCHES_OFF = {"no_shadows": {"want_shadows": False},
               "no_vis": {"want_vis": False},
               "neither": {"want_shadows": False, "want_vis": False}}
FLAG_SIZE = 800


def same_outputs(torch, a, b):
    """Every output of two geometry calls bit-equal, the reflection's
    too."""
    if (a["refl"] is None) != (b["refl"] is None):
        return False
    pairs = [(a, b)] + ([(a["refl"], b["refl"])] if a["refl"] else [])
    return all(torch.equal(x[k], y[k]) for x, y in pairs for k in y
               if k != "refl")


def flags_phase(torch, m, dev, card):
    """Phase 36 on the bench's global_illumination and obj_mesh
    configurations at FLAG_SIZE².  Returns ({config: geom_probe's ms,
    split, lanes, rays, the holds' largest difference}, the largest
    difference of every hold)."""
    M = m.M
    out, max_err = {}, 0.0
    for label in ("global_illumination", "obj_mesh"):
        r = m.bench.make_config(label, FLAG_SIZE, dev)
        ctx = m.SceneCtx(r.spec, r.scene_data)
        _, scr_sub, rad_full, scr_full = gi_rays(torch, m, r, dev)
        lanes = sorted({M.geometry_lanes(ctx.packed, rays[0].shape[0])
                        for rays in (rad_full, scr_full)})
        passes = {"radiance": (m.PROBE_SHADE_CONFIG, False, rad_full),
                  "screen": (r.screen_cfg,
                             r.screen_cfg.indirect_specular_mode == 2,
                             scr_sub)}

        def run(fn, name, **kw):
            cfg, refl, rays = passes[name]
            return fn(ctx.packed, ctx.lpos_vec, ctx.n_light_slots, rays[0],
                      rays[1], ctx.max_dist,
                      probe_spacing=r.probes.grid_spacing,
                      probe_dims=r.probes.grid_dimensions,
                      surface_offset=m.SURFACE_OFFSET,
                      ao_steps=cfg.ambient_occlusion_steps,
                      max_steps=cfg.max_march_steps,
                      mat_rough_vec=ctx.rough_vec if refl else None,
                      refl_shadows=cfg.add_indirect_specular, **kw)

        errs = {}
        for name, (_, _, rays) in passes.items():
            n = rays[0].shape[0]
            base = run(M.geometry, name)
            on = run(M.geometry, name, want_shadows=True, want_vis=True)
            torch.cuda.synchronize()
            if not same_outputs(torch, on, base):
                fail(f"{label} {name}: the flags on differ from the call "
                     f"without them")
            del base, on
            for off, flags in MARCHES_OFF.items():
                ref = run(M.geometry_reference, name, **flags)
                torch.cuda.synchronize()
                for x in lanes:
                    k = run(M.geometry, name,
                            library=M.geometry_library(x), **flags)
                    torch.cuda.synchronize()
                    for key, want in (("shadows", "want_shadows"),
                                      ("vis8", "want_vis")):
                        if not flags.get(want, True) and not bool(
                                (k[key] == 1).all()):
                            fail(f"{label} {name} {off}: {key} not all ones")
                    tag = f"{label} {name} {off}, {x} lanes"
                    errs[tag] = check_geometry(torch, f"flags {tag}", n, k,
                                               ref)
                    del k
                del ref
        ms, chosen, n = m.geom_probe.time_variants(r)
        split = m.geom_probe.split(ms)
        print(f"geom_probe {label} {FLAG_SIZE}x{FLAG_SIZE} ({n} screen "
              f"rays, {chosen} lanes, no reflection fold, lower of 2 turns "
              f"of {m.geom_probe.REPS} launches): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
              + f"; [{card}]")
        print(f"split {label}: " + ", ".join(
            f"{k} {v:.4f} ms ({v / ms['full']:.1%})" for k, v in split.items())
              + f"; [{card}]")
        worst = max(errs.values())
        max_err = max(max_err, worst)
        out[label] = dict(ms=ms, split=split, lanes=chosen, rays=n,
                          held_lanes=lanes, max_abs_err=worst)
    return out, max_err


# Phase 37: the bench entry point.
BENCH_TIMEOUT_S = 900
BENCH_KEYS = ("metric", "value", "unit", "configs", "train_step",
              "per_pass_ms", "golden_breaches", "scaling_efficiency",
              "gpu_vs_golden", "device")


def bench_phase(torch, gi_per_frame):
    """Phase 37: python -m madarch_tpu_torch.bench in a subprocess, its
    progress on this script's stderr; returns (its JSON line, the wall
    seconds).  gi_per_frame: phase 5's launches per frame."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "madarch_tpu_torch.bench"], cwd=REPO,
        stdout=subprocess.PIPE, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if not lines:
        fail(f"bench printed nothing (exit {proc.returncode})")
    print(f"bench: exit {proc.returncode} in {wall:.1f} s")
    if proc.returncode != 0:
        fail(f"bench exited {proc.returncode}: {lines[-1][:4000]}")
    out = json.loads(lines[-1])
    missing = [k for k in BENCH_KEYS if k not in out]
    if missing:
        fail(f"bench's line lacks {missing}")
    for name, cfg in out["configs"].items():
        ms = cfg.get("frame_ms")
        if not (isinstance(ms, (int, float)) and math.isfinite(ms)
                and ms > 0.0):
            fail(f"bench {name}: frame_ms {ms}")
    gi = out["configs"]["global_illumination"]["launches_per_frame"]
    if {k: gi[k] for k in KERNELS} != gi_per_frame:
        fail(f"bench GI launches per frame {gi}, phase 5's {gi_per_frame}")
    for name, cfg in out["configs"].items():
        traced = cfg["traced_launches_per_frame"]
        if not cfg["compiled"] or any(
                not math.isclose(traced[k], v, abs_tol=1e-6)
                for k, v in cfg["launches_per_frame"].items()):
            fail(f"bench {name}: compiled {cfg['compiled']}, launches a "
                 f"captured frame {cfg['launches_per_frame']}, traced "
                 f"{traced}")
    train = out["train_step"]
    for t in [train] + [v for k, v in train.items() if k.startswith("at_")]:
        if not t["compiled"] or t["capture_s"] is None or not all(
                math.isfinite(t[k]) and t[k] > 0.0
                for k in ("frame_ms", "eager_ms_per_step")):
            fail(f"bench train step {t['size']}: compiled {t['compiled']}, "
                 f"capture {t['capture_s']}, {t['frame_ms']} ms/step, eager "
                 f"{t['eager_ms_per_step']}")
    return out, wall


# Phase 38: the box-exit cap (ops/march.py:ray_box_cap, csrc/scene.cuh:
# box_cap) on obj_mesh, the one all-bounded scene of the path; the images
# of the four kernel-route scenes with the cap on and off.
CAP_SIZE = 800
CAP_FRAMES = 2
CAP_IMAGES = ("global_illumination", "light_shafts", "simple_scene",
              "obj_mesh")


@contextlib.contextmanager
def cap_off(m):
    """Every scene packed inside the block has its box-exit cap dropped.
    A compiled frame packs its scene inside its graph, so the frames
    compiled before the block and inside it are dropped at its edges."""
    M = m.M
    pack = M.pack_scene
    M.pack_scene = lambda spec, data: M.without_box_cap(pack(spec, data))
    m.pipeline.clear_compiled()
    try:
        yield
    finally:
        M.pack_scene = pack
        m.pipeline.clear_compiled()


def hold_cap_off(torch, label, on, off, max_dist):
    """The capped geometry outputs ``on`` against the uncapped ``off`` of
    the same rays, the primary's and the reflection's each on its own hits:
    hit equal everywhere, every output equal on hits, and a miss's t
    max_dist or the uncapped t.  Returns the misses at t = max_dist."""
    same, n_capped, n_miss = True, 0, 0
    pairs = [(on, off)] + ([(on["refl"], off["refl"])] if on["refl"] else [])
    for a, b in pairs:
        hit = a["hit"]
        n = hit.shape[0]
        same &= torch.equal(hit, b["hit"])
        for key, x in a.items():
            if key == "refl":
                continue
            mask = hit.view(n, *[1] * (x.dim() - 1)) if x.shape[0] == n \
                else hit[None]
            same &= not bool(((x != b[key]) & mask).any())
        miss = ~hit
        capped = miss & (a["t"] == max_dist)
        same &= bool(((a["t"] == b["t"]) | capped)[miss].all())
        n_capped += int(capped.sum())
        n_miss += int(miss.sum())
    print(f"cap {label}: capped against uncapped, every output equal on "
          f"hits, {n_capped} of {n_miss} misses (primary and reflection) "
          f"at t = max_dist; {'equal' if same else 'DIFFERENT'}")
    if not same:
        fail(f"cap {label}: capped and uncapped outputs differ beyond a "
             f"miss's t")
    return n_capped


# The geometry kernel classifies only a bounce that can hit (csrc/
# geometry.cu:bounce): on the torus at the cell's size, the bounces it
# skipped by its own count, the convention on them, and the folded screen
# launch and its misses alone (the primary launch, no fold) timed.  Beside
# them the same launches of the kernel that classified every bounce
# (tools/tree_outputs.py on the tree before the skip, in turns with this
# one in one call; NVIDIA H100 80GB HBM3, 700.00 W), ms.
SKIP_SIZE = 1000
SKIP_BEFORE_MS = {"folded": 11.348, "misses": 2.970}


def skipped_bounces(torch, k, rough, max_dist, enabled=None):
    """Bool masks of the bounces of geometry outputs ``k`` that the kernel
    does not classify: the primary's (disabled or at max_dist) and, with
    the fold, the reflection's (no primary hit, the roughness gate shut,
    or at max_dist)."""
    en = torch.ones_like(k["hit"]) if enabled is None else enabled
    masks = [~en | (k["t"] >= max_dist)]
    if k["refl"] is not None:
        r_en = k["hit"] & (rough[k["mid"].clamp(0, rough.shape[0] - 1)]
                           < 0.75)
        masks.append(~r_en | (k["refl"]["t"] >= max_dist))
    return masks


def skip_block(torch, m, dev, card):
    """The classification skip on the torus at SKIP_SIZE² (phase 38)."""
    M = m.M
    r = m.bench.make_config("obj_mesh", SKIP_SIZE, dev)
    ctx = m.SceneCtx(r.spec, r.scene_data)
    packed, max_dist = ctx.packed, ctx.max_dist
    _, _, rad, scr = gi_rays(torch, m, r, dev)

    def run(rays, cfg, refl, **kw):
        return M.geometry(packed, ctx.lpos_vec, ctx.n_light_slots, rays[0],
                          rays[1], max_dist,
                          probe_spacing=r.probes.grid_spacing,
                          probe_dims=r.probes.grid_dimensions,
                          surface_offset=m.SURFACE_OFFSET,
                          ao_steps=cfg.ambient_occlusion_steps,
                          max_steps=cfg.max_march_steps,
                          mat_rough_vec=ctx.rough_vec if refl else None,
                          refl_shadows=cfg.add_indirect_specular, **kw)

    out = {}
    for name, cfg, refl, rays in (
            ("radiance", m.PROBE_SHADE_CONFIG, False, rad),
            ("screen", r.screen_cfg, True, scr)):
        n = rays[0].shape[0]
        k = run(rays, cfg, refl)
        masks = skipped_bounces(torch, k, ctx.rough_vec, max_dist)
        ok = bool(((k["idx"] == -1) & (k["mid"] == 0))[masks[0]].all())
        if refl:
            ok &= bool((k["refl"]["mid"] == 0)[masks[1]].all())
        done = torch.zeros(M.WORK_COUNTS, dtype=torch.int64, device=dev)
        run(rays, cfg, refl, work=done, library=M.geometry_library(
            M.geometry_lanes(packed, n), count_work=True))
        skipped = int(done[3])
        expect = sum(int(x.sum()) for x in masks)
        bounces = n * len(masks)
        print(f"skip torus {name} {SKIP_SIZE}x{SKIP_SIZE} ({n} rays, "
              f"{bounces} bounces): the kernel skipped {skipped} "
              f"classifications ({skipped / bounces:.2%}), its outputs "
              f"say {expect}; idx -1 and mid 0 on them: "
              f"{'yes' if ok else 'NO'}")
        if skipped != expect or not ok:
            fail(f"skip torus {name}: {skipped} skipped by the count, "
                 f"{expect} by the outputs, convention held: {ok}")
        out[name] = dict(rays=n, bounces=bounces, skipped=skipped,
                         share=skipped / bounces)
    hit = run(scr, r.screen_cfg, True)["hit"]
    misses = tuple(x[~hit].contiguous() for x in scr)
    ms = time_turns(torch, [lambda: run(scr, r.screen_cfg, True),
                            lambda: run(misses, r.screen_cfg, False)],
                    iters=3)
    before = SKIP_BEFORE_MS
    print(f"time skip torus {SKIP_SIZE}x{SKIP_SIZE}: folded screen launch "
          f"{ms[0]:.3f} ms (before the skip {before['folded']}), its "
          f"{misses[0].shape[0]} misses alone {ms[1]:.3f} ms (before "
          f"{before['misses']}); [{card}]")
    out.update(folded_ms=ms[0], misses_ms=ms[1], misses=misses[0].shape[0],
               before_ms=before)
    return out


def box_cap_phase(torch, m, dev, card):
    """Phase 38.  Returns ({its numbers}, {kernel: the largest
    kernel-vs-plain difference of its holds})."""
    M, S = m.M, m.S
    r = S.obj_mesh(width=CAP_SIZE, height=CAP_SIZE, obj_path=S.TORUS_OBJ,
                   device=dev)
    ctx = m.SceneCtx(r.spec, r.scene_data)
    packed = ctx.packed
    if packed.cap_margin != M.FAR_MARGIN or packed.cap_boxes.shape != (1, 6):
        fail(f"obj_mesh packs cap boxes {tuple(packed.cap_boxes.shape)} at "
             f"margin {packed.cap_margin}, expected one at {M.FAR_MARGIN}")
    max_dist = ctx.max_dist
    _, scr_sub, rad_full, scr_full = gi_rays(torch, m, r, dev)
    passes = {"radiance": (m.PROBE_SHADE_CONFIG, False, rad_full, rad_full),
              "screen": (r.screen_cfg, True, scr_full, scr_sub)}

    def run(fn, rays, name, refl=None, **kw):
        cfg = passes[name][0]
        refl = passes[name][1] if refl is None else refl
        return fn(packed, ctx.lpos_vec, ctx.n_light_slots, rays[0], rays[1],
                  max_dist, probe_spacing=r.probes.grid_spacing,
                  probe_dims=r.probes.grid_dimensions,
                  surface_offset=m.SURFACE_OFFSET,
                  ao_steps=cfg.ambient_occlusion_steps,
                  max_steps=cfg.max_march_steps,
                  mat_rough_vec=ctx.rough_vec if refl else None,
                  refl_shadows=cfg.add_indirect_specular, **kw)

    out, err = {}, dict.fromkeys(KERNELS, 0.0)
    for name, (_, _, full, held) in passes.items():
        ref = run(M.geometry_reference, held, name)
        k = run(M.geometry, held, name)
        torch.cuda.synchronize()
        err["geometry"] = max(err["geometry"], check_geometry(
            torch, f"cap obj_mesh {name}", held[0].shape[0], k, ref))
        del k, ref
        on, off = run(M.geometry, full, name), run(M.geometry, full, name,
                                                   box_cap=False)
        torch.cuda.synchronize()
        n_capped = hold_cap_off(torch, f"obj_mesh {name}", on, off, max_dist)
        del on, off
        ms_on, ms_off = time_turns(torch, [
            lambda: run(M.geometry, full, name),
            lambda: run(M.geometry, full, name, box_cap=False)], iters=3)
        n = full[0].shape[0]
        print(f"time cap geometry obj_mesh {name} ({n} rays): capped "
              f"{ms_on:.3f} ms, uncapped {ms_off:.3f} ms; [{card}]")
        out[f"geometry {name}"] = dict(rays=n, ms=ms_on, uncapped_ms=ms_off,
                                       capped_misses=n_capped)

    # where the capped screen launch's time goes: its primary launch (no
    # reflection fold, as geom_probe's) on the rays that miss alone, capped
    # and not, and on those that hit
    hit = run(M.geometry, scr_full, "screen")["hit"]
    for tag, rows in (("misses", ~hit), ("hits", hit)):
        sel = tuple(x[rows].contiguous() for x in scr_full)
        fns = [lambda: run(M.geometry, sel, "screen", refl=False)]
        if tag == "misses":
            fns.append(lambda: run(M.geometry, sel, "screen", refl=False,
                                   box_cap=False))
        ms = time_turns(torch, fns, iters=3)
        print(f"time cap geometry obj_mesh screen {tag} alone "
              f"({sel[0].shape[0]} rays, primary launch): capped "
              f"{ms[0]:.3f} ms"
              + (f", uncapped {ms[1]:.3f} ms" if len(ms) > 1 else "")
              + f"; [{card}]")
        out[f"geometry screen {tag}"] = dict(
            rays=sel[0].shape[0], ms=ms[0],
            uncapped_ms=ms[1] if len(ms) > 1 else None)
    del hit

    # the march kernels on the screen rays (most miss the torus)
    o, d = scr_full
    g = torch.Generator().manual_seed(SEED + 38)
    mx_full = torch.full((o.shape[0],), max_dist, device=dev)
    mn = (torch.rand(scr_sub[0].shape[0], generator=g) * 0.5).to(dev)
    mx = (torch.rand(scr_sub[0].shape[0], generator=g) * max_dist).to(dev)
    so, sd = scr_sub
    k = M.raycast(packed, so, sd, max_dist)
    torch.cuda.synchronize()
    err["raycast"] = check_raycast(
        torch, "cap raycast obj_mesh screen", k,
        M.raycast_reference(packed, so, sd, max_dist))
    k = M.visibility(packed, so, sd, mx)
    torch.cuda.synchronize()
    err["visibility"] = check_visibility(
        torch, "cap visibility obj_mesh screen", k,
        M.visibility_reference(packed, so, sd, mx))
    k = M.softshadows(packed, so, sd, mn, mx, 64.0)
    torch.cuda.synchronize()
    err["softshadows"] = check_softshadows(
        torch, "cap softshadows obj_mesh screen (uncapped)", k,
        M.softshadows_reference(packed, so, sd, mn, mx, 64.0))
    rc, rc_off = M.raycast(packed, o, d, max_dist), M.raycast(
        packed, o, d, max_dist, box_cap=False)
    miss = ~rc[1]
    if not (torch.equal(rc[1], rc_off[1])
            and torch.equal(rc[0][rc[1]], rc_off[0][rc[1]])
            and bool((rc[0][miss] == max_dist).all())):
        fail("cap raycast obj_mesh: capped and uncapped differ beyond a "
             "miss's t, or a miss is not at max_dist")
    if not torch.equal(M.visibility(packed, o, d, mx_full),
                       M.visibility(packed, o, d, mx_full, box_cap=False)):
        fail("cap visibility obj_mesh: capped and uncapped differ")
    del rc, rc_off
    for name, fn in (("raycast", lambda cap: M.raycast(
            packed, o, d, max_dist, box_cap=cap)),
                     ("visibility", lambda cap: M.visibility(
                         packed, o, d, mx_full, box_cap=cap))):
        ms_on, ms_off = time_turns(torch, [lambda: fn(True),
                                           lambda: fn(False)])
        print(f"time cap {name} obj_mesh screen ({o.shape[0]} rays): "
              f"capped {ms_on:.4f} ms, uncapped {ms_off:.4f} ms; [{card}]")
        out[name] = dict(rays=o.shape[0], ms=ms_on, uncapped_ms=ms_off)

    # geom_probe's split and the bench's obj_mesh row, capped and not
    rb = m.bench.make_config("obj_mesh", CAP_SIZE, dev)
    for cap in (True, False):
        ms, lanes, n = m.geom_probe.time_variants(rb, box_cap=cap)
        split = m.geom_probe.split(ms)
        tag = "capped" if cap else "uncapped"
        print(f"geom_probe obj_mesh {tag} ({n} rays, {lanes} lanes): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
              + "; split " + ", ".join(
                  f"{k} {v:.4f} ms ({v / ms['full']:.1%})"
                  for k, v in split.items()) + f"; [{card}]")
        out[f"geom_probe {tag}"] = dict(ms=ms, split=split)
    cfg = m.bench.CONFIGS["obj_mesh"]
    rows = {}
    for cap in (True, False, False, True):
        with contextlib.nullcontext() if cap else cap_off(m):
            row = m.bench.bench_renderer(
                "obj_mesh", rb, ctx.n_light_slots, frames=cfg["frames"],
                converge_frames=cfg["converge_frames"])
        rows.setdefault("capped" if cap else "uncapped", []).append(row)
    for tag, rr in rows.items():
        print(f"bench obj_mesh {tag}: ms/frame "
              + " / ".join(f"{x['frame_ms']:.3f}" for x in rr)
              + ", device busy " + " / ".join(
                  f"{x['device_busy_ms']:.3f}" for x in rr)
              + ", idle share " + " / ".join(
                  f"{x['idle_share']:.3f}" for x in rr)
              + ", geometry ms a launch " + " / ".join(
                  f"{x['kernel_ms_per_launch']['geometry']:.3f}"
                  for x in rr) + f"; [{card}]")
    out["bench obj_mesh"] = {tag: [{k: x[k] for k in (
        "frame_ms", "device_busy_ms", "profiled_wall_ms", "idle_share",
        "kernel_ms_per_launch")} for x in rr] for tag, rr in rows.items()}

    out["skip"] = skip_block(torch, m, dev, card)

    # the images: bit-equal with the cap on and off
    for name in CAP_IMAGES:
        imgs, caps = [], []
        for cap in (True, False):
            with contextlib.nullcontext() if cap else cap_off(m):
                ri = m.bench.make_config(name, CAP_SIZE, dev)
                caps.append(m.SceneCtx(ri.spec, ri.scene_data)
                            .packed.cap_margin)
                imgs.append(ri.converge(frames=CAP_FRAMES))
        bounded = caps[0] is not None
        if bounded != (name == "obj_mesh") or caps[1] is not None:
            fail(f"cap {name}: cap margins {caps}")
        same = torch.equal(*imgs)
        print(f"cap image {name} {CAP_SIZE}x{CAP_SIZE}, {CAP_FRAMES} "
              f"frames: {'capped' if bounded else 'no cap'}, with the cap "
              f"off {'bit-equal' if same else 'DIFFERENT'}")
        if not same:
            fail(f"cap {name}: the image differs with the cap off")
        out.setdefault("images_equal", {})[name] = same
        del imgs
    out["max_abs_err"] = err
    return out, err


# Phase 39: scenes past 48 KiB of staged tables (examples/large_scenes.py):
# the chunked sphere runs, the opt-in and device memory.
LARGE_SIZE = 800
LARGE_FRAMES = 3
# rays each kernel is held to its plain version on, a seeded subset of the
# screen rays: the plain versions' [points, slots] intermediates grow with
# the slots
LARGE_CHECK = {"spheres": 2048, "mesh": 2048, "huge_mesh": 512}
LARGE_PLACEMENTS = {"spheres": "staged", "mesh": "optin",
                    "huge_mesh": "global"}


@contextlib.contextmanager
def typed_spheres(M):
    """Every scene packed inside the block keeps its sphere and box types
    in the typed runs, as many slots as they have."""
    chunked = M.chunked_layout
    M.chunked_layout = lambda ptype, n: ptype is M.P.Triangle
    try:
        yield
    finally:
        M.chunked_layout = chunked


def large_scenes(m, tmp, dev, size, names=tuple(LARGE_CHECK), **kw):
    """{name: renderer} of the large scenes ``names`` at size², with the
    Renderer keywords kw (probes)."""
    LS, S = m.LS, m.S
    out = {}
    for name in names:
        if name == "spheres":
            out[name] = LS.sphere_field(size, size, device=dev, **kw)
            continue
        n = {"mesh": LS.MESH_TRIANGLES,
             "huge_mesh": LS.HUGE_MESH_TRIANGLES}[name]
        path = LS.write_grid_obj(os.path.join(tmp, f"{name}.obj"), n)
        out[name] = S.obj_mesh(width=size, height=size, obj_path=path,
                               triangle_capacity=n, device=dev, **kw)
    return out


def large_scene_phase(torch, m, dev, card):
    """Phase 39.  Returns ({its numbers}, {kernel: the largest
    kernel-vs-plain difference of its holds})."""
    import tempfile
    M, LS = m.M, m.LS
    for lanes in M.LANE_CHOICES:
        ptxas_lines(m, "geometry", ("Li2ELb1EEEv", "Li2ELb0EEEv",
                                    "Li1ELb0EEEv"), lanes_def(lanes))
    ptxas_lines(m, "march", ("Li2ELb1EEEv", "Li2ELb0EEEv", "Li1ELb0EEEv"))
    limit = M.optin_limit(M.geometry_library(8), dev)
    out, err = {"optin_limit": limit}, dict.fromkeys(KERNELS, 0.0)
    with tempfile.TemporaryDirectory() as tmp:
        rs = large_scenes(m, tmp, dev, LARGE_SIZE)
    for name, r in rs.items():
        ctx = m.SceneCtx(r.spec, r.scene_data)
        packed = ctx.packed
        extra = ctx.lpos_vec.numel() + ctx.rough_vec.numel()
        staged = {"geometry": M.smem_bytes(packed, extra),
                  "march": M.smem_bytes(packed)}
        placed = {k: M.placement_for("geometry" if k == "geometry"
                                     else "raycast", b, limit)
                  for k, b in staged.items()}
        print(f"large {name}: chunk runs {packed.chunk_runs} (type code, "
              f"first chunk, chunks), {packed.n_supers} super-chunks, "
              f"typed runs {packed.counts}; staged bytes {staged} -> "
              f"{placed}; chunk table {4 * packed.chunks.numel()} bytes in "
              f"device memory; [{card}]")
        if placed["geometry"] != LARGE_PLACEMENTS[name]:
            fail(f"large {name}: placement {placed}, expected "
                 f"{LARGE_PLACEMENTS[name]}")
        out[name] = dict(chunk_runs=packed.chunk_runs,
                         n_supers=packed.n_supers, staged_bytes=staged,
                         placement=placed)
        _, scr_sub, rad_full, scr_full = gi_rays(torch, m, r, dev)
        n_check = LARGE_CHECK[name]
        sub = tuple(x[:n_check].contiguous() for x in scr_sub)
        en = torch.rand(n_check, generator=torch.Generator().manual_seed(
            SEED + 39)).to(dev) > 0.2

        def run(fn, rays, refl, scene=packed, **kw):
            return fn(scene, ctx.lpos_vec, ctx.n_light_slots, rays[0],
                      rays[1], ctx.max_dist,
                      probe_spacing=r.probes.grid_spacing,
                      probe_dims=r.probes.grid_dimensions,
                      surface_offset=m.SURFACE_OFFSET,
                      ao_steps=r.screen_cfg.ambient_occlusion_steps,
                      max_steps=r.screen_cfg.max_march_steps,
                      mat_rough_vec=ctx.rough_vec if refl else None,
                      refl_shadows=r.screen_cfg.add_indirect_specular, **kw)

        # the four kernels against their plain versions on the subset:
        # geometry at both lane counts, without and with the fold and the
        # mask, its work counted for the bound
        for refl, mask in ((False, None), (True, en)):
            ref, flops = counted(torch, m, lambda: run(
                M.geometry_reference, sub, refl, enabled=mask))
            for lanes in M.LANE_CHOICES:
                k = run(M.geometry, sub, refl, enabled=mask,
                        library=M.geometry_library(lanes))
                torch.cuda.synchronize()
                err["geometry"] = max(err["geometry"], check_geometry(
                    torch, f"large {name}, {lanes} lanes, "
                    f"{'fold and mask' if refl else 'primary'}", n_check,
                    k, ref))
                del k
            del ref
        pruned = dict(M.pruned_evals)
        (k1, k2), (p1, p2) = time_pair(
            torch, lambda: run(M.geometry, sub, True, enabled=en),
            lambda: run(M.geometry_reference, sub, True, enabled=en),
            iters=3)
        n_l = ctx.n_light_slots
        per_ray = 25 + 4 * (10 + n_l + 8) + 4 * (14 + n_l + 8)
        b_ms, b_by = bound(flops, n_check * per_ray + scene_bytes(packed)
                           + 4 * extra)
        print(f"time large {name} geometry, fold and mask ({n_check} "
              f"rays): kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.1f}/"
              f"{p2:.1f} ms; bound {b_ms:.5f} ms ({b_by}: {flops:.4e} "
              f"flops, exact pruning's {json.dumps(pruned)}); [{card}]")
        out[name]["subset"] = dict(rays=n_check, ms=min(k1, k2),
                                   plain_ms=min(p1, p2), bound_ms=b_ms,
                                   bound_by=b_by, flops=flops,
                                   pruned=pruned)
        o, d = sub
        g = torch.Generator().manual_seed(SEED + 40)
        mx = (torch.rand(n_check, generator=g) * ctx.max_dist).to(dev)
        mn = (torch.rand(n_check, generator=g) * 0.5).to(dev)
        k = M.raycast(packed, o, d, ctx.max_dist, enabled=en)
        torch.cuda.synchronize()
        err["raycast"] = max(err["raycast"], check_raycast(
            torch, f"large {name} raycast", k, M.raycast_reference(
                packed, o, d, ctx.max_dist, enabled=en)))
        k = M.visibility(packed, o, d, mx, enabled=en)
        torch.cuda.synchronize()
        err["visibility"] = max(err["visibility"], check_visibility(
            torch, f"large {name} visibility", k, M.visibility_reference(
                packed, o, d, mx, enabled=en)))
        k = M.softshadows(packed, o, d, mn, mx, 64.0, enabled=en)
        torch.cuda.synchronize()
        err["softshadows"] = max(err["softshadows"], check_softshadows(
            torch, f"large {name} softshadows", k, M.softshadows_reference(
                packed, o, d, mn, mx, 64.0, enabled=en)))
        del k

        # each placement that holds the tables, timed in turns at the
        # passes' full shapes: the folded screen launch, the radiance
        # launch, and the march kernels on the screen rays (to max_dist;
        # the penumbra from 0 at k = 64)
        allowed = [p for p in M.PLACEMENTS
                   if M.PLACEMENTS.index(p)
                   >= M.PLACEMENTS.index(placed["geometry"])]
        mx_full = torch.full((scr_full[0].shape[0],), ctx.max_dist,
                             device=dev)
        fns = {"screen": lambda p: run(M.geometry, scr_full, True,
                                       placement=p),
               "radiance": lambda p: run(M.geometry, rad_full, False,
                                         placement=p),
               "raycast": lambda p: M.raycast(packed, *scr_full,
                                              ctx.max_dist, placement=p),
               "visibility": lambda p: (M.visibility(
                   packed, *scr_full, mx_full, placement=p),),
               "softshadows": lambda p: (M.softshadows(
                   packed, *scr_full, 0.0 * mx_full, mx_full, 64.0,
                   placement=p),)}
        for launch, fn in fns.items():
            first = fn(allowed[0])
            for p in allowed[1:]:
                other = fn(p)
                same = (same_outputs(torch, first, other)
                        if isinstance(first, dict) else all(
                            torch.equal(a, b) for a, b in zip(first, other)))
                if not same:
                    fail(f"large {name} {launch}: placement {p} differs "
                         f"from {allowed[0]}")
                del other
            del first
            ms = dict(zip(allowed, time_turns(
                torch, [lambda p=p: fn(p) for p in allowed], iters=3)))
            print(f"time large {name} {launch} by placement: "
                  + ", ".join(f"{p} {t:.3f} ms" for p, t in ms.items())
                  + f"; [{card}]")
            out[name].setdefault("ms_by_placement", {})[launch] = ms

    # the sphere field's chunked run against the same spheres forced into
    # one typed run (every slot evaluated at every step): bit-equal, timed
    r = rs["spheres"]
    ctx = m.SceneCtx(r.spec, r.scene_data)
    with typed_spheres(M):
        typed = m.SceneCtx(r.spec, r.scene_data).packed
    if typed.counts != (LS.SPHERES, 1, 0) or typed.n_chunks:
        fail(f"typed sphere field packs {typed.counts}")
    _, scr_sub, rad_full, scr_full = gi_rays(torch, m, r, dev)
    ms = {}
    for launch, rays, refl in (("screen", scr_full, True),
                               ("radiance", rad_full, False)):
        def geo(scene, rays=rays, refl=refl):
            return M.geometry(
                scene, ctx.lpos_vec, ctx.n_light_slots, *rays, ctx.max_dist,
                probe_spacing=r.probes.grid_spacing,
                probe_dims=r.probes.grid_dimensions,
                surface_offset=m.SURFACE_OFFSET, ao_steps=3,
                mat_rough_vec=ctx.rough_vec if refl else None)
        if not same_outputs(torch, geo(ctx.packed), geo(typed)):
            fail(f"large spheres {launch}: chunked and typed differ")
        ms[launch] = dict(zip(("chunked", "typed"), time_turns(
            torch, [lambda: geo(ctx.packed), lambda: geo(typed)], iters=1)))
        print(f"time large spheres {launch} ({rays[0].shape[0]} rays): "
              f"chunked {ms[launch]['chunked']:.3f} ms, typed run "
              f"{ms[launch]['typed']:.3f} ms "
              f"({M.placement_for('geometry', M.smem_bytes(typed, 3), limit)}"
              f"); "
              f"[{card}]")
    out["spheres"]["chunked_vs_typed"] = ms

    # card against CPU at 32x32 with the tiny probes, then the 800x800
    # frames: the main path
    with tempfile.TemporaryDirectory() as tmp:
        small = {x: large_scenes(m, tmp, x, 32, ("spheres", "mesh"),
                                 probes=m.ProbeSettings(**TINY_PROBES))
                 for x in (dev, "cpu")}
    for name in ("spheres", "mesh"):
        imgs = [small[x][name].converge(frames=2).cpu().numpy()
                for x in (dev, "cpu")]
        stats = m.image_stats(*imgs)
        print(f"large {name} 32x32, cuda vs cpu: {json.dumps(stats)}")
        if stats["breached"]:
            fail(f"large {name}: card vs CPU gates breached: "
                 f"{stats['breached']}")
        out[name]["golden_32"] = stats
    del small
    for name in ("spheres", "mesh"):
        r = rs[name]
        launches, ms, rays_s = drive(
            torch, m, r, f"large {name} {LARGE_SIZE}x{LARGE_SIZE}",
            LARGE_FRAMES, {"geometry": 2}, card)
        busy, wall, _ = profile_frames(
            m, r, f"large {name} {LARGE_SIZE}x{LARGE_SIZE}", card)
        out[name]["frame"] = dict(ms=ms, rays_per_s=rays_s,
                                  launches=launches, device_busy_ms=busy,
                                  profiled_wall_ms=wall,
                                  idle_share=1.0 - busy / wall)
    out["max_abs_err"] = err
    return out, err


# Phase 40: the compiled frame (render/pipeline.py:compiled_frame): each
# kernel-route scene at 800x800 captured into a CUDA graph and replayed.
COMPILED_SIZE = 800
COMPILED_REPLAYS = 20   # replays held bit for bit to the eager frame
COMPILED_TIMED = 10     # frames a turn of eager / compiled timing
COMPILED_PROFILED = 3   # frames under torch.profiler, each way
COMPILED_THROW_EVERY = 4  # ball_game: a ball thrown every so many frames


def compiled_scenes(m, dev, tmp):
    """[(label, make(), between(renderer, i) or None, captures expected
    in COMPILED_REPLAYS replays)]: the bench's configurations where it has
    them (their probes), GI modes 1 and 3, ball_game both ways (balls
    thrown between replays) and the 3,500-sphere field."""
    S, B = m.S, m.bench
    mode = {k: m.ShadeConfig(indirect_specular_mode=k) for k in (1, 3)}
    size = COMPILED_SIZE
    throws = COMPILED_REPLAYS // COMPILED_THROW_EVERY

    def ball(specialize):
        def make():
            r, step, throw = m.S.ball_game(width=size, height=size,
                                           device=dev,
                                           specialize_counts=specialize)
            throw((2.0, 2.0, 0.0), (2.0, 2.0, 4.0))
            r.step, r.throw = step, throw
            return r
        return make

    def between(r, i):
        r.step()
        if i % COMPILED_THROW_EVERY == 0:
            k = i // COMPILED_THROW_EVERY
            r.throw((0.5 + 0.4 * k, 3.0, 1.0 + 0.3 * k), (0.5, 1.0, 1.0))

    return [
        ("GI mode 2", lambda: B.make_config("global_illumination", size,
                                            dev), None, 0),
        ("GI mode 1", lambda: S.global_illumination(
            width=size, height=size, device=dev, screen_cfg=mode[1]),
         None, 0),
        ("GI mode 3", lambda: S.global_illumination(
            width=size, height=size, device=dev, screen_cfg=mode[3]),
         None, 0),
        ("light_shafts", lambda: B.make_config("light_shafts", size, dev),
         None, 0),
        ("simple_scene", lambda: B.make_config("simple_scene", size, dev),
         None, 0),
        ("obj_mesh capped", lambda: B.make_config("obj_mesh", size, dev),
         None, 0),
        ("ball_game dynamic", ball(False), between, 0),
        ("ball_game specialised", ball(True), between, throws),
        ("spheres 3500", lambda: large_scenes(m, tmp, dev, size,
                                              ("spheres",))["spheres"],
         None, 0),
    ]


def replay_holds(torch, m, r, between, replays):
    """``replays`` frames of renderer r, each image and state held bit for
    bit to render_frame's op by op on the same inputs, run in turn.
    Returns the frames that differ."""
    P = m.pipeline
    differ = 0
    for i in range(replays):
        if between is not None:
            between(r, i)
        state, data, cam = r.state, r.scene_data, r.camera
        img = r.render()
        with torch.no_grad():
            ref, ref_state = P.render_frame(
                r.spec, r.probes, r.volumetrics, r.width, r.height, data,
                cam, state, screen_cfg=r.screen_cfg, probe_cfg=r.probe_cfg)
        same = torch.equal(img, ref) and all(
            torch.equal(getattr(r.state, f.name), getattr(ref_state, f.name))
            for f in dataclasses.fields(P.FrameState))
        differ += not same
    return differ


def compiled_phase(torch, m, dev, card):
    """Phase 40 at 800x800, each scene from an empty cache of compiled
    frames: the eager first frame and the compiled one (eager warm-up,
    capture, replay; host clock), COMPILED_REPLAYS replays held bit for
    bit to eager frames on the same inputs (ball_game with balls thrown
    between them: dynamic, no capture; specialised, a capture a throw),
    eager and compiled ms/frame between CUDA events in turns (eager,
    compiled, compiled, eager), device busy and idle share under
    torch.profiler both ways, each kernel's device events a replayed
    frame held to the launches the capture recorded, the capture's
    seconds and the graph pool's bytes.  Returns {scene: numbers}."""
    import tempfile
    P = m.pipeline
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        scenes = compiled_scenes(m, dev, tmp)
        for label, make, between, want_captures in scenes:
            P.clear_compiled()
            torch.cuda.empty_cache()
            r = make()
            if not r.compiled:
                fail(f"compiled {label}: not on the kernel route")
            firsts = {}
            for way in ("eager", "compiled"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with P.eager() if way == "eager" \
                        else contextlib.nullcontext():
                    r.render()
                torch.cuda.synchronize()
                firsts[way] = time.perf_counter() - t0
            frame = r.frame
            captures = P.CompiledFrame.captures
            differ = replay_holds(torch, m, r, between, COMPILED_REPLAYS)
            new = P.CompiledFrame.captures - captures
            if differ or new != want_captures:
                fail(f"compiled {label}: {differ} of {COMPILED_REPLAYS} "
                     f"replays differ from the eager frame; {new} captures "
                     f"(expected {want_captures})")

            def eager_render():
                with P.eager():
                    return r.render()
            e1 = cuda_ms(torch, eager_render, COMPILED_TIMED)
            c1 = cuda_ms(torch, r.render, COMPILED_TIMED)
            c2 = cuda_ms(torch, r.render, COMPILED_TIMED)
            e2 = cuda_ms(torch, eager_render, COMPILED_TIMED)
            prof = {}
            for way, fn in (("eager", eager_render),
                            ("compiled", r.render)):
                trace, wall = m.trace_calls(fn, COMPILED_PROFILED)
                ops = m.kernel_ops(trace, COMPILED_PROFILED)
                busy = sum(ops.values())
                prof[way] = dict(busy_ms=busy, profiled_wall_ms=wall,
                                 idle_share=1.0 - busy / wall)
                if way == "compiled":
                    events = m.kernel_events(trace, COMPILED_PROFILED)
            launches = r.frame.launches
            traced = {k: round(sum(n for op, n in events.items()
                                   if m.bench.KERNELS[k] in op), 6)
                      for k in launches}
            if traced != {k: float(v) for k, v in launches.items()} \
                    or not launches["geometry"]:
                fail(f"compiled {label}: the trace counts {traced} kernel "
                     f"events a replayed frame, the capture recorded "
                     f"{launches}")
            f = r.frame
            cell = dict(
                eager_ms=[e1, e2], compiled_ms=[c1, c2],
                first_frame_s=firsts, warmup_s=f.warmup_s,
                capture_s=f.capture_s, pool_mib=f.pool_bytes / 2 ** 20,
                launches_per_captured_frame=launches,
                traced_launches_per_frame=traced, replays=COMPILED_REPLAYS,
                replays_differ=differ, captures_in_replays=new,
                first_key_kept=r.frame is frame, **{
                    f"{way}_{k}": v for way, p in prof.items()
                    for k, v in p.items()})
            print(f"compiled {label} {COMPILED_SIZE}x{COMPILED_SIZE}: eager "
                  f"{e1:.3f} / {e2:.3f} ms/frame, compiled {c1:.3f} / "
                  f"{c2:.3f} (CUDA events, {COMPILED_TIMED} frames a turn); "
                  f"device busy eager {prof['eager']['busy_ms']:.3f} of "
                  f"{prof['eager']['profiled_wall_ms']:.3f} ms/frame (idle "
                  f"{prof['eager']['idle_share']:.3f}), compiled "
                  f"{prof['compiled']['busy_ms']:.3f} of "
                  f"{prof['compiled']['profiled_wall_ms']:.3f} (idle "
                  f"{prof['compiled']['idle_share']:.3f}); first frame "
                  f"eager {firsts['eager']:.3f} s, compiled "
                  f"{firsts['compiled']:.3f} s (warm-up {f.warmup_s:.3f}, "
                  f"capture {f.capture_s:.3f}); graph pool "
                  f"{f.pool_bytes / 2 ** 20:.1f} MiB; launches a captured "
                  f"frame {json.dumps(launches)}, traced {json.dumps(traced)}"
                  f"; {COMPILED_REPLAYS} replays bit-equal to eager, "
                  f"{new} captures among them; [{card}]")
            out[label] = cell
            del r, frame, f
    P.clear_compiled()
    torch.cuda.empty_cache()
    return out


# Phase 41: the compiled train step (parallel/spmd.py:make_train_step,
# CompiledStep): forward, autograd backward and SGD update captured into
# one CUDA graph per static key and replayed.
STEP_REPLAYS = 10     # replays held to eager steps on the same inputs
STEP_CHAINED = 5      # chained replays against chained eager steps
STEP_EXACT = 3        # replays under deterministic algorithms, bit-equal
STEP_TIMED = 3        # steps a turn of eager / compiled timing
STEP_PROFILED = 3     # replays under torch.profiler


def step_cases(m, dev):
    """[(label, make(), kernel launches expected a step)], each at full
    width (the scene's 36 probes of 32x32 radiance texels, light_shafts'
    own volumetrics, as bench.py renders them): bench.py's GI step at
    256x256 and 512x512, and GI mode 1 (raycast and softshadows inside the
    graph) and light_shafts (raycast and visibility) at 256x256."""
    S = m.S

    def gi(size, **kw):
        return lambda: S.global_illumination(width=size, height=size,
                                             device=dev, **kw)
    return [
        ("GI 256x256", gi(256), {"geometry": 2}),
        ("GI 512x512", gi(512), {"geometry": 2}),
        ("GI mode 1 256x256", gi(256, screen_cfg=m.ShadeConfig(
            indirect_specular_mode=1)),
         {"geometry": 2, "raycast": 1, "softshadows": 1}),
        ("light_shafts 256x256", lambda: S.light_shafts(
            width=256, height=256, device=dev),
         {"geometry": 2, "raycast": 1, "visibility": 1}),
    ]


def step_items(m, out):
    """A step's (loss, new data, new state) as [(name, tensor)]: the loss,
    the three state textures, every float leaf of the data."""
    loss, data, state = out
    names = [path for path, leaf in m.tree_items(data)
             if leaf.is_floating_point()]
    return ([("loss", loss)]
            + [(f"state.{f.name}", getattr(state, f.name))
               for f in dataclasses.fields(state)]
            + list(zip(names, m.spmd.split_float_leaves(data)[0])))


def eager_spread(torch, m, pairs):
    """{item: the largest relative norm between the two eager steps of
    any of ``pairs`` [(eager step, eager step)]}: 0 for an item bit-equal
    in every pair.  A gradient summed by index_add's atomics (the material
    table's, through index_select) differs between eager steps in most
    pairs; some pairs, or all of a phase's, may agree by chance."""
    spread = {}
    for a, b in pairs:
        for (name, x), (_, y) in zip(step_items(m, a), step_items(m, b)):
            spread[name] = max(spread.get(name, 0.0), 0.0 if torch.equal(
                x, y) else rel_norm(torch, y, x))
    return spread


ATOMIC_LEAVES = "materials."   # summed by index_add's atomics


def hold_step(torch, m, label, got, ref, spread, chained=False):
    """A replayed step ``got`` against an eager step ``ref``, item by
    item.  On the same inputs: the loss, the state and every updated leaf
    bit-equal, but the material table's (ATOMIC_LEAVES: material_lookup's
    index_select, whose gradient index_add sums with atomics, in an order
    that differs from run to run; two eager steps may agree on such a sum
    by chance, so ``spread`` 0 does not make it exact), each within
    max(2 × spread, 1e-6) relative norm of ref and never beyond
    GRAD_REL_LIMIT.  ``chained``: the same step of two chains from one
    start, whose inputs part wherever an atomic sum flipped the last bit
    of an updated leaf: every item within that bound.  Returns (the items
    not bit-equal, the largest relative norm against ref)."""
    loose, worst = [], 0.0
    for (name, a), (_, b) in zip(step_items(m, got), step_items(m, ref)):
        if torch.equal(a, b):
            continue
        rel = rel_norm(torch, a, b)
        worst = max(worst, rel)
        loose.append(name)
        exact = not chained and not name.startswith(ATOMIC_LEAVES)
        if exact or not rel <= min(max(2.0 * spread[name], 1e-6),
                                   GRAD_REL_LIMIT):
            fail(f"compiled step {label}: {name} differs from the eager "
                 f"step by {rel:.3e} (eager steps: {spread[name]:.3e})")
    return loose, worst


def deterministic_holds(torch, m, make, replays):
    """Under torch.use_deterministic_algorithms (index_add without
    atomics): a new make_train_step on renderer make()'s scene, its
    capture and ``replays`` replays, each against an eager step on its
    own inputs.  Returns the items not bit-equal (none expected: the
    compiled step is the eager step bit for bit)."""
    spmd, P = m.spmd, m.pipeline
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        r = make()
        step = spmd.make_train_step(r.spec, r.probes, r.volumetrics,
                                    r.width, r.height,
                                    screen_cfg=r.screen_cfg,
                                    probe_cfg=r.probe_cfg)
        target = torch.zeros((r.height, r.width, 3), device=r.device)
        data, state, loose = r.scene_data, r.state, set()
        for _ in range(replays + 1):
            got = step(data, r.camera, state, target)
            with P.eager():
                ref = step(data, r.camera, state, target)
            loose.update(name for (name, a), (_, b) in zip(
                step_items(m, got), step_items(m, ref))
                if not torch.equal(a, b))
            data, state = got[1], got[2]
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted(loose)


def compiled_step_phase(torch, m, dev, card):
    """Phase 41: per case of step_cases, a new make_train_step: the first
    step eager and compiled (host clock: the compiled one warms up and
    captures), STEP_REPLAYS replays with their launches counted and two
    eager steps on each replay's inputs, STEP_CHAINED chained replays and
    two chains of eager steps from the same start, every replay held by
    hold_step to an eager step with the spread of all the eager pairs
    (eager_spread); under
    deterministic algorithms STEP_EXACT replays bit-equal to eager steps
    in every item (deterministic_holds); eager and compiled ms/step in
    turns (CUDA events), and the trace's device events a replayed step
    held to the launches the capture recorded, its busy ms a step, idle
    share by events (1 − busy / the mean compiled ms/step) and heaviest
    ops; the capture's seconds and the graph pool.  Returns {case:
    numbers}."""
    spmd, P = m.spmd, m.pipeline
    out = {}
    for label, make, per_step in step_cases(m, dev):
        r = make()
        step = spmd.make_train_step(r.spec, r.probes, r.volumetrics,
                                    r.width, r.height,
                                    screen_cfg=r.screen_cfg,
                                    probe_cfg=r.probe_cfg)
        cam = r.camera
        target = torch.zeros((r.height, r.width, 3), device=dev)

        def eager(data, state):
            with P.eager():
                return step(data, cam, state, target)

        firsts = {}
        for way in ("eager", "compiled"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with P.eager() if way == "eager" else contextlib.nullcontext():
                step(r.scene_data, cam, r.state, target)
            torch.cuda.synchronize()
            firsts[way] = time.perf_counter() - t0
        cs = step.compiled_step
        want = {k: per_step.get(k, 0) for k in KERNELS}
        if cs is None or {k: cs.launches[k] for k in KERNELS} != want:
            fail(f"compiled step {label}: launches a captured step "
                 f"{None if cs is None else cs.launches}, expected {want}")
        data, state = r.scene_data, r.state
        replays = []
        for _ in range(STEP_REPLAYS):
            reset_launches(m)
            got = step(data, cam, state, target)
            counted_now = launch_counts(m)
            if counted_now != want or step.compiled_step is not cs:
                fail(f"compiled step {label}: a replay counted "
                     f"{counted_now}, expected {want}")
            replays.append((got, eager(data, state), eager(data, state)))
            data, state = got[1], got[2]
        chains = {}
        for way in ("compiled", "eager", "eager2"):
            d, s_ = r.scene_data, r.state
            chains[way] = []
            for _ in range(STEP_CHAINED):
                o = step(d, cam, s_, target) if way == "compiled" \
                    else eager(d, s_)
                chains[way].append(o)
                d, s_ = o[1], o[2]
        spread = eager_spread(
            torch, m, [(ref, other) for _, ref, other in replays]
            + list(zip(chains["eager"], chains["eager2"])))
        loose, worst = set(), 0.0
        for got, ref, _ in replays:
            names, w = hold_step(torch, m, label, got, ref, spread)
            loose.update(names)
            worst = max(worst, w)
        chained_loose, chained_worst = set(), 0.0
        for got, ref in zip(chains["compiled"], chains["eager"]):
            names, w = hold_step(torch, m, f"{label} chained", got, ref,
                                 spread, chained=True)
            chained_loose.update(names)
            chained_worst = max(chained_worst, w)
        del replays, chains
        deterministic = deterministic_holds(torch, m, make, STEP_EXACT)
        if deterministic:
            fail(f"compiled step {label}: under deterministic algorithms "
                 f"{deterministic} differ from the eager step")
        run = {"d": r.scene_data, "s": r.state}

        def compiled_one():
            loss, run["d"], run["s"] = step(run["d"], cam, run["s"], target)
            return loss

        def eager_one():
            with P.eager():
                return compiled_one()
        e1 = cuda_ms(torch, eager_one, STEP_TIMED)
        c1 = cuda_ms(torch, compiled_one, STEP_TIMED)
        c2 = cuda_ms(torch, compiled_one, STEP_TIMED)
        e2 = cuda_ms(torch, eager_one, STEP_TIMED)
        trace, wall = m.trace_calls(compiled_one, STEP_PROFILED)
        ops = m.kernel_ops(trace, STEP_PROFILED)
        busy = sum(ops.values())
        heaviest = {op[:60]: round(ms, 3) for op, ms in sorted(
            ops.items(), key=lambda kv: -kv[1])[:3]}
        events = m.kernel_events(trace, STEP_PROFILED)
        traced = {k: round(sum(n for op, n in events.items()
                               if m.bench.KERNELS[k] in op), 6)
                  for k in cs.launches}
        if traced != {k: float(v) for k, v in cs.launches.items()}:
            fail(f"compiled step {label}: the trace counts {traced} kernel "
                 f"events a replayed step, the capture recorded "
                 f"{cs.launches}")
        cell = dict(
            first_step_s=firsts, warmup_s=cs.warmup_s,
            capture_s=cs.capture_s, pool_mib=cs.pool_bytes / 2 ** 20,
            launches_per_captured_step=cs.launches,
            traced_launches_per_step=traced, replays=STEP_REPLAYS,
            not_bit_equal=sorted(loose), largest_rel=worst,
            chained=STEP_CHAINED, chained_not_bit_equal=sorted(
                chained_loose), chained_largest_rel=chained_worst,
            eager_spread={k: v for k, v in spread.items() if v},
            deterministic_replays_bit_equal=STEP_EXACT,
            eager_ms=[e1, e2], compiled_ms=[c1, c2], busy_ms=busy,
            profiled_wall_ms=wall,
            idle_by_events=1.0 - 2.0 * busy / (c1 + c2),
            heaviest_ms=heaviest)
        print(f"compiled step {label}: first step eager "
              f"{firsts['eager']:.3f} s, compiled {firsts['compiled']:.3f} s "
              f"(warm-up {cs.warmup_s:.3f}, capture {cs.capture_s:.3f}); "
              f"graph pool {cell['pool_mib']:.1f} MiB; {STEP_REPLAYS} "
              f"replays held to eager steps on the same inputs (loss and "
              f"state bit-equal; not bit-equal: {sorted(loose)}, largest "
              f"relative norm {worst:.3e}); {STEP_CHAINED} chained replays "
              f"against chained eager steps (not bit-equal: "
              f"{sorted(chained_loose)}, largest {chained_worst:.3e}); "
              f"eager steps not bit-equal with each other: "
              f"{json.dumps(cell['eager_spread'])}; "
              f"under deterministic algorithms {STEP_EXACT} replays "
              f"bit-equal to eager steps in every item; "
              f"eager {e1:.3f} / {e2:.3f} ms/step, compiled {c1:.3f} / "
              f"{c2:.3f} (CUDA events, {STEP_TIMED} a turn); device busy "
              f"{busy:.3f} ms/step (torch.profiler, {STEP_PROFILED} steps; "
              f"idle by events {cell['idle_by_events']:.3f}), heaviest "
              f"{json.dumps(heaviest)}; launches a "
              f"captured step {json.dumps(cs.launches)}, traced "
              f"{json.dumps(traced)}; [{card}]")
        out[label] = cell
        del step, cs, r, run
        torch.cuda.empty_cache()
    return out


# Phase 42: the shade's probe lookups (ops/probe_lookup.py) at 10^6
# lookups: the GI room's 1000x1000 screen pass, the benchmark's frame.
PROBE_SIZE = 1000
PROBE_FRAMES = 4
PROBE_TIMED = 20
# Each kernel against its plain version (sample_irradiance's gather,
# sample_tile_bilinear at mip 1), and against the dense route, as the
# largest absolute difference over the largest output: the kernels round
# like their plain versions but for the sum over the corners; the dense
# route sums its taps in a matrix product.
PROBE_PLAIN_REL = 1e-6
PROBE_DENSE_REL = 1e-5
# A frame's mean absolute gap of the tonemapped image, kernel route
# against dense route (benchmark/limits/gi_room.look.json's "image")
PROBE_IMAGE_GAP = 1e-5


def rel_gap(a, b):
    """The largest absolute difference of a from b over b's largest
    magnitude."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@contextlib.contextmanager
def dense_lookups(m):
    """Inside the block the shade takes the dense lookups on the card too
    (render/probes.py:lookup_method answers "matmul"): for a comparison."""
    P = m.probes
    keep = P.lookup_method
    P.lookup_method = lambda n, *inputs: "matmul"
    try:
        yield
    finally:
        P.lookup_method = keep


def probe_phase(torch, m, dev, card):
    """Phase 42 on the GI room at PROBE_SIZE x PROBE_SIZE after
    PROBE_FRAMES frames: the screen pass's geometry launch (mode 2's fold)
    gives 10^6 points' positions, normals, vis8 and reflection picks.  The
    irradiance kernel held to sample_irradiance's "gather" (its plain
    version) and "matmul" (the dense route); the radiance kernel held to
    sample_tile_bilinear at mip 1 and to the dense lookup, and timed also
    with the mip computed ("mip_kernel", the shade's call); all timed in
    turns, each kernel beside its bound (bytes over 3.35 TB/s counted on
    the plain version: each point's inputs and output once, the atlas
    once).  A compiled frame's
    launches, and the eager frame's image by both routes.  Returns the
    numbers."""
    P, PL = m.probes, m.PL
    r = m.S.global_illumination(width=PROBE_SIZE, height=PROBE_SIZE,
                                device=dev)
    r.converge(frames=PROBE_FRAMES)
    cam = r.camera
    o, d = m.camera_rays(m.pixel_grid(r.width, r.height, dev), cam.position,
                         cam.orientation)
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    g = m.SceneCtx(r.spec, r.scene_data).geometry(
        o, d, r.probes, r.screen_cfg, want_reflection=True)
    pos = (o + g["t"][:, None] * d).contiguous()
    nrm, vis8, refl = g["normal"], g["vis8"], g["refl"]
    s, irr, rad = r.probes, r.state.irradiance, r.state.radiance
    best_pid, best_dir = refl["best_pid"], refl["best_dir"]
    pid = best_pid.to(torch.int32)
    n = pos.shape[0]
    res2 = s.radiance_resolution // 2
    px, py = s.probe_count
    mip1 = P.radiance_mip1(s, rad)

    def irradiance(method):
        return lambda: P.sample_irradiance(s, irr, pos, nrm, vis8=vis8,
                                           method=method)

    def rad_kernel():
        return PL.radiance_lookup(s, mip1, best_pid, best_dir)

    def rad_mip_kernel():
        return PL.radiance_lookup(s, P.radiance_mip1(s, rad), best_pid,
                                  best_dir)

    def rad_plain():
        tx, ty = P.probe_id_to_tile(s, pid)
        return P.sample_tile_bilinear(P.radiance_mip1(s, rad), tx, ty,
                                      P.dir_to_ray_id(best_dir), res2)

    def rad_dense():
        vals = P.sample_all_tiles_bilinear(
            s, P.radiance_mip1(s, rad), P.dir_to_ray_id(best_dir), res2)
        return P.probe_one_hot_combine(
            px * py, pid[None],
            torch.ones((1, n), dtype=torch.float32, device=dev), vals)

    irr_fns = {k: irradiance(k) for k in ("kernel", "gather", "matmul")}
    rad_fns = {"kernel": rad_kernel, "mip_kernel": rad_mip_kernel,
               "gather": rad_plain, "matmul": rad_dense}
    out = {"points": n, "hits": int(g["hit"].sum())}
    for name, fns, n_bytes in (
            ("irradiance", irr_fns, n * (3 + 3 + 8 + 3) * 4 + irr.nbytes),
            ("radiance", rad_fns, n * (1 + 3 + 3) * 4 + mip1.nbytes)):
        vals = {k: fn() for k, fn in fns.items()}
        gaps = {k: rel_gap(v, vals["gather"]) for k, v in vals.items()
                if k != "gather"}
        gaps["kernel_vs_matmul"] = rel_gap(vals["kernel"], vals["matmul"])
        finite = all(bool(torch.isfinite(v).all()) for v in vals.values())
        ms = dict(zip(fns, time_turns(torch, list(fns.values()),
                                      iters=PROBE_TIMED)))
        b_ms, b_by = bound(0.0, n_bytes)
        print(f"probe lookup {name} GI {PROBE_SIZE}x{PROBE_SIZE} ({n} "
              f"points): " + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                       ms.items())
              + f"; bound {b_ms:.5f} ms ({b_by}, {n_bytes} bytes), "
              f"{100 * b_ms / ms['kernel']:.1f}% of it; relative gaps "
              f"{json.dumps(gaps)}; [{card}]")
        kernels = [k for k in vals if k not in ("gather", "matmul")]
        if not finite or any(gaps[k] > PROBE_PLAIN_REL for k in kernels) \
                or gaps["kernel_vs_matmul"] > PROBE_DENSE_REL:
            fail(f"probe lookup {name}: the kernel against its plain "
                 f"version or the dense route {gaps}")
        out[name] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by,
                         bytes=n_bytes, rel_gaps=gaps)

    before = m.M.launch_counts()
    r.render()
    torch.cuda.synchronize()
    after = m.M.launch_counts()
    per_frame = {k: after[k] - before[k] for k in after}
    want = {"irradiance_lookup": 2, "radiance_lookup": 1}
    if any(per_frame[k] != v for k, v in want.items()) \
            or r.frame.launches["irradiance_lookup"] != 2:
        fail(f"probe lookups: a replayed GI frame launched {per_frame}, "
             f"expected {want}")
    images = []
    for way in ("kernel", "dense"):
        with dense_lookups(m) if way == "dense" \
                else contextlib.nullcontext():
            images.append(m.pipeline.render_frame(
                r.spec, r.probes, r.volumetrics, PROBE_SIZE, PROBE_SIZE,
                r.scene_data, r.camera, r.state, screen_cfg=r.screen_cfg,
                probe_cfg=r.probe_cfg)[0])
    gap = (images[0] - images[1]).abs()
    print(f"probe lookups GI {PROBE_SIZE}x{PROBE_SIZE}: a replayed frame "
          f"launched {json.dumps(per_frame)}; eager frame, kernel route "
          f"against dense route: image mean gap {float(gap.mean()):.3e} "
          f"(limit {PROBE_IMAGE_GAP}), max {float(gap.max()):.3e}")
    if not float(gap.mean()) <= PROBE_IMAGE_GAP:
        fail("probe lookups: the kernel route's frame against the dense "
             "route's")
    out.update(launches_per_frame=per_frame, image_mean_gap=float(
        gap.mean()), image_max_gap=float(gap.max()))
    return out


# The shade kernel against its plain chain: the largest gap over the
# chain's largest magnitude (tests/test_torch_shade_kernel.py:PLAIN_REL).
SHADE_PLAIN_REL = 1e-6


def nan_rel_gap(a, b):
    """rel_gap with NaN (Cook-Torrance's 0/0 at roughness 0) allowed at the
    same places only (else inf)."""
    nan = b.isnan()
    if not bool((a.isnan() == nan).all()):
        return math.inf
    return rel_gap(a.nan_to_num(0.0), b.nan_to_num(0.0))


@contextlib.contextmanager
def plain_shade(m):
    """Inside the block pixel_color shades with the plain chain on the
    card too (render/shading.py:shade_method answers "plain"): for a
    comparison."""
    keep = m.shading.shade_method
    m.shading.shade_method = lambda *args: "plain"
    try:
        yield
    finally:
        m.shading.shade_method = keep


def shade_phase(torch, m, dev, card):
    """Phase 43 on the GI room at PROBE_SIZE x PROBE_SIZE after
    PROBE_FRAMES frames: the screen pass's geometry (mode 2's fold) and
    the probe pass's, with their lookups, shaded by the kernel and by the
    plain chain (shade_hits, the sky, the hit position), held together;
    the kernel alone, the kernel route (the probe lookups, then the
    kernel: what pixel_color runs) and the plain chain timed in turns
    beside the kernel's bound in bytes (each ray's inputs and outputs
    once: origin, direction, t, hit, normal, material, AO, a shadow a
    light slot, the irradiance; mode 2 also the reflection's t, hit,
    material, normal and shadows and the radiance; colour and hit
    position).  The device operations of a replayed frame by both routes,
    and the eager 1000x1000 frames of GI, light_shafts and the torus by
    both routes.  Returns the numbers."""
    SH, SK = m.shading, m.SK
    r = m.S.global_illumination(width=PROBE_SIZE, height=PROBE_SIZE,
                                device=dev)
    r.converge(frames=PROBE_FRAMES)
    cam = r.camera
    o, d = m.camera_rays(m.pixel_grid(r.width, r.height, dev), cam.position,
                         cam.orientation)
    rr = r.probes.radiance_resolution
    rays = {
        "screen": (r.screen_cfg, o.reshape(-1, 3).contiguous(),
                   d.reshape(-1, 3).contiguous()),
        "probe": (r.probe_cfg,
                  m.probes.probe_world_positions(r.probes, dev).repeat(
                      rr * rr, 1).contiguous(),
                  m.probes.texel_directions(rr, dev).repeat_interleave(
                      r.probes.num_probes, dim=0).contiguous())}
    irr_atlas, rad_atlas = r.state.irradiance, r.state.radiance
    out = {}
    for label, (cfg, ro, rd) in rays.items():
        ctx = m.SceneCtx(r.spec, r.scene_data)
        mode2 = cfg.indirect_specular_mode == 2
        g = ctx.geometry(ro, rd, r.probes, cfg, want_reflection=mode2)
        n = ro.shape[0]
        pos = ro + g["t"][:, None] * rd
        irr = m.probes.sample_irradiance(r.probes, irr_atlas, pos,
                                         g["normal"], vis8=g["vis8"],
                                         method="kernel")
        rad = m.probes.mode2_radiance(
            r.probes, rad_atlas, g["refl"]["best_pid"],
            g["refl"]["best_dir"]) if mode2 else None
        table = ctx.light_table

        def alone():
            return SK.shade(table, r.scene_data.materials, ro, rd, g, irr,
                            rad, mode=cfg.indirect_specular_mode,
                            direct_specular=cfg.direct_specular,
                            add_indirect_specular=cfg.add_indirect_specular,
                            max_dist=r.spec.max_dist,
                            surface_offset=m.SURFACE_OFFSET)

        def route():
            return SH._shade_kernel(r.spec, r.scene_data, r.probes, cfg, ctx,
                                    irr_atlas, rad_atlas, ro, rd, g)

        def plain():
            p = ro + g["t"][:, None] * rd
            hit = g["hit"]
            lit = SH.shade_hits(r.spec, r.scene_data, r.probes, cfg, ctx,
                                irr_atlas, rad_atlas, p, g["normal"], rd,
                                hit, g)
            return (torch.where(hit[..., None], lit, SH.sky_color(rd)),
                    torch.where(hit[..., None], p,
                                ro + r.spec.max_dist * rd))

        fns = {"kernel": alone, "kernel_route": route, "plain": plain}
        with torch.no_grad():
            vals = {k: fn() for k, fn in fns.items()}
            torch.cuda.synchronize()
            gaps = {f"{k}_{part}": nan_rel_gap(vals[k][i], vals["plain"][i])
                    for k in ("kernel", "kernel_route")
                    for i, part in enumerate(("color", "hit_pos"))}
            ms = dict(zip(fns, time_turns(torch, list(fns.values()),
                                          iters=PROBE_TIMED)))
        n_lights = table.shape[0]
        per_ray = (3 + 3 + 1 + 3 + 1 + 1 + n_lights + 3) * 4 + 1 \
            + 2 * 3 * 4
        if mode2:
            per_ray += (1 + 1 + 3 + n_lights + 3) * 4 + 1
        n_bytes = n * per_ray + table.nbytes + sum(
            x.nbytes for x in r.scene_data.materials.values())
        b_ms, b_by = bound(0.0, n_bytes)
        print(f"shade kernel GI {PROBE_SIZE}x{PROBE_SIZE} {label} ({n} rays, "
              f"{int(g['hit'].sum())} hits, {n_lights} light slots): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
              + f"; bound {b_ms:.5f} ms ({b_by}, {n_bytes} bytes), "
              f"{100 * b_ms / ms['kernel']:.1f}% of it; relative gaps "
              f"{json.dumps(gaps)}; [{card}]")
        if any(not v <= SHADE_PLAIN_REL for v in gaps.values()):
            fail(f"shade kernel {label}: the kernel against the plain "
                 f"chain {gaps}")
        out[label] = dict(rays=n, ms=ms, bound_ms=b_ms, bound_by=b_by,
                          bytes=n_bytes, rel_gaps=gaps)

    # the device operations of a replayed frame by both routes
    ops = {}
    for way in ("kernel", "plain"):
        m.pipeline.clear_compiled()
        with plain_shade(m) if way == "plain" else contextlib.nullcontext():
            r.render()
            torch.cuda.synchronize()
            launches = dict(r.frame.launches)
            prof, _ = m.trace_calls(r.render, 3)
            events = m.kernel_events(prof, 3)
        ops[way] = {"device_ops_per_frame": sum(events.values()),
                    "shade_launches": launches["shade"]}
    m.pipeline.clear_compiled()
    if ops["kernel"]["shade_launches"] != 2 \
            or ops["plain"]["shade_launches"] != 0:
        fail(f"shade kernel: a captured GI frame launched {ops}")
    print(f"shade kernel GI {PROBE_SIZE}x{PROBE_SIZE}: a replayed frame's "
          f"device operations {json.dumps(ops)}")

    # the 1000x1000 images of three scenes by both routes, eager
    images = {}
    for name in ("global_illumination", "light_shafts", "obj_mesh"):
        kw = dict(width=PROBE_SIZE, height=PROBE_SIZE, device=dev)
        s = m.S.obj_mesh(obj_path=m.S.TORUS_OBJ, **kw) \
            if name == "obj_mesh" else getattr(m.S, name)(**kw)
        s.converge(frames=PROBE_FRAMES)
        frames = []
        for way in ("kernel", "plain"):
            with plain_shade(m) if way == "plain" \
                    else contextlib.nullcontext(), torch.no_grad():
                frames.append(m.pipeline.render_frame(
                    s.spec, s.probes, s.volumetrics, PROBE_SIZE, PROBE_SIZE,
                    s.scene_data, s.camera, s.state, screen_cfg=s.screen_cfg,
                    probe_cfg=s.probe_cfg))
        (img_k, st_k), (img_p, st_p) = frames
        gap = (img_k - img_p).abs()
        images[name] = {
            "image_mean_gap": float(gap.mean()),
            "image_max_gap": float(gap.max()),
            "radiance_rel_gap": nan_rel_gap(st_k.radiance, st_p.radiance),
            "irradiance_rel_gap": nan_rel_gap(st_k.irradiance,
                                              st_p.irradiance)}
        print(f"shade kernel {name} {PROBE_SIZE}x{PROBE_SIZE}: eager frame, "
              f"kernel route against plain route {json.dumps(images[name])}"
              f" (image mean limit {PROBE_IMAGE_GAP})")
        if not images[name]["image_mean_gap"] <= PROBE_IMAGE_GAP \
                or not math.isfinite(images[name]["image_max_gap"]):
            fail(f"shade kernel: {name}'s frame by the kernel route against "
                 f"the plain route")
    out.update(frame_ops=ops, images=images)
    return out


# The volumetric kernels against the plain ops they replace: bit for bit
# (tests/test_torch_volumetrics_kernel.py), the largest gap over the plain
# output's largest magnitude.
VOL_PLAIN_REL = 0.0


@contextlib.contextmanager
def plain_volumetrics(m):
    """Inside the block the volumetric passes take the plain ops on the
    card too (render/volumetrics.py:method answers "plain"): for a
    comparison."""
    keep = m.vol.method
    m.vol.method = lambda *args: "plain"
    try:
        yield
    finally:
        m.vol.method = keep


def volumetrics_phase(torch, np, m, dev, card):
    """Phase 44 on light_shafts at PROBE_SIZE x PROBE_SIZE with upstream's
    volumetrics (100^3 froxels, a 250^2 map) after PROBE_FRAMES frames:
    each of the three passes by the kernel route and by the plain ops,
    held bit for bit, and timed in turns beside the kernel alone on the
    pass's inputs and its bound in bytes (each input read once, each
    output written once): the froxel in-scatter (ldist, vis, radiance,
    ldir, the ray's direction and the running sum in, the sum out: 68 B a
    froxel), the scattering integral (t and hit in, 16 B out a texel; the
    froxel grid and the weights once), the composite (colour and length
    in, colour out: 28 B a pixel; the map and the index maps once).  The
    device operations, busy ms and heaviest ops of a replayed frame by
    both routes.  Returns the numbers."""
    V, VK = m.vol, m.VK
    r = m.S.light_shafts(width=PROBE_SIZE, height=PROBE_SIZE, device=dev)
    r.converge(frames=PROBE_FRAMES)
    vol, spec, data, cam = r.volumetrics, r.spec, r.scene_data, r.camera
    ctx = m.SceneCtx(spec, data)
    max_steps = r.screen_cfg.max_march_steps

    def visibility():
        return V.visibility_pass(spec, data, vol, ctx, cam.position,
                                 cam.orientation, max_steps=max_steps)

    with torch.no_grad():
        grid = visibility()

    def scattering():
        return V.scattering_pass(spec, data, vol, ctx, grid, cam.position,
                                 cam.orientation, max_steps=max_steps)

    # the screen pass's inputs to the composite
    with torch.no_grad():
        scat = scattering()
        o, d = m.camera_rays(m.pixel_grid(r.width, r.height, dev),
                             cam.position, cam.orientation)
        o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
        color, _, hit_pos = m.shading.pixel_color(
            spec, data, r.probes, r.screen_cfg, r.state.irradiance,
            r.state.radiance, o, d)
        ray_len = torch.linalg.vector_norm(hit_pos - o, dim=-1)

    def composite():
        return V.composite(vol, scat, color, ray_len, r.width, r.height,
                           spec.max_dist)

    # each kernel alone on its pass's inputs
    (so, sd), (pts, ldir, ldist), (radiance, dirs) = ls_rays(torch, m, r)
    n_frox, n_slots = pts.shape[0], ctx.n_light_slots
    vis = ctx.visibility(pts, ldir, ldist, max_steps=max_steps)
    acc = torch.zeros_like(pts)
    sx, sy = vol.scattering_resolution
    t, hit, _ = ctx.raycast(so, sd, vol.max_depth, max_steps=max_steps)
    n_steps = int(vol.max_depth / vol.scattering_step_size)
    fs = np.arange(n_steps, dtype=np.float32) \
        * np.float32(vol.scattering_step_size)
    weights = torch.exp(torch.as_tensor(
        -fs * np.float32(V.TAU_SCATTERING)).to(dev))
    ix = torch.as_tensor(V._center_map(r.width, sx), dtype=torch.int32,
                         device=dev)
    iy = torch.as_tensor(V._center_map(r.height, sy), dtype=torch.int32,
                         device=dev)
    n_pix = r.width * r.height
    alone = {
        "inscatter": lambda: VK.froxel_inscatter(
            acc, ldist, vis, radiance, ldir, dirs, tau=V.TAU_SCATTERING),
        "scatter_integral": lambda: VK.scatter_integral(
            t, hit, grid, weights, scattering_resolution=(sx, sy),
            max_depth=vol.max_depth, step=vol.scattering_step_size,
            visibility_step=vol.visibility_step_size),
        "composite": lambda: VK.fog_composite(
            scat, color, ray_len, ix, iy, max_dist=spec.max_dist,
            tau=V.TAU_SCATTERING)}
    passes = {"inscatter": (visibility, n_frox * 68 * n_slots),
              "scatter_integral": (scattering,
                                   sx * sy * (4 + 1 + 16) + grid.nbytes
                                   + weights.nbytes),
              "composite": (composite, n_pix * 28 + scat.nbytes
                            + ix.nbytes + iy.nbytes)}
    out = {}
    for name, (fn, n_bytes) in passes.items():
        with torch.no_grad():
            got = fn()
            with plain_volumetrics(m):
                want = fn()
            torch.cuda.synchronize()
            bit_equal = torch.equal(got.view(torch.int32),
                                    want.view(torch.int32))
            gap = rel_gap(got, want)

            def plain_fn(fn=fn):
                with plain_volumetrics(m):
                    return fn()
            ms = dict(zip(("kernel_route", "plain", "kernel"), time_turns(
                torch, [fn, plain_fn, alone[name]], iters=PROBE_TIMED)))
        b_ms, b_by = bound(0.0, n_bytes)
        print(f"volumetrics {name} light_shafts {PROBE_SIZE}x{PROBE_SIZE} "
              f"(the pass by both routes, and the kernel alone): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
              + f"; bound {b_ms:.5f} ms ({b_by}, {n_bytes} bytes), "
              f"{100 * b_ms / ms['kernel']:.1f}% of it; bit-equal "
              f"{bit_equal}, relative gap {gap:.3g}; [{card}]")
        if not gap <= VOL_PLAIN_REL:
            fail(f"volumetrics {name}: the kernel route against the plain "
                 f"ops, relative gap {gap}")
        out[name] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, bytes=n_bytes,
                         bit_equal=bit_equal, rel_gap=gap)

    # a replayed frame's device operations and busy ms by both routes
    frame = {}
    for way in ("kernel", "plain"):
        m.pipeline.clear_compiled()
        with plain_volumetrics(m) if way == "plain" \
                else contextlib.nullcontext():
            r.render()
            torch.cuda.synchronize()
            launches = {k: r.frame.launches[k] for k in (
                "scatter_integral", "fog_composite", "froxel_inscatter")}
            prof, _ = m.trace_calls(r.render, 3)
            events = m.kernel_events(prof, 3)
            ops = m.kernel_ops(prof, 3)
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:12]
        frame[way] = {"device_ops_per_frame": sum(events.values()),
                      "busy_ms_per_frame": sum(ops.values()),
                      "launches": launches,
                      "top_ms_per_frame": [[op[:90], ms] for op, ms in top]}
    m.pipeline.clear_compiled()
    if frame["kernel"]["launches"] != {"scatter_integral": 1,
                                       "fog_composite": 1,
                                       "froxel_inscatter": n_slots} \
            or any(frame["plain"]["launches"].values()):
        fail(f"volumetrics: a captured light_shafts frame launched {frame}")
    print(f"volumetrics light_shafts {PROBE_SIZE}x{PROBE_SIZE}: a replayed "
          f"frame by both routes {json.dumps(frame)}; [{card}]")
    out.update(frame=frame)
    return out


def main():
    if not os.path.isdir(os.path.join(REPO, "madarch_tpu_torch")):
        fail("madarch_tpu_torch/ is not beside this script")
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    m = port_modules()
    M, S = m.M, m.S

    # ---- 1. toolchain
    card = toolchain(torch, m)

    # ---- 2. build (both sources at once)
    build_all(m)
    for lanes in TIMED_LANES:
        ptxas_lines(m, "geometry", defines=lanes_def(lanes))
    ptxas_lines(m, "probes", kernel="probe_")
    ptxas_lines(m, "volumetrics", kernel=("scatter_", "fog_", "froxel_"))

    # ---- 3. geometry kernel vs plain version on the GI scene: seeded
    # subsets, then the passes' full shapes, held and timed
    r = S.global_illumination(width=800, height=800, device=dev)
    geo, max_err = geometry_passes(torch, m, r, "", card)

    # ---- 4. GI 128x128, 4 frames, against the JAX golden
    goldens = np.load(os.path.join(REPO, "tests", "goldens", "images.npz"))
    small = S.global_illumination(width=128, height=128, device=dev)
    img = small.converge(frames=4).cpu().numpy()
    hold_golden(m, img, goldens, "global_illumination",
                "global_illumination 128x128")

    # ---- 5. GI 800x800: counted and timed
    frames = 5
    gi_launches = drive(torch, m, r, "GI 800x800", frames,
                           {"geometry": 2}, card)[0]
    gi_busy = profile_frames(m, r, "GI 800x800", card, averaged=True)

    # ---- 7. the raycast and visibility kernels' ptxas report, each build
    march_ptxas(m, ("raycast_kernel", "visibility_kernel"))

    # ---- 8. raycast and visibility vs plain versions at light_shafts'
    # full shapes
    ls = S.light_shafts(width=800, height=800, device=dev)
    lctx = m.SceneCtx(ls.spec, ls.scene_data)
    vol = ls.volumetrics
    max_steps = ls.screen_cfg.max_march_steps
    (so, sd), (fp, fdir, fdist), _ = ls_rays(torch, m, ls)
    n_scat, n_frox = so.shape[0], fp.shape[0]
    if (n_scat, n_frox) != (62_500, 1_000_000):
        fail(f"light_shafts rays: {n_scat} scattering, {n_frox} froxel")
    froxel_en = torch.ones(n_frox, dtype=torch.bool, device=dev)
    scat_en = torch.ones(n_scat, dtype=torch.bool, device=dev)
    ls_cands = march_candidates(torch, m, lctx.packed)

    def raycast(fn, **kw):
        return fn(lctx.packed, so, sd, vol.max_depth, max_steps=max_steps,
                  **kw)

    def visibility(fn, **kw):
        return fn(lctx.packed, fp, fdir, fdist, max_steps=max_steps,
                  enabled=froxel_en, **kw)

    def raycast_on(lib, packed):
        return M._raycast(lib, packed, so, sd, vol.max_depth, scat_en,
                          max_steps=max_steps)

    def visibility_on(lib, packed):
        return M._visibility(lib, packed, fp, fdir, fdist, froxel_en,
                             max_steps=max_steps)

    # the plain versions' step counts, then each kernel held to its plain
    # version through the wrapper and in every build
    (rt, rhit, _, rc_steps), rc_flops = counted(
        torch, m, lambda: raycast(M.raycast_reference, return_steps=True))
    steps = {"scattering": step_stats(torch, "raycast scattering",
                                      rc_steps)}
    k = raycast(M.raycast)
    torch.cuda.synchronize()
    rc_err = max(check_raycast(torch, "raycast full", k, (rt, rhit)),
                 hold_builds(torch, "raycast full", raycast_on, (rt, rhit),
                             check_raycast, ls_cands))
    (rvis, vis_steps), vis_flops = counted(
        torch, m, lambda: visibility(M.visibility_reference,
                                     return_steps=True))
    steps["froxels"] = step_stats(torch, "visibility froxels", vis_steps)
    kvis = visibility(M.visibility)
    torch.cuda.synchronize()
    vis_err = max(check_visibility(torch, "visibility full", kvis, rvis),
                  hold_builds(torch, "visibility full", visibility_on, rvis,
                              check_visibility, ls_cands))
    del k, kvis, rvis

    # ---- 9. light_shafts 128x128, 2 frames, against the JAX golden
    small = S.light_shafts(width=128, height=128, device=dev)
    img = small.converge(frames=2).cpu().numpy()
    hold_golden(m, img, goldens, "light_shafts",
                "light_shafts 128x128")

    # ---- 10. light_shafts 800x800: the main path, counted and timed
    launches = drive(torch, m, ls, "light_shafts 800x800", frames,
                        {"geometry": 2, "raycast": 1,
                         "visibility": lctx.n_light_slots}, card)[0]
    split = pass_split(torch, m, ls, 3)
    print(f"light_shafts 800x800 per pass (ms, CUDA events, mean of 3; "
          f"screen includes the composite): "
          f"{json.dumps({k: round(v, 3) for k, v in split.items()})}; "
          f"[{card}]")
    profile_frames(m, ls, "light_shafts 800x800", card)

    # ---- 11. raycast and visibility kernels vs plain versions, timed
    rc_t = time_pair(torch, lambda: raycast(M.raycast),
                     lambda: raycast(M.raycast_reference))
    vis_t = time_pair(torch, lambda: visibility(M.visibility),
                      lambda: visibility(M.visibility_reference))
    slot_bytes = scene_bytes(lctx.packed)
    # per ray in: o, d, enabled (visibility: + max_dist); out: t, hit
    # (visibility: vis)
    rc_bound = bound(rc_flops, n_scat * (24 + 1 + 4 + 1) + slot_bytes)
    vis_bound = bound(vis_flops, n_frox * (24 + 4 + 1 + 4) + slot_bytes)
    for name, n, (ks, ps), (b_ms, b_by), flops in (
            ("raycast", n_scat, rc_t, rc_bound, rc_flops),
            ("visibility", n_frox, vis_t, vis_bound, vis_flops)):
        print(f"time {name} ({n} rays): kernel {ks[0]:.4f}/{ks[1]:.4f} ms, "
              f"plain {ps[0]:.1f}/{ps[1]:.1f} ms; bound {b_ms:.5f} ms "
              f"({b_by}: {flops:.4e} flops); [{card}]")
    rc_builds = time_builds(torch, m, raycast_on, "raycast scattering",
                            n_scat, rc_bound[0], card, ls_cands, lctx.packed)
    vis_builds = time_builds(torch, m, visibility_on, "visibility froxels",
                             n_frox, vis_bound[0], card, ls_cands,
                             lctx.packed)

    # ---- 12. the softshadow kernel's ptxas report, each build
    march_ptxas(m, "softshadow_kernel")

    # ---- 13. raycast and softshadow kernels vs plain versions on the rays
    # of a GI specular-mode-1 800x800 screen pass
    mode1 = m.ShadeConfig(indirect_specular_mode=1)
    mode3 = m.ShadeConfig(indirect_specular_mode=3)
    g1 = S.global_illumination(width=800, height=800, device=dev,
                               screen_cfg=mode1)
    g1ctx = m.SceneCtx(g1.spec, g1.scene_data)
    max_steps = mode1.max_march_steps
    _, _, _, (o_scr, d_scr) = gi_rays(torch, m, g1, dev)
    pos, ro, rd, ren = reflection_rays(torch, m, g1, o_scr, d_scr)
    n_refl = ro.shape[0]
    g1_cands = march_candidates(torch, m, g1ctx.packed)

    def refl_raycast(fn, **kw):
        return fn(g1ctx.packed, ro, rd, g1.spec.max_dist, max_steps=max_steps,
                  enabled=ren, **kw)

    def refl_raycast_on(lib, packed):
        return M._raycast(lib, packed, ro, rd, g1.spec.max_dist, ren,
                          max_steps=max_steps)

    (rt, rhit, spec_pos, rc1_steps), rc1_flops = counted(
        torch, m, lambda: refl_raycast(M.raycast_reference,
                                       return_steps=True))
    steps["reflections"] = step_stats(torch, "raycast mode-1 reflections",
                                      rc1_steps)
    k = refl_raycast(M.raycast)
    torch.cuda.synchronize()
    rc_err = max(rc_err, check_raycast(torch, "raycast mode-1 reflections",
                                       k, (rt, rhit)),
                 hold_builds(torch, "raycast mode-1 reflections",
                             refl_raycast_on, (rt, rhit), check_raycast,
                             g1_cands))
    del k
    pen = m.shading.glossy_corners(g1.probes, pos, spec_pos, ren & rhit)[3]
    n_pen = pen["origins"].shape[0]
    if (n_refl, n_pen) != (640_000, 5_120_000):
        fail(f"GI mode-1 rays: {n_refl} reflection, {n_pen} penumbra")

    def penumbra(fn, **kw):
        return fn(g1ctx.packed, pen["origins"], pen["dirs"], pen["min_dists"],
                  pen["max_dists"], m.shading.GLOSSY_K, max_steps=max_steps,
                  enabled=pen["enabled"], **kw)

    def penumbra_on(lib, packed):
        return M._softshadows(lib, packed, pen["origins"], pen["dirs"],
                              pen["min_dists"], pen["max_dists"],
                              m.shading.GLOSSY_K, pen["enabled"],
                              max_steps=max_steps)

    (rsh, sh_steps), sh_flops = counted(
        torch, m, lambda: penumbra(M.softshadows_reference,
                                   return_steps=True))
    steps["penumbra"] = step_stats(torch, "softshadows mode-1 penumbras",
                                   sh_steps)
    k = penumbra(M.softshadows)
    torch.cuda.synchronize()
    sh_err = max(check_softshadows(torch, "softshadows mode-1 penumbras", k,
                                   rsh),
                 hold_builds(torch, "softshadows mode-1 penumbras",
                             penumbra_on, rsh, check_softshadows, g1_cands))
    del k
    print(f"mode-1 penumbras: {int(pen['enabled'].sum())} of {n_pen} "
          f"marched, {int((rsh == 0).sum())} blocked, "
          f"{int(((rsh > 0) & (rsh < 1)).sum())} soft")
    del rsh, rc_steps, rc1_steps, sh_steps, vis_steps

    # ---- 14. the masked geometry launch (mode 3's reflection rays, no AO)
    # vs its plain version
    def masked(fn, ids=slice(None), **measure):
        return fn(g1ctx.packed, g1ctx.lpos_vec, g1ctx.n_light_slots,
                  ro[ids].contiguous(), rd[ids].contiguous(),
                  g1.spec.max_dist, probe_spacing=g1.probes.grid_spacing,
                  probe_dims=g1.probes.grid_dimensions,
                  surface_offset=m.SURFACE_OFFSET, ao_steps=0,
                  max_steps=max_steps, enabled=ren[ids].contiguous(),
                  **measure)

    sub = torch.randperm(n_refl, generator=torch.Generator().manual_seed(
        SEED))[:CHECK_RAYS].to(dev)
    for label, ids in (("masked reflections", sub),
                       ("masked reflections full", slice(None))):
        ref = masked(M.geometry_reference, ids)
        torch.cuda.synchronize()
        for lanes in M.LANE_CHOICES:
            k = masked(M.geometry, ids, library=M.geometry_library(lanes))
            torch.cuda.synchronize()
            if bool((k["t"][~ren[ids]] != 0).any()) or bool(
                    k["hit"][~ren[ids]].any()):
                fail(f"{label}: a disabled ray marched or hit")
            max_err = max(max_err, check_geometry(
                torch, f"{label}, {lanes} lanes", ref["t"].shape[0], k, ref))
            del k
        del ref

    # ---- 15. GI in modes 1 and 3 at 128x128, 4 frames: card vs CPU
    for cfg in (mode1, mode3):
        imgs = [S.global_illumination(width=128, height=128, device=d,
                                      screen_cfg=cfg).converge(frames=4)
                .cpu().numpy() for d in (dev, "cpu")]
        stats = m.image_stats(*imgs)
        print(f"GI mode {cfg.indirect_specular_mode} 128x128, cuda vs cpu: "
              f"{json.dumps(stats)}")
        if stats["breached"]:
            fail(f"GI mode {cfg.indirect_specular_mode}: card vs CPU gates "
                 f"breached: {stats['breached']}")

    # ---- 16. simple_scene: 128x128 against the JAX golden, then the
    # geometry kernel vs plain on its rays (40 live slots)
    small = S.simple_scene(width=128, height=128, device=dev)
    img = small.converge(frames=2).cpu().numpy()
    hold_golden(m, img, goldens, "simple_scene",
                "simple_scene 128x128")
    ss = S.simple_scene(width=800, height=800, device=dev)
    ss_packed = m.SceneCtx(ss.spec, ss.scene_data).packed
    if ss_packed.n_slots != 40:
        fail(f"simple_scene packs {ss_packed.n_slots} slots, expected 40")
    geo_ss, err = geometry_passes(torch, m, ss, "simple_scene ", card)
    max_err = max(max_err, err)

    # ---- 17. GI mode 1, GI mode 3 and simple_scene at 800x800: the main
    # paths, counted and timed, with the per-pass split
    g3 = S.global_illumination(width=800, height=800, device=dev,
                               screen_cfg=mode3)
    paths = {}
    for label, rr, per_frame in (
            ("GI mode 1", g1, {"geometry": 2, "raycast": 1,
                               "softshadows": 1}),
            ("GI mode 3", g3, {"geometry": 3}),
            ("simple_scene", ss, {"geometry": 2})):
        paths[label] = drive(torch, m, rr, f"{label} 800x800", frames,
                                per_frame, card)[0]
        split = pass_split(torch, m, rr, 3)
        print(f"{label} 800x800 per pass (ms, CUDA events, mean of 3): "
              f"{json.dumps({k: round(v, 3) for k, v in split.items()})}; "
              f"[{card}]")
        profile_frames(m, rr, f"{label} 800x800", card)

    # ---- 18. the softshadow kernel vs its plain version, timed
    sh_t = time_pair(torch, lambda: penumbra(M.softshadows),
                     lambda: penumbra(M.softshadows_reference), iters=5)
    # per ray in: o, d, min_dist, max_dist, enabled; out: the factor
    sh_bound = bound(sh_flops, n_pen * (24 + 4 + 4 + 1 + 4)
                     + scene_bytes(g1ctx.packed))
    print(f"time softshadows ({n_pen} rays): kernel "
          f"{sh_t[0][0]:.4f}/{sh_t[0][1]:.4f} ms, plain "
          f"{sh_t[1][0]:.1f}/{sh_t[1][1]:.1f} ms; bound {sh_bound[0]:.5f} "
          f"ms ({sh_bound[1]}: {sh_flops:.4e} flops); [{card}]")
    sh_builds = time_builds(torch, m, penumbra_on,
                            "softshadows mode-1 penumbras", n_pen,
                            sh_bound[0], card, g1_cands, g1ctx.packed)
    rc1_t = time_pair(torch, lambda: refl_raycast(M.raycast),
                      lambda: refl_raycast(M.raycast_reference))
    rc1_bound = bound(rc1_flops, n_refl * (24 + 1 + 4 + 1)
                      + scene_bytes(g1ctx.packed))
    print(f"time raycast mode-1 reflections ({n_refl} rays): kernel "
          f"{rc1_t[0][0]:.4f}/{rc1_t[0][1]:.4f} ms, plain "
          f"{rc1_t[1][0]:.1f}/{rc1_t[1][1]:.1f} ms; bound "
          f"{rc1_bound[0]:.5f} ms ({rc1_bound[1]}: {rc1_flops:.4e} flops); "
          f"[{card}]")
    rc1_builds = time_builds(torch, m, refl_raycast_on,
                             "raycast mode-1 reflections", n_refl,
                             rc1_bound[0], card, g1_cands, g1ctx.packed)

    # ---- 19-23. obj_mesh: the triangle path
    mesh, rc_mesh, vis_mesh, sh_mesh = mesh_phases(torch, m, dev, card)
    max_err = max(max_err, mesh["max_abs_err"])
    rc_err = max(rc_err, rc_mesh)
    vis_err = max(vis_err, vis_mesh)
    sh_err = max(sh_err, sh_mesh)
    # the geometry kernel's six full shapes, for the kernels line
    shapes = {f"{scene} {name}": g[name]
              for scene, g in (("GI", geo), ("simple_scene", geo_ss),
                               ("obj_mesh", mesh))
              for name in ("radiance", "screen")}

    # ---- 25. gradients: card against CPU, per float leaf
    grads = gradient_phase(torch, m, dev, card)

    # ---- 26-27. the GI train step at 256x256 and 512x512, compiled and
    # eager, timed in turns and under torch.profiler
    train = {}
    for size in TRAIN_SIZES:
        t, ways = train_phase(torch, m, dev, card, size)
        t["profile"] = train_profile(
            torch, m, ways, f"GI {size}x{size}", card,
            {"compiled": t["ms_per_step"], "eager": t["eager_ms_per_step"]})
        train[f"{size}x{size}"] = t
        del ways
        m.pipeline.clear_compiled()
    print(json.dumps({"train": dict(train, gradients=grads,
                                    grad_rel_limit=GRAD_REL_LIMIT)}))

    # ---- 28-31. bvh_test and obj_mesh baked (the generic route), ball_game
    scenes, geo_ball, ball_err = scene_phases(torch, np, m, dev, card,
                                              goldens)
    max_err = max(max_err, ball_err)
    scenes["GI 800x800 busy"] = dict(zip(
        ("busy_ms", "profiled_wall_ms", "averaged_busy_ms"), gi_busy))

    # ---- 32. the lamp room: the unfused shade on the kernel route
    lamp_k, lamp_launches = lamp_phase(torch, np, m, dev, card)
    scenes["GI lamp"] = dict(launches=lamp_launches, kernels=lamp_k)

    # ---- 33. the path tracers at full width
    pt, pt_k = pathtrace_phase(torch, np, m, dev, card)

    # ---- 34. the multi-device layer and checkpoints on the one card
    multi = multidevice_phase(torch, m, dev, card)

    # ---- 35. the functions the port gained last
    api, api_launches = api_phase(torch, m, dev, card)

    # ---- 36. the geometry kernel's want_shadows / want_vis
    flags, flags_err = flags_phase(torch, m, dev, card)
    max_err = max(max_err, flags_err)

    # ---- 37. the bench entry point
    bench_out, bench_s = bench_phase(
        torch, {k: v / frames for k, v in gi_launches.items()})

    # ---- 38. the box-exit cap: obj_mesh's capped kernels against their
    # plain versions and against the uncapped launches, timed both ways;
    # the kernel-route images with the cap on and off
    cap, cap_err = box_cap_phase(torch, m, dev, card)
    max_err = max(max_err, cap_err["geometry"])
    rc_err = max(rc_err, cap_err["raycast"])
    vis_err = max(vis_err, cap_err["visibility"])
    sh_err = max(sh_err, cap_err["softshadows"])

    # ---- 39. scenes past 48 KiB of staged tables: the chunked sphere
    # runs, the opt-in and device memory
    large, large_err = large_scene_phase(torch, m, dev, card)
    max_err = max(max_err, large_err["geometry"])
    rc_err = max(rc_err, large_err["raycast"])
    vis_err = max(vis_err, large_err["visibility"])
    sh_err = max(sh_err, large_err["softshadows"])

    # ---- 40. the compiled frame: each kernel-route scene captured into a
    # CUDA graph and replayed, held bit for bit to the eager frame, timed
    # both ways
    compiled = compiled_phase(torch, m, dev, card)

    # ---- 41. the compiled train step: forward, backward and update
    # replayed from one CUDA graph, held to eager steps
    compiled_step = compiled_step_phase(torch, m, dev, card)

    # ---- 42. the shade's probe lookups at 10^6 points: each kernel held
    # to its plain version and the dense route, timed beside its bound
    probe = probe_phase(torch, m, dev, card)

    # ---- 43. the shade kernel at 10^6 GI points against the plain chain
    # it replaces, timed beside its bound; frames by both routes
    shade = shade_phase(torch, m, dev, card)

    # ---- 44. the volumetric kernels at light_shafts' 1000x1000 against
    # the plain ops, timed beside their bounds; a frame's device operations
    volumetrics = volumetrics_phase(torch, np, m, dev, card)

    def lamp_keys(name):
        """The kernel's numbers on the lamp room (phase 32)."""
        k = lamp_k[name]
        return {"launches_gi_lamp": k["launches"],
                "ms_gi_lamp": k["ms"], "plain_ms_gi_lamp": k["plain_ms"],
                "bound_ms_gi_lamp": k["bound_ms"],
                "bound_by_gi_lamp": k["bound_by"]}
    print(json.dumps({"scenes": scenes}))
    print(json.dumps({"pathtrace": pt, "multidevice": multi}))
    print(json.dumps({"api": api}))
    print(json.dumps({"geometry_flags": flags}))
    print(json.dumps({"bench": bench_out, "bench_wall_s": bench_s}))
    print(json.dumps({"box_cap": cap}))
    print(json.dumps({"large_scenes": large}))
    print(json.dumps({"compiled": compiled,
                      "compiled_step": compiled_step}))
    print(json.dumps({"probe_lookups": probe}))
    print(json.dumps({"shade": shade}))
    print(json.dumps({"volumetrics": volumetrics}))

    def compiled_keys(name):
        """The kernel's launches a captured 800x800 frame, by scene
        (phase 40), and a captured train step, by case (phase 41)."""
        return {"launches_per_captured_frame": {
            label: c["launches_per_captured_frame"][name]
            for label, c in compiled.items()},
            "launches_per_captured_step": {
                label: c["launches_per_captured_step"][name]
                for label, c in compiled_step.items()}}

    def pt_keys(name):
        """The kernel's numbers in the path tracers (phase 33), its
        largest error folded into max_abs_err."""
        return {k: v for k, v in pt_k[name].items() if k != "max_abs_err"}

    src = "madarch_tpu_torch/ops/csrc/"
    print(json.dumps({"kernels": [
        {"name": "geometry", "route": "cuda", "source": src + "geometry.cu",
         "replaces": "madarch_tpu/ops/march.py:1163",
         "launches": launches["geometry"], "max_abs_err": max_err,
         "ms": geo["screen"]["ms"], "plain_ms": geo["screen"]["plain_ms"],
         "bound_ms": geo["screen"]["bound_ms"],
         "bound_by": geo["screen"]["bound_by"], "library_ms": None,
         "ms_radiance": geo["radiance"]["ms"],
         "plain_ms_radiance": geo["radiance"]["plain_ms"],
         "bound_ms_radiance": geo["radiance"]["bound_ms"],
         "launches_gi": gi_launches["geometry"],
         "launches_gi_mode1": paths["GI mode 1"]["geometry"],
         "launches_gi_mode3": paths["GI mode 3"]["geometry"],
         "launches_simple_scene": paths["simple_scene"]["geometry"],
         # in the timed 800x800 frames of phase 31 (5 of ball_game, 2 of
         # each generic-route scene, which launch no kernel)
         "launches_ball_game": scenes["ball_game"]["launches"]["geometry"],
         # at ball_game's 20 slots after the throws (phase 31)
         "ms_ball_game": geo_ball["screen"]["ms"],
         "plain_ms_ball_game": geo_ball["screen"]["plain_ms"],
         "bound_ms_ball_game": geo_ball["screen"]["bound_ms"],
         "ms_ball_game_radiance": geo_ball["radiance"]["ms"],
         "plain_ms_ball_game_radiance": geo_ball["radiance"]["plain_ms"],
         "bound_ms_ball_game_radiance": geo_ball["radiance"]["bound_ms"],
         "launches_gi_lamp": lamp_launches["geometry"],
         # in phase 35's frame under trace(log_dir)
         "launches_api_trace": api_launches["geometry"],
         "launches_bvh_test": scenes["bvh_test"]["launches"]["geometry"],
         "launches_obj_mesh_baked": scenes["obj_mesh baked"]["launches"][
             "geometry"],
         # geometry launches in the TRAIN_STEPS timed train steps
         "launches_train": {k: t["launches"]["geometry"]
                            for k, t in train.items()},
         "ms_simple_scene": geo_ss["screen"]["ms"],
         "plain_ms_simple_scene": geo_ss["screen"]["plain_ms"],
         "bound_ms_simple_scene": geo_ss["screen"]["bound_ms"],
         "ms_simple_scene_radiance": geo_ss["radiance"]["ms"],
         "plain_ms_simple_scene_radiance": geo_ss["radiance"]["plain_ms"],
         "bound_ms_simple_scene_radiance": geo_ss["radiance"]["bound_ms"],
         # geom_probe's four variants and their split (phase 36)
         "ms_want_variants": {k: v["ms"] for k, v in flags.items()},
         "split_want_variants": {k: v["split"] for k, v in flags.items()},
         "launches_obj_mesh": mesh["launches"],
         "ms_obj_mesh": mesh["screen"]["ms"],
         "ms_obj_mesh_radiance": mesh["radiance"]["ms"],
         "plain_ms_obj_mesh": mesh["screen"]["plain_ms"],
         "plain_ms_obj_mesh_radiance": mesh["radiance"]["plain_ms"],
         "ms_obj_mesh_subset": mesh["screen"]["sub_ms"],
         "ms_obj_mesh_radiance_subset": mesh["radiance"]["sub_ms"],
         "bound_ms_obj_mesh": mesh["screen"]["bound_ms"],
         "bound_by_obj_mesh": mesh["screen"]["bound_by"],
         "bound_ms_obj_mesh_radiance": mesh["radiance"]["bound_ms"],
         "unculled_bound_ms_obj_mesh": mesh["screen"]["unculled_bound_ms"],
         # the folded screen and the radiance launch with the box-exit cap
         # dropped, timed in turns with the capped ones (phase 38)
         "ms_obj_mesh_capped": cap["geometry screen"]["ms"],
         "ms_obj_mesh_uncapped": cap["geometry screen"]["uncapped_ms"],
         "ms_obj_mesh_radiance_capped": cap["geometry radiance"]["ms"],
         "ms_obj_mesh_radiance_uncapped": cap["geometry radiance"][
             "uncapped_ms"],
         # phase 39: the large scenes' 800x800 frames, the folded screen
         # launch at each placement that holds the tables, the sphere
         # field chunked against its typed run, the held subsets' time and
         # bound
         **{f"launches_large_{name}": large[name]["frame"]["launches"][
             "geometry"] for name in ("spheres", "mesh")},
         "ms_large_by_placement": {
             name: large[name]["ms_by_placement"]["screen"]
             for name in LARGE_CHECK},
         "ms_large_spheres_chunked_vs_typed": large["spheres"][
             "chunked_vs_typed"],
         "ms_large_subset": {name: large[name]["subset"]["ms"]
                             for name in LARGE_CHECK},
         "plain_ms_large_subset": {name: large[name]["subset"]["plain_ms"]
                                   for name in LARGE_CHECK},
         "bound_ms_large_subset": {name: large[name]["subset"]["bound_ms"]
                                   for name in LARGE_CHECK},
         # lanes per ray: the wrapper's choice and the time at each of
         # TIMED_LANES, per full shape
         "lanes": {label: g["lanes"] for label, g in shapes.items()},
         "ms_by_lanes": {label: {str(x): t
                                 for x, t in g["ms_by_lanes"].items()}
                         for label, g in shapes.items()},
         # the kernel's own counts on obj_mesh (COUNT_WORK builds) beside
         # the plain version's count of what exact pruning needs
         "work_obj_mesh": mesh["work"],
         "pruned_work_obj_mesh": {
             name: {k: mesh[name][k] for k in (
                 "plain_evals", "pruned_box_tests", "pruned_triangles")}
             for name in ("radiance", "screen")},
         **compiled_keys("geometry")},
        {"name": "raycast", "route": "cuda", "source": src + "march.cu",
         "replaces": "madarch_tpu/ops/march.py:1089",
         "launches": launches["raycast"],
         "max_abs_err": max(rc_err, lamp_k["raycast"]["max_abs_err"],
                            pt_k["raycast"]["max_abs_err"]),
         "ms": min(rc_t[0]), "plain_ms": min(rc_t[1]),
         "bound_ms": rc_bound[0], "bound_by": rc_bound[1],
         "library_ms": None,
         "candidate": launched(m, lctx.packed),
         "ms_by_build": rc_builds, "steps": steps["scattering"],
         "launches_gi_mode1": paths["GI mode 1"]["raycast"],
         "ms_gi_mode1": min(rc1_t[0]), "plain_ms_gi_mode1": min(rc1_t[1]),
         "bound_ms_gi_mode1": rc1_bound[0],
         "candidate_gi_mode1": launched(m, g1ctx.packed),
         "ms_by_build_gi_mode1": rc1_builds,
         "steps_gi_mode1": steps["reflections"], **lamp_keys("raycast"),
         "ms_obj_mesh_screen": cap["raycast"]["ms"],
         "ms_obj_mesh_screen_uncapped": cap["raycast"]["uncapped_ms"],
         "ms_large_by_placement": {
             name: large[name]["ms_by_placement"]["raycast"]
             for name in LARGE_CHECK},
         **pt_keys("raycast"), **compiled_keys("raycast")},
        {"name": "visibility", "route": "cuda", "source": src + "march.cu",
         "replaces": "madarch_tpu/ops/march.py:1127",
         "launches": launches["visibility"],
         "max_abs_err": max(vis_err, lamp_k["visibility"]["max_abs_err"]),
         "ms": min(vis_t[0]), "plain_ms": min(vis_t[1]),
         "bound_ms": vis_bound[0], "bound_by": vis_bound[1],
         "library_ms": None, "candidate": launched(m, lctx.packed),
         "ms_by_build": vis_builds, "steps": steps["froxels"],
         "steps_gi_lamp": lamp_k["visibility"]["steps"],
         "ms_obj_mesh_screen": cap["visibility"]["ms"],
         "ms_obj_mesh_screen_uncapped": cap["visibility"]["uncapped_ms"],
         "ms_large_by_placement": {
             name: large[name]["ms_by_placement"]["visibility"]
             for name in LARGE_CHECK},
         **lamp_keys("visibility"), **compiled_keys("visibility")},
        {"name": "softshadows", "route": "cuda", "source": src + "march.cu",
         "replaces": "madarch_tpu/ops/march.py:1144",
         "launches": paths["GI mode 1"]["softshadows"],
         "max_abs_err": max(sh_err, lamp_k["softshadows"]["max_abs_err"],
                            pt_k["softshadows"]["max_abs_err"]),
         "ms": min(sh_t[0]), "plain_ms": min(sh_t[1]),
         "bound_ms": sh_bound[0], "bound_by": sh_bound[1],
         "library_ms": None,
         "candidate": launched(m, g1ctx.packed),
         "ms_by_build": sh_builds, "steps": steps["penumbra"],
         "ms_large_by_placement": {
             name: large[name]["ms_by_placement"]["softshadows"]
             for name in LARGE_CHECK},
         **lamp_keys("softshadows"), **pt_keys("softshadows"),
         **compiled_keys("softshadows")},
        *({"name": name, "route": "cuda", "source": src + "probes.cu",
           "replaces": "none (madarch_tpu/render/probes.py's dense "
                       "contraction)",
           "launches_gi_frame": probe["launches_per_frame"][name],
           "max_rel_err": probe[kind]["rel_gaps"]["kernel"],
           "ms": probe[kind]["ms"]["kernel"],
           "plain_ms": probe[kind]["ms"]["gather"],
           "dense_ms": probe[kind]["ms"]["matmul"],
           "bound_ms": probe[kind]["bound_ms"],
           "bound_by": probe[kind]["bound_by"], "library_ms": None,
           **compiled_keys(name)}
          for name, kind in (("irradiance_lookup", "irradiance"),
                             ("radiance_lookup", "radiance"))),
        {"name": "shade", "route": "cuda", "source": src + "shade.cu",
         "replaces": "none (madarch_tpu/render/shading.py's XLA chain)",
         "launches_gi_frame": shade["frame_ops"]["kernel"]["shade_launches"],
         "max_rel_err": max(shade[k]["rel_gaps"]["kernel_color"]
                            for k in ("screen", "probe")),
         "ms": shade["screen"]["ms"]["kernel"],
         "plain_ms": shade["screen"]["ms"]["plain"],
         "route_ms": shade["screen"]["ms"]["kernel_route"],
         "bound_ms": shade["screen"]["bound_ms"],
         "bound_by": shade["screen"]["bound_by"], "library_ms": None,
         "ms_probe": shade["probe"]["ms"]["kernel"],
         "plain_ms_probe": shade["probe"]["ms"]["plain"],
         "bound_ms_probe": shade["probe"]["bound_ms"],
         **compiled_keys("shade")},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
