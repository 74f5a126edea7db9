"""SceneCtx: everything the marches need, built once per pass (port of
madarch_tpu/render/context.py).

The route is the scene's: ``use_kernel`` when ``ops.march.kernel_scene``
takes its types (the JAX package's ``build_plan`` is not None), and then
the scene is packed and every march launches its kernel wrapper.  Any
other scene (a BVH, a baked grid, a user's own type) takes the generic
route: the plain marches of render/raymarch.py over ``sdf_b``, the batched
scene distance, on either device, as the JAX package marches its XLA
closure (``raymarch._as_closure``).  Nothing else chooses the route.

The kernels and the plain marches see the scene detached from autograd
(the JAX package closes its marches over stop-gradient data): their
outputs are constants, and gradients re-enter only through ``sdf_b_diff``,
the batched scene distance over the live data (render/raymarch.py:
attach_hit_gradient, scene_normal).

With the recorder of utils/profiling.py on, the kernel route's packing
(pack_scene, pack_light_positions and the roughness cast; the shade
kernel's light table, when a pass first asks for it) is the device
interval ``pack``, and each geometry pass counts its rays and slot
evaluations (``SceneCtx.geometry``)."""
from __future__ import annotations

import functools

import torch

from madarch_tpu_torch.ops import march as march_ops
from madarch_tpu_torch.ops import shade_kernel
from madarch_tpu_torch.render import raymarch as rm
from madarch_tpu_torch.scene.scene import (SceneData, SceneSpec, scene_sdf,
                                           tree_map)
from madarch_tpu_torch.utils import profiling


def _chunked(fn, p, want_chunks):
    """fn(p) over p[N, 3], GRID_CHUNK points at a time when want_chunks: a
    scene of many slots holds [points, slots] intermediates, so its
    evaluation is bounded by chunks of points."""
    if not want_chunks or p.shape[0] <= march_ops.GRID_CHUNK:
        return fn(p)
    return torch.cat([fn(q) for q in p.split(march_ops.GRID_CHUNK)])


class SceneCtx:
    def __init__(self, spec: SceneSpec, data: SceneData):
        self.spec = spec
        self.data = data
        self.max_dist = spec.max_dist
        self.sdf_b_diff = lambda p: scene_sdf(spec, data, p)
        data_sg = tree_map(torch.Tensor.detach, data)
        self.data_sg = data_sg
        n_slots = sum(n for _, _, n, _ in spec.prim_bounds())
        chunky = n_slots > march_ops.CHUNK_SLOT_THRESHOLD
        self.sdf_b = lambda p: _chunked(
            lambda q: scene_sdf(spec, data_sg, q), p, chunky)
        self.packed = None
        self.lpos_vec, self.n_light_slots = None, 0
        self.rough_vec = None
        if march_ops.kernel_scene(spec):
            rough = data_sg.materials["roughness"]
            with profiling.device_span("pack", rough.device):
                self.packed = march_ops.pack_scene(spec, data_sg)
                self.lpos_vec, self.n_light_slots = \
                    march_ops.pack_light_positions(spec, data_sg)
                # material roughness: the kernel's mode-2 reflection gate
                self.rough_vec = rough.to(torch.float32).contiguous()

    @functools.cached_property
    def light_table(self):
        """The shade kernel's light table (ops/shade_kernel.py:pack_lights)
        of the scene detached, packed on first use."""
        dev = self.data_sg.materials["albedo"].device
        with profiling.device_span("pack", dev):
            return shade_kernel.pack_lights(self.spec, self.data_sg)

    @property
    def use_kernel(self) -> bool:
        """The march kernels serve this scene."""
        return self.packed is not None

    @property
    def fused_available(self) -> bool:
        """The geometry kernel serves this scene: the kernels take it and
        every live light has a vec3 'position' (the shadow rays' target)."""
        return self.use_kernel and self.lpos_vec is not None

    def geometry(self, origins, dirs, probes, cfg, want_reflection=False,
                 enabled=None, want_ao=True, want_shadows=True,
                 want_vis=True):
        """Run the fused march+classify+shadow+probe-visibility kernel;
        ``want_reflection`` folds the specular mode-2 bounce into the
        launch (the result's "refl" key); ``enabled`` (bool[N]) keeps rays
        from marching; ``want_ao`` False skips the AO probes (ao 1), as the
        reflection launch of specular mode 3 does; ``want_shadows`` and
        ``want_vis`` False skip the primary hit's penumbra and
        probe-visibility marches (ones), as a measurement that attributes
        the kernel's time does.  Only where ``fused_available``.

        Records, on either device, the pass's rays (``geometry.rays``) and
        its slot evaluations a march step: rays × the slots of the typed
        runs (``geometry.slot_rays.typed``) and rays × the chunked types'
        slots (``geometry.slot_rays.chunked``), every slot the launch
        evaluates (the live slots, where the counts are static)."""
        if not self.fused_available:
            raise ValueError("the geometry kernel does not take this scene "
                             "(SceneCtx.fused_available is false)")
        if profiling.enabled():
            n = origins.shape[0]
            profiling.count("geometry.rays", n)
            profiling.count("geometry.slot_rays.typed",
                            n * self.packed.n_slots)
            profiling.count("geometry.slot_rays.chunked",
                            n * self.packed.n_chunk_slots)
        return march_ops.geometry(
            self.packed, self.lpos_vec, self.n_light_slots, origins, dirs,
            self.max_dist, probe_spacing=probes.grid_spacing,
            probe_dims=probes.grid_dimensions,
            surface_offset=rm.SURFACE_OFFSET,
            ao_steps=cfg.ambient_occlusion_steps if want_ao else 0,
            max_steps=cfg.max_march_steps,
            mat_rough_vec=self.rough_vec if want_reflection else None,
            refl_shadows=cfg.add_indirect_specular, enabled=enabled,
            want_shadows=want_shadows, want_vis=want_vis)

    def raycast(self, origins, dirs, max_dist, *, max_steps, enabled=None):
        """(t, hit, pos) of the raycast kernel over this scene, or on the
        generic route of the plain raycast over sdf_b."""
        if self.use_kernel:
            return march_ops.raycast(self.packed, origins, dirs, max_dist,
                                     max_steps=max_steps, enabled=enabled)
        return rm.raycast(self.sdf_b, origins, dirs, max_dist,
                          max_steps=max_steps, enabled=enabled)

    def visibility(self, origins, dirs, max_dists, *, max_steps,
                   enabled=None):
        """0/1 per ray: the visibility kernel, or the plain
        raycast_visibility over sdf_b."""
        if self.use_kernel:
            return march_ops.visibility(self.packed, origins, dirs,
                                        max_dists, max_steps=max_steps,
                                        enabled=enabled)
        return rm.raycast_visibility(self.sdf_b, origins, dirs, max_dists,
                                     max_steps=max_steps, enabled=enabled)

    def softshadows(self, origins, dirs, min_dists, max_dists, k, *,
                    max_steps, enabled=None):
        """The penumbra factor per ray: the softshadow kernel, or the plain
        softshadows over sdf_b."""
        if self.use_kernel:
            return march_ops.softshadows(self.packed, origins, dirs,
                                         min_dists, max_dists, k,
                                         max_steps=max_steps,
                                         enabled=enabled)
        return rm.softshadows(self.sdf_b, origins, dirs, min_dists,
                              max_dists, k, max_steps=max_steps,
                              enabled=enabled)
