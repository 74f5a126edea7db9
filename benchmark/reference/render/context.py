"""SceneCtx: everything the geometry march needs, built once per pass (a
frozen copy of the port's render/context.py, cut to the kernel route that
the benchmark's cells take: the scene packed, the geometry launch's plain
version over it; the raycast, visibility and softshadow marches and the
generic route are not copied).

The march sees the scene detached from autograd: its outputs are
constants, and gradients re-enter only through ``sdf_b_diff``, the
batched scene distance over the live data (render/raymarch.py:
attach_hit_gradient, scene_normal)."""
from __future__ import annotations

import torch

from ..ops import march as march_ops
from ..render import raymarch as rm
from ..scene.scene import SceneData, SceneSpec, scene_sdf, tree_map


class SceneCtx:
    def __init__(self, spec: SceneSpec, data: SceneData):
        self.spec = spec
        self.data = data
        self.max_dist = spec.max_dist
        self.sdf_b_diff = lambda p: scene_sdf(spec, data, p)
        data_sg = tree_map(torch.Tensor.detach, data)
        self.packed = None
        self.lpos_vec, self.n_light_slots = None, 0
        self.rough_vec = None
        if march_ops.kernel_scene(spec):
            self.packed = march_ops.pack_scene(spec, data_sg)
            self.lpos_vec, self.n_light_slots = \
                march_ops.pack_light_positions(spec, data_sg)
            # material roughness: the kernel's mode-2 reflection gate
            self.rough_vec = data_sg.materials["roughness"].to(
                torch.float32).contiguous()

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
        the kernel's time does.  Only where ``fused_available``."""
        if not self.fused_available:
            raise ValueError("the geometry kernel does not take this scene "
                             "(SceneCtx.fused_available is false)")
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
