"""SceneCtx: everything the march kernels need, packed once per pass
(port of madarch_tpu/render/context.py).

The kernels and the plain marches see the scene detached from autograd
(the JAX package packs stop-gradient data): their outputs are constants,
and gradients re-enter only through ``sdf_b_diff``, the batched scene
distance over the live data (render/raymarch.py: attach_hit_gradient,
scene_normal)."""
from __future__ import annotations

import torch

from madarch_tpu_torch.ops import march as march_ops
from madarch_tpu_torch.render.raymarch import SURFACE_OFFSET
from madarch_tpu_torch.scene.scene import (SceneData, SceneSpec, scene_sdf,
                                           tree_map)


class SceneCtx:
    def __init__(self, spec: SceneSpec, data: SceneData):
        self.spec = spec
        self.data = data
        self.max_dist = spec.max_dist
        self.sdf_b_diff = lambda p: scene_sdf(spec, data, p)
        data_sg = tree_map(torch.Tensor.detach, data)
        self.packed = march_ops.pack_scene(spec, data_sg)
        self.lpos_vec, self.n_light_slots = \
            march_ops.pack_light_positions(spec, data_sg)
        if self.lpos_vec is None:
            raise NotImplementedError(
                "geometry kernel needs a vec3 'position' on every light")
        # material roughness: the kernel's mode-2 reflection gate
        self.rough_vec = data_sg.materials["roughness"].to(
            torch.float32).contiguous()

    def geometry(self, origins, dirs, probes, cfg, want_reflection=False,
                 enabled=None, want_ao=True):
        """Run the fused march+classify+shadow+probe-visibility kernel;
        ``want_reflection`` folds the specular mode-2 bounce into the
        launch (the result's "refl" key); ``enabled`` (bool[N]) keeps rays
        from marching; ``want_ao`` False skips the AO probes (ao 1), as the
        reflection launch of specular mode 3 does."""
        return march_ops.geometry(
            self.packed, self.lpos_vec, self.n_light_slots, origins, dirs,
            self.max_dist, probe_spacing=probes.grid_spacing,
            probe_dims=probes.grid_dimensions,
            surface_offset=SURFACE_OFFSET,
            ao_steps=cfg.ambient_occlusion_steps if want_ao else 0,
            max_steps=cfg.max_march_steps,
            mat_rough_vec=self.rough_vec if want_reflection else None,
            refl_shadows=cfg.add_indirect_specular, enabled=enabled)

    def raycast(self, origins, dirs, max_dist, *, max_steps, enabled=None):
        """The raycast kernel over this scene: (t, hit, pos)."""
        return march_ops.raycast(self.packed, origins, dirs, max_dist,
                                 max_steps=max_steps, enabled=enabled)

    def visibility(self, origins, dirs, max_dists, *, max_steps,
                   enabled=None):
        """The visibility kernel over this scene: 0/1 per ray."""
        return march_ops.visibility(self.packed, origins, dirs, max_dists,
                                    max_steps=max_steps, enabled=enabled)

    def softshadows(self, origins, dirs, min_dists, max_dists, k, *,
                    max_steps, enabled=None):
        """The softshadow kernel over this scene: the penumbra factor per
        ray."""
        return march_ops.softshadows(self.packed, origins, dirs, min_dists,
                                     max_dists, k, max_steps=max_steps,
                                     enabled=enabled)
