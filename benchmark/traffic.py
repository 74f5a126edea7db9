"""The one generator of traffic: reads a mix's parameters (a
``traffic/<mix>.json`` file) and a seed, and gives what the loop sends.

A mix's ``loop`` is ``view`` (one viewer in a closed loop: each frame is
waited for before the next pose) or ``fit`` (the train step in a loop).

View mixes give, per frame k, a camera pose and an optional scene edit:

- ``camera.path`` ``turn``: at the scene's camera position, the yaw turns
  ``yaw_step_deg`` a frame and the pitch follows ``pitch_amplitude_deg`` ·
  sin(2π · ``pitch_cycles`` · k / ``cycle_frames``);
- ``orbit``: the camera circles ``centre`` at the scene camera's distance
  and height, ``step_deg`` a frame, looking at the centre;
- ``fixed``: the scene's own pose;
- ``edit.kind`` ``light_direction``: the light ``edit.light`` (its type
  name) number ``edit.index`` turns to (cos t, sin t, 0), t = t0 +
  ``edit.rad_per_frame`` · k.

The seed sets only where in its cycle a path starts (k0 of the
``cycle_frames``-frame cycle, t0 of the light), so every seed sends the
same set of poses in another order.

Fit mixes give ``resolution``, ``lr``, the camera ``views`` (position,
yaw and pitch in degrees), the seeded view to start from, and the seeded
perturbation of the scene (materials' albedo, metallic and roughness,
the light's colour and position, each by up to its ``perturb`` amount)
that the targets are rendered with.
"""
from __future__ import annotations

import math

import numpy as np


def look_at(position, centre):
    """f32[3,3] camera orientation (columns right, up, forward; the
    camera looks along its +z) from ``position`` towards ``centre``."""
    f = np.asarray(centre, np.float64) - np.asarray(position, np.float64)
    f /= np.linalg.norm(f)
    right = np.cross([0.0, 1.0, 0.0], f)
    right /= np.linalg.norm(right)
    up = np.cross(f, right)
    return np.stack([right, up, f], axis=1).astype(np.float32)


def angles(yaw, pitch):
    """f32[3,3] orientation of yaw about y then pitch about x, as the
    renderers' ``set_camera_angles(yaw, pitch)`` composes them."""
    cx, sx = math.cos(yaw), math.sin(yaw)
    cy, sy = math.cos(pitch), math.sin(pitch)
    pitch_m = np.array([[1, 0, 0], [0, cy, sy], [0, -sy, cy]], np.float32)
    yaw_m = np.array([[cx, 0, -sx], [0, 1, 0], [sx, 0, cx]], np.float32)
    return yaw_m @ pitch_m


class ViewTraffic:
    """Poses and edits of a view mix for one seed; ``scene_position`` is
    the configuration's camera position."""

    def __init__(self, mix, seed, scene_position):
        self.mix = mix
        self.camera = mix["camera"]
        self.edit_spec = mix.get("edit")
        self.cycle = int(mix.get("cycle_frames", 1))
        rng = np.random.default_rng(seed)
        self.k0 = int(rng.integers(self.cycle))
        self.t0 = float(rng.uniform(0.0, 2.0 * math.pi))
        self.scene_position = np.asarray(scene_position, np.float32)

    def pose(self, k):
        """(position f32[3], orientation f32[3,3]) of frame k."""
        cam = self.camera
        j = self.k0 + k
        if cam["path"] == "fixed":
            return self.scene_position, np.eye(3, dtype=np.float32)
        if cam["path"] == "turn":
            yaw = math.radians(cam["yaw_step_deg"]) * j
            pitch = math.radians(cam["pitch_amplitude_deg"]) * math.sin(
                2.0 * math.pi * cam["pitch_cycles"] * j / self.cycle)
            return self.scene_position, angles(yaw, pitch)
        if cam["path"] == "orbit":
            centre = np.asarray(cam["centre"], np.float64)
            rel = self.scene_position - centre
            radius = math.hypot(rel[0], rel[2])
            a = math.atan2(rel[0], rel[2]) + math.radians(cam["step_deg"]) * j
            pos = np.array([centre[0] + radius * math.sin(a),
                            self.scene_position[1],
                            centre[2] + radius * math.cos(a)], np.float32)
            return pos, look_at(pos, centre)
        raise ValueError(f"unknown camera path {cam['path']!r}")

    def edit(self, k):
        """(light type name, index, {field: value}) of frame k's scene
        edit, or None."""
        e = self.edit_spec
        if e is None:
            return None
        if e["kind"] == "light_direction":
            t = self.t0 + e["rad_per_frame"] * k
            return e["light"], e["index"], {
                "direction": (math.cos(t), math.sin(t), 0.0)}
        raise ValueError(f"unknown edit {e['kind']!r}")


class FitTraffic:
    """The views, the start view and the target scene's perturbation of a
    fit mix for one seed."""

    def __init__(self, mix, seed):
        self.mix = mix
        self.resolution = tuple(mix["resolution"])
        self.lr = float(mix["lr"])
        rng = np.random.default_rng(seed)
        self.views = [
            (np.asarray(v["position"], np.float32),
             angles(math.radians(v["yaw_deg"]), math.radians(v["pitch_deg"])))
            for v in mix["views"]]
        self.start = int(rng.integers(len(self.views)))
        self._rng = rng

    def view(self, k):
        """The view index of step k."""
        return (self.start + k) % len(self.views)

    def perturbation(self, n_materials):
        """{"albedo": f32[n, 3], "metallic": f32[n], "roughness": f32[n],
        "light_color": f32[3], "light_position": f32[3]} offsets, each
        uniform within its ``perturb`` amount (drawn once per seed)."""
        p = self.mix["perturb"]
        rng = np.random.default_rng(self._rng.integers(2 ** 63))

        def u(amount, shape):
            return rng.uniform(-amount, amount, shape).astype(np.float32)
        return {"albedo": u(p["albedo"], (n_materials, 3)),
                "metallic": u(p["metallic"], (n_materials,)),
                "roughness": u(p["roughness"], (n_materials,)),
                "light_color": u(p["light_color"], (3,)),
                "light_position": u(p["light_position"], (3,))}


def make(mix, seed, scene_position=None):
    """The generator of ``mix`` for ``seed``."""
    if mix["loop"] == "view":
        return ViewTraffic(mix, seed, scene_position)
    if mix["loop"] == "fit":
        return FitTraffic(mix, seed)
    raise ValueError(f"unknown loop {mix['loop']!r}")
