"""The comparison that decides ``correct``: what the timed path produced
against the plain reference, each number beside its limit.

The reference package.  A configuration names its plain reference by its
``reference`` key: a package directory of the benchmark's folder
(``reference``, the default, without the key), found under the checkout
the cell was loaded from.  It imports nothing of the port and nothing of
the benchmark outside reference packages.  The check takes from it only
what its entry module (``<package>/entry.py``, cells.reference_package)
exports; reference/entry.py lists it: a view cell's frame (``leaves``,
``adopt``, ``frame``), a fit cell's ``train``, the ProbeSettings of
``config``, the builders of ``examples(module)``, the light types of
``lights`` and the tally of ``march``.  A new package's entry imports
the default's and defines again what differs.  The check keeps the rest:
the chain, the seeded pixels, the bfloat16 control, the tally's
bookkeeping and the judge.  It imports the package only after the
window, so that the reference's import counts in no run's set-up.

View cells.  The frame is a function of the scene, the pose and the probe
feedback state it reads.  The reference builds the scene itself from the
configuration and applies each frame's pose and edit.  It follows the
program's chain from its own zero state over the first CHAIN frames (the
set-up frames and the window's first frames), each from its own state
before it; and it runs each further checked frame of the window (frames
drawn from the seed, a traced run's last traced frame, the last frame)
from the program's state before that frame (the state chains over
hundreds of frames, which the reference cannot replay in the time of a
run).  Numbers: ``image``, the mean absolute gap of the tonemapped colour
over a seeded sample of the frame's pixels; ``image_wrong``, the share of
those pixels with a channel off by more than WRONG; and under each state
leaf's name (``radiance`` and ``irradiance``, the probe atlases, and
``scattering`` where the package's frame leaves one) the relative L1 gap
of the leaf the frame left; each the worst over the checked frames.  A
state leaf that the package's ``leaves`` names must have a limit, and a
leaf of the program's state that it does not name must stay at the
reference's zero state: either fault raises, so that no state goes
unchecked.

Fit cells.  The reference follows the program's first three steps from
its own scene data and zero state, with the same cameras and targets.
Numbers: ``loss``, the worst relative gap of a step's loss; ``grad``, the
worst leaf's gap between the norms of the first gradient (each side's
worked out from its update, (p0 − p1) / lr) against the larger of the
reference leaf's norm and the median leaf's; ``change``, the same of the
parameters' change after three steps, over the leaves whose reference
gradient is at least a thousandth of the median leaf's; ``state``, the
worst relative L1 gap of the state leaves (``entry.leaves``) after three
steps.  It then runs one step of the window, drawn from the seed, from
the program's parameters and state before it: ``window_loss``,
``window_change`` (the step's change, as ``change``) and
``window_state`` (the state leaves after it).

The control puts the reference in the program's place, computed with its
inputs (scene data, camera, state, target) and every pass's output (the
atlases, the colour, the loss and gradients) held in bfloat16.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark.cells import build_scene, reference_package

PIXELS = 32768
# A sampled pixel is wrong where a channel of its tonemapped colour is off
# by more than this (4 steps of an 8-bit display).
WRONG = 4 / 255
STEPS = 3
LEAF_RULE = 1e-3


def _bf(x):
    """x rounded to bfloat16 and back (non-float tensors unchanged)."""
    if torch.is_tensor(x) and x.is_floating_point():
        return x.to(torch.bfloat16).to(x.dtype)
    return x


def _same(x):
    return x


def reference_renderer(config, root, device, width=None, height=None):
    """The configuration's renderer, built by its reference package."""
    ref = reference_package(config, root)
    return build_scene(ref.examples, ref.config.ProbeSettings, config, root,
                       device, width, height)


def state_leaves(state):
    """{name: tensor} of a state's leaves: its dataclass fields that hold
    a tensor (a field that holds None is no leaf)."""
    return {f.name: getattr(state, f.name)
            for f in dataclasses.fields(state)
            if torch.is_tensor(getattr(state, f.name))}


def rel_l1(a, b):
    """sum |a − b| / sum |b|."""
    return float((a - b).abs().sum() / b.abs().sum().clamp_min(1e-30))


def pixel_sample(seed, k, n_pixels, n=PIXELS):
    """A seeded sample of n pixel indices (all when the frame has fewer)."""
    if n >= n_pixels:
        return np.arange(n_pixels)
    return np.random.default_rng([seed % 2 ** 63, k % 2 ** 32]).choice(
        n_pixels, n, replace=False)


# The state a chained frame reads: the one the frame before it left (on
# the reference's side, the reference's own).
CHAIN = "chain"
# The key of the pixel sample the chained frames are compared on.
CHAIN_KEY = -(2 ** 20)


@dataclasses.dataclass
class Frame:
    """A frame the program rendered: its index (negative: set-up), pose,
    edit, the state it read (None: the zero state; CHAIN: the frame
    before's), its image f32[H, W, 3] or, with ``pixels`` (flat indices),
    its colours f32[n, 3] at those pixels, and the state it left."""

    k: int
    pose: tuple
    edit: object
    state_in: object
    image: torch.Tensor
    state_out: object
    pixels: object = None


class ViewReference:
    """The reference's frames of one configuration on ``device``, by the
    configuration's reference package."""

    def __init__(self, config, root, device):
        self.entry = reference_package(config, root)
        self.rr = reference_renderer(config, root, device)
        self.leaves = tuple(self.entry.leaves(config))
        self.zero = state_leaves(self.entry.adopt(self.rr, None))
        self.tally = []

    def frame(self, pose, edit, state, pixels, control=False,
              count=None):
        """(colour f32[n, 3] of the tonemapped image at the flat pixel
        indices, the state left) of a frame from ``state`` (None: the
        reference's zero state); with ``count`` (the frame's index) the
        geometry launches' work is appended to ``self.tally`` (the screen
        launch's counted on the sampled pixels).  Raises where the state
        left holds other leaves than the package's ``leaves``."""
        rr = self.rr
        rr.set_camera_position(pose[0])
        rr.set_camera_orientation(pose[1])
        if edit is not None:
            name, index, fields = edit
            rr.set_light(getattr(self.entry.lights, name), index, **fields)
        q = _bf if control else _same
        geometry = self.entry.march.geometry
        geometry.tally = [] if count is not None else None
        try:
            c, state = self.entry.frame(rr, rr.scene_data, rr.camera,
                                        state, pixels, q)
            if count is not None:
                radiance_t, screen_t = geometry.tally
                self.tally.append({
                    "k": count,
                    "radiance": dict(radiance_t),
                    "screen": dict(screen_t),
                    "screen_rays": rr.width * rr.height})
        finally:
            geometry.tally = None
        left = sorted(state_leaves(state))
        if left != sorted(self.leaves):
            raise RuntimeError(f"the reference frame left the state leaves "
                               f"{left}; its package names "
                               f"{sorted(self.leaves)}")
        return c, state


def require_limits(leaves, limits):
    """Raises ValueError where a state leaf of ``leaves`` (a
    ViewReference's) has no limit in a cell's ``limits``."""
    unnamed = [leaf for leaf in leaves if leaf not in limits]
    if unnamed:
        raise ValueError(f"the state leaves {unnamed} that the reference "
                         f"package's frame leaves have no limit in the "
                         f"cell's limits file")


def _unchecked(ref, state, dev):
    """Raises where the program's ``state`` holds a leaf that the
    reference package does not name and that is not the reference's zero
    state (a leaf the package would leave unchecked)."""
    for leaf, x in state_leaves(state).items():
        if leaf in ref.leaves:
            continue
        zero = ref.zero.get(leaf)
        if zero is None or not torch.equal(x.to(dev), zero):
            raise ValueError(f"the program's state leaf {leaf!r} moved from "
                             f"the zero state and the reference package "
                             f"does not compare it (its leaves: "
                             f"{list(ref.leaves)})")


def view_readings(ref, frames, seed, control=False, count=False):
    """{number: worst reading over ``frames``} of the program's frames
    (or, with ``control``, of the control's frames from the same inputs)
    against the reference; with ``count`` the work of the window frames'
    (k >= 0) geometry launches is tallied in ``ref.tally``.  A frame whose
    ``state_in`` is CHAIN reads, on each side, the state that side's frame
    before it left.  Each of the reference's state leaves is compared with
    the program's (or the control's) leaf of its name; a leaf of the
    program's state that the reference does not name raises unless it
    equals the reference's zero state."""
    worst = {"image": 0.0, "image_wrong": 0.0,
             **{leaf: 0.0 for leaf in ref.leaves}}
    ref_state = ctl_state = None
    for f in frames:
        if f.pixels is None:
            h, w = f.image.shape[:2]
            pixels = pixel_sample(seed, f.k, h * w)
        else:
            pixels = f.pixels
        chained = isinstance(f.state_in, str) and f.state_in == CHAIN
        c_ref, ref_state = ref.frame(
            f.pose, f.edit, ref_state if chained else f.state_in, pixels,
            count=f.k if count and f.k >= 0 else None)
        want = state_leaves(ref_state)
        dev = c_ref.device
        if control:
            c, ctl_state = ref.frame(f.pose, f.edit,
                                     ctl_state if chained else f.state_in,
                                     pixels, control=True)
            got = state_leaves(ctl_state)
        else:
            if f.pixels is None:
                c = f.image.reshape(-1, 3)[torch.as_tensor(
                    pixels, device=f.image.device)]
            else:
                c = f.image
            c = c.to(dev)
            _unchecked(ref, f.state_out, dev)
            got = {leaf: getattr(f.state_out, leaf).to(dev)
                   for leaf in want}
        gap = (c - c_ref).abs()
        read = {"image": float(gap.mean()),
                "image_wrong": float((gap.amax(dim=1) > WRONG).float()
                                     .mean()),
                **{leaf: rel_l1(got[leaf], want[leaf]) for leaf in want}}
        for key, v in read.items():
            worst[key] = v if math.isnan(v) else max(worst[key], v)
    return worst


def make_targets(config, root, device, traffic):
    """The fit cell's target images f32[H, W, 3], one per view: the
    reference package renders the scene with the seeded perturbation of
    its materials and light (train.render_targets: one radiance pass from
    the zero state, then the screen pass of each view)."""
    w, h = traffic.resolution
    rr = reference_renderer(config, root, device, w, h)
    b = rr.builder
    n_mat = b._material_count
    pert = traffic.perturbation(n_mat)
    for i in range(n_mat):
        rr.set_material(
            i, np.clip(b._albedo[i] + pert["albedo"][i], 0.0, 1.0),
            float(np.clip(b._metallic[i] + pert["metallic"][i], 0.0, 1.0)),
            float(np.clip(b._roughness[i] + pert["roughness"][i], 0.05,
                          1.0)))
    for ltype, _ in rr.spec.lights:
        store = b._lights[ltype.name]
        for idx in range(int(b._light_counts[ltype.name])):
            fields = {}
            if "color" in store:
                fields["color"] = np.clip(
                    store["color"][idx] * (1.0 + pert["light_color"]), 0.0,
                    None)
            if "position" in store:
                fields["position"] = store["position"][idx] \
                    + pert["light_position"]
            rr.set_light(ltype, idx, **fields)
    return reference_package(config, root).train.render_targets(
        rr, traffic.views)


class FitReference:
    """The reference's train steps of one configuration and fit mix on
    ``device`` (with ``control``, in bfloat16; with ``half_batch``, the
    planted fault of a loss over the image's first half of rows), by the
    configuration's reference package."""

    def __init__(self, config, root, device, traffic, targets,
                 control=False, half_batch=False):
        entry = reference_package(config, root)
        train = entry.train
        w, h = traffic.resolution
        rr = reference_renderer(config, root, device, w, h)
        self.vg = train.make_value_and_grad(
            rr.spec, rr.probes, rr.volumetrics, w, h, rr.screen_cfg,
            rr.probe_cfg, rows=h // 2 if half_batch else None)
        self.q = q = _bf if control else _same
        self.cams = []
        for position, orientation in traffic.views:
            rr.set_camera_position(position)
            rr.set_camera_orientation(orientation)
            c = rr.camera
            self.cams.append(dataclasses.replace(
                c, position=q(c.position), orientation=q(c.orientation)))
        self.rr, self.train, self.tree_map = rr, train, train.tree_map
        self.entry = entry
        self.leaves = tuple(entry.leaves(config))
        self.traffic, self.targets = traffic, targets
        self.device = rr.device

    def step(self, k, data, state):
        """(loss, gradient per float leaf, new data, new state) of step k
        from ``data`` and ``state``."""
        q, train = self.q, self.train
        v = self.traffic.view(k)
        loss, grads, state = self.vg(data, self.cams[v], state,
                                     q(self.targets[v].to(self.device)))
        loss, grads = q(loss), [q(g) for g in grads]
        state = self.tree_map(q, state)
        floats, aux = train.split_float_leaves(data)
        data = train.merge_float_leaves(
            aux, [q(p) for p in train.sgd_update(floats, grads,
                                                 self.traffic.lr)])
        return float(loss), grads, data, state

    def first_steps(self):
        """The first STEPS steps from the reference's own scene data and
        zero state: {"losses", "grad" (first step's, per float leaf),
        "floats0", "floats1" (after the first step), "floats" (after the
        steps), "state"}."""
        data = self.tree_map(self.q, self.rr.scene_data)
        state = self.tree_map(self.q, self.rr.state)
        floats0 = [x.clone()
                   for x in self.train.split_float_leaves(data)[0]]
        losses, grad = [], None
        for k in range(STEPS):
            loss, grads, data, state = self.step(k, data, state)
            if grad is None:
                grad = grads
                floats1 = self.train.split_float_leaves(data)[0]
            losses.append(loss)
        return {"losses": losses, "grad": grad, "floats0": floats0,
                "floats1": floats1,
                "floats": self.train.split_float_leaves(data)[0],
                "state": state}

    def window_step(self, k, floats, state):
        """Step k from the program's float leaves and state before it:
        {"loss", "grad", "floats0", "floats", "state"}."""
        q, dev = self.q, self.device
        aux = self.train.split_float_leaves(self.rr.scene_data)[1]
        floats0 = [q(x.to(dev)) for x in floats]
        data = self.train.merge_float_leaves(aux, floats0)
        state = self.tree_map(q, self.entry.adopt(self.rr, state))
        loss, grads, data, state = self.step(k, data, state)
        return {"loss": loss, "grad": grads, "floats0": floats0,
                "floats": self.train.split_float_leaves(data)[0],
                "state": state}


def _norms(leaves):
    return [float(torch.linalg.vector_norm(x.double())) for x in leaves]


def leaf_gap(got, ref, keep=None):
    """The worst leaf's |‖got‖ − ‖ref‖| / max(‖ref‖, the median leaf's
    ‖ref‖), over the leaves ``keep`` marks (all by default)."""
    g, r = _norms(got), _norms(ref)
    med = float(np.median(r)) if r else 0.0
    worst = 0.0
    for i, (gn, rn) in enumerate(zip(g, r)):
        if keep is not None and not keep[i]:
            continue
        scale = max(rn, med)
        if scale == 0.0:
            gap = 0.0 if gn == 0.0 else math.inf
        else:
            gap = abs(gn - rn) / scale
        if math.isnan(gap):
            return gap
        worst = max(worst, gap)
    return worst


def _keep(grad):
    """Which leaves count for a change: those whose reference gradient is
    at least LEAF_RULE of the median leaf's."""
    g_norms = _norms(grad)
    med = float(np.median(g_norms)) if g_norms else 0.0
    return [n >= LEAF_RULE * med for n in g_norms]


def _state_gap(got, ref, leaves):
    """The worst relative L1 gap of the named state leaves."""
    return max(rel_l1(getattr(got, leaf).to(getattr(ref, leaf).device),
                      getattr(ref, leaf)) for leaf in leaves)


def fit_readings(ref, got, lr, ref_w=None, got_w=None, *, leaves):
    """{number: reading} of the first steps ``got`` (the program's, or the
    control's; {"losses", "floats0", "floats1", "floats", "state"})
    against the reference's ``ref`` (FitReference.first_steps'), and of
    the window step ``got_w`` ({"loss", "floats0", "floats", "state"})
    against ``ref_w`` (FitReference.window_step's) where given; the
    states on the named ``leaves`` (FitReference.leaves).  The first
    gradient is worked out from each side's update, (p0 − p1) / lr,
    so that both carry the same rounding."""
    def worked(side):
        return [(p0 - p1) / lr for p0, p1 in
                zip(side["floats0"], side["floats1"])]

    def change(side):
        return [p.to(p0.device) - p0
                for p, p0 in zip(side["floats"], side["floats0"])]

    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(got["losses"], ref["losses"]))
    out = {"loss": loss, "grad": leaf_gap(worked(got), worked(ref)),
           "change": leaf_gap(change(got), change(ref), _keep(ref["grad"])),
           "state": _state_gap(got["state"], ref["state"], leaves)}
    if ref_w is not None:
        out["window_loss"] = abs(got_w["loss"] - ref_w["loss"]) / max(
            abs(ref_w["loss"]), 1e-30)
        out["window_change"] = leaf_gap(
            [x.to(ref_w["floats0"][0].device) for x in change(got_w)],
            change(ref_w), _keep(ref_w["grad"]))
        out["window_state"] = _state_gap(got_w["state"], ref_w["state"],
                                         leaves)
    return out


def judge(readings, limits):
    """(correct, [(number, reading, limit)]) over the numbers ``limits``
    names (a cell's limits file says which it compares): every one read,
    finite and at most its limit.  A number that is named but not read is
    not correct."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = readings.get(name, math.nan)
        rows.append((name, value, limit))
        if not math.isfinite(value) or value > limit:
            ok = False
    return ok, rows
