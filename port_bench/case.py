"""A cell's case: the configuration's options with the seed's inflow, and
the mesh specification. Both sides, the program and the reference, get
what this module makes."""

from __future__ import annotations

import copy
import math

import numpy as np


def _set(tree, dotted, value):
    keys = dotted.split(".")
    for k in keys[:-1]:
        tree = tree[k]
    tree[keys[-1]] = value


def aoa_deg(config, seed):
    """The seed's angle of attack, uniform in the configuration's range."""
    lo, hi = config["inflow"]["aoa_deg"]
    return float(np.random.default_rng(int(seed)).uniform(lo, hi))


def options(config, traffic, seed):
    """(solver options, angle of attack in degrees) of one run: the
    configuration's options with the traffic's overrides, the far-field
    and initial velocity turned to the seed's angle of attack, and the drag
    direction along it."""
    opts = copy.deepcopy(config["options"])
    for k, v in traffic.get("options", {}).items():
        opts[k] = copy.deepcopy(v)
    a = aoa_deg(config, seed)
    inflow = config["inflow"]
    c, s = math.cos(math.radians(a)), math.sin(math.radians(a))
    speed = float(inflow["speed"])
    for key in inflow["velocity_keys"]:
        _set(opts, key, [speed * c, speed * s, 0.0])
    _set(opts, inflow["drag"], [c, s, 0.0])
    return opts, a


def mesh_spec(config, size=None):
    """The generator's arguments; ``size`` (n_wrap, n_radial) replaces the
    configuration's cell counts, for the CPU tests only."""
    spec = dict(config["mesh"])
    if size is not None:
        spec["n_wrap"], spec["n_radial"] = int(size[0]), int(size[1])
    return spec
