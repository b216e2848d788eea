"""Inputs made from --seed, the same for the program and the reference.

Each draw has its own stream of numpy's PCG64, keyed by the seed and the
draw's name, so adding a draw never moves another."""
from __future__ import annotations

import zlib

import numpy as np


def rng(seed: int, what: str):
    return np.random.default_rng([int(seed) % 2**63, zlib.crc32(
        what.encode())])


def cloth_jitter(seed, n_cloth, scale):
    """(n_cloth, 3) offsets of the cloth's initial vertices: N(0, scale)."""
    return scale * rng(seed, "cloth_jitter").normal(size=(n_cloth, 3))


def waypoints(seed, T, n_part, dz_per_step, sigma):
    """The warm-start waypoint table (T, n_part, 6): row t lowered by
    t * dz_per_step, and rows 1.. moved by N(0, sigma) in x, y, z."""
    traj = np.zeros((T, n_part, 6))
    traj[:, :, 2] = dz_per_step * np.arange(T)[:, None]
    traj[1:, :, 0:3] += sigma * rng(seed, "waypoints").normal(
        size=(T - 1, n_part, 3))
    return traj


def sample(seed, n, k):
    """k distinct indices of range(n), drawn from the seed (all if k >= n),
    in rising order."""
    if k >= n:
        return list(range(n))
    return sorted(rng(seed, "sample").choice(n, size=k, replace=False)
                  .tolist())


def cloth_vertices(sc):
    """Vertices of a scene's cloths: they come first in the vertex order."""
    c = sc.spec.cloth
    return int(sum((int(n) + 1) * (int(m) + 1) for n, m in zip(c.N, c.M)))


def jitter(sc, seed, scale):
    """Move a scene's initial cloth vertices (host numpy, before
    TaskScene.to) by cloth_jitter; the program's scene and the reference's
    get the same offsets."""
    if scale:
        n = cloth_vertices(sc)
        pos = np.array(sc.state0.pos, dtype=np.float64)
        pos[:n] += cloth_jitter(seed, n, scale)
        sc.state0 = sc.state0.replace(pos=pos)
    return sc
