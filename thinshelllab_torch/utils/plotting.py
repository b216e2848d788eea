"""Reward-curve PNG artifacts (counterpart of
`thinshelllab_tpu/utils/plotting.py`): the reference's training drivers
save a matplotlib `plot.png` of the reward history every iteration beside
`plot_data.npy` (e.g. trajopt_folding.py:141-142, run_cmaes_all.py:184).

With matplotlib the figure is the JAX package's. A machine without it (the
card's image has none) gets a plain line chart of the same history,
drawn here with numpy and written by the port's PNG writer
(`render/raster.py`), so the drivers write `plot.png` wherever they run.
"""
from __future__ import annotations

import os

import numpy as np

from ..render.raster import write_png

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
except ImportError:
    plt = None

# the plain chart: size, frame margin (pixels), curve colour (matplotlib's
# default blue)
_W, _H, _MARGIN = 640, 480, 48
_BLUE = (31, 119, 180)


def save_reward_curve(path: str, history, ylabel: str = "reward"):
    y = np.asarray(history, dtype=float)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if plt is None:
        write_png(path, _line_chart(y))
        return path
    fig, ax = plt.subplots()
    ax.plot(np.arange(len(y)), y)
    ax.set_xlabel("iteration")
    ax.set_ylabel(ylabel)
    fig.savefig(path)
    plt.close(fig)
    return path


def _line_chart(y):
    """(H, W, 3) uint8: a black frame and the finite points of y joined
    by straight segments, scaled to fill the frame."""
    img = np.full((_H, _W, 3), 255, np.uint8)
    lo_x, hi_x, lo_y, hi_y = _MARGIN, _W - _MARGIN, _MARGIN, _H - _MARGIN
    img[[lo_y, hi_y], lo_x:hi_x + 1] = 0
    img[lo_y:hi_y + 1, [lo_x, hi_x]] = 0
    ok = np.isfinite(y)
    if not ok.any():
        return img
    lo, hi = y[ok].min(), y[ok].max()
    span = hi - lo if hi > lo else 1.0
    xs = lo_x + (hi_x - lo_x) * np.arange(len(y)) / max(len(y) - 1, 1)
    ys = hi_y - (hi_y - lo_y) * (y - lo) / span
    pts = np.stack([xs, ys], axis=1)[ok]
    for (x0, y0), (x1, y1) in zip(pts[:-1], pts[1:]):
        n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
        t = np.linspace(0.0, 1.0, n + 1)
        img[np.rint(y0 + t * (y1 - y0)).astype(int),
            np.rint(x0 + t * (x1 - x0)).astype(int)] = _BLUE
    if len(pts) == 1:
        img[int(round(pts[0, 1])), int(round(pts[0, 0]))] = _BLUE
    return img
