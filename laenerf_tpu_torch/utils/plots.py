"""Loss-curve plotting (counterpart of laenerf_tpu/utils/plots.py):
line plots drawn with numpy into a PNG (no matplotlib)."""

import numpy as np

from .images import write_png


def plot_losses(path, series, width=640, height=360, colors=None):
    """Plot named 1-D series into a PNG, all on one value scale.

    Args:
      series: dict name -> list/array of values.
    Returns:
      path.
    """
    img = np.ones((height, width, 3), np.float32)
    default = [(0.85, 0.3, 0.25), (0.2, 0.5, 0.85), (0.25, 0.7, 0.35),
               (0.8, 0.6, 0.2)]
    colors = colors or default
    all_vals = np.concatenate([np.asarray(v, np.float64)
                               for v in series.values() if len(v)])
    lo, hi = float(all_vals.min()), float(all_vals.max())
    rng = max(hi - lo, 1e-12)

    for k, vals in enumerate(series.values()):
        vals = np.asarray(vals, np.float64)
        if len(vals) < 2:
            continue
        xs = np.linspace(8, width - 8, len(vals)).astype(int)
        ys = (height - 8 - (vals - lo) / rng * (height - 16)).astype(int)
        c = colors[k % len(colors)]
        for i in range(len(vals) - 1):
            x0, x1 = xs[i], xs[i + 1]
            y0, y1 = ys[i], ys[i + 1]
            n = max(abs(x1 - x0), abs(y1 - y0), 1)
            for t in range(n + 1):
                x = x0 + (x1 - x0) * t // n
                y = np.clip(y0 + (y1 - y0) * t // n, 0, height - 1)
                img[y, x] = c
    write_png(path, (img * 255).astype(np.uint8))
    return path
