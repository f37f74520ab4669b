"""Plotting geometry, in numpy.  Nothing here imports matplotlib: the
functions that draw (``experiments/figure_2.draw_posteriors``) import it
themselves, so every module imports where matplotlib is missing.  The JAX
package's drawing helpers come with the figures that use them (ROADMAP.md
queue 1 item 11)."""

from __future__ import annotations

import numpy as np


def proba_to_coordinate(probs: np.ndarray):
    """Map class probabilities onto the 10-class polar simplex: returns
    ``((x, y), (class_x, class_y))``."""
    probs = np.atleast_2d(np.asarray(probs))
    class_polar = np.arange(0.0, 10.0) * 2 * np.pi / 10
    class_x = np.cos(class_polar).reshape((1, -1))
    class_y = np.sin(class_polar).reshape((1, -1))
    x = (probs * class_x).sum(1)
    y = (probs * class_y).sum(1)
    return (x, y), (class_x.squeeze(), class_y.squeeze())
