"""Small statistics of the window."""

import numpy as np


def p90(values):
    """The 90th percentile (linear interpolation), or None without values."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), 90)) if values else None
