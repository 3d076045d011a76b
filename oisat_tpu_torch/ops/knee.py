"""Kneedle knee-point detection (concave / increasing / offline), numpy.

Carried over from :func:`oisat_tpu.ops.knee.kneedle_index_np` (that module
imports jax, so it is not shared).  The OI pulls its 99-point curve to the
host once and picks the knee here; the JAX package's jitted state machine
``kneedle_index`` has no counterpart in the port.

Algorithm (Satopaa et al. 2011, as ``kneed.KneeLocator`` with S=1):
  1. min-max normalize x and y,
  2. difference curve  d = y_n - x_n,
  3. local extrema of d with clipped-boundary >=/<= comparisons,
  4. per-maximum threshold  T = d[max] - S * mean(|diff(x_n)|),
  5. walk the curve from the first maximum; at each local max reset the
     threshold, at each local min reset it to 0; the first time the *next*
     point drops below the current threshold, the knee is the most recent
     local maximum.  Stop at x_n == 1.
"""

from __future__ import annotations

import numpy as np

__all__ = ["kneedle_index_np"]


def _extrema_masks_np(d: np.ndarray):
    left = np.concatenate([d[:1], d[:-1]])
    right = np.concatenate([d[1:], d[-1:]])
    is_max = (d >= left) & (d >= right)
    is_min = (d <= left) & (d <= right)
    return is_max, is_min


def kneedle_index_np(x: np.ndarray, y: np.ndarray, S: float = 1.0, fallback: int = 0) -> int:
    """Index into ``x`` of the knee of ``(x, y)``, or ``fallback`` when there
    is none (NaN curve, flat curve, no local maximum)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.size
    if n < 2 or not np.all(np.isfinite(y)):
        return fallback  # e.g. an all-NaN analysis domain: reference falls back to 0
    if y.max() == y.min():
        return fallback  # flat curve: no knee
    x_n = (x - x.min()) / (x.max() - x.min())
    y_n = (y - y.min()) / (y.max() - y.min())
    d = y_n - x_n
    is_max, is_min = _extrema_masks_np(d)
    if not is_max.any():
        return fallback
    t_offset = S * np.abs(np.diff(x_n).mean())
    first_max = int(np.argmax(is_max))
    threshold = 0.0
    threshold_index = fallback
    for i in range(first_max, n):
        if x_n[i] == 1.0:
            break
        if is_max[i]:
            threshold = d[i] - t_offset
            threshold_index = i
        if is_min[i]:
            threshold = 0.0
        if i + 1 >= n:  # unsorted x can skip the x_n == 1 stop
            break
        if d[i + 1] < threshold:
            return threshold_index
    return fallback
