"""Arithmetic the readers share."""

from __future__ import annotations

from typing import Optional


def idle_share(r) -> Optional[float]:
    """% of the traced window in which no operation ran on the device."""
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)


def share(need_s: float, took_s: float) -> Optional[float]:
    """% that `need_s`, the least time the work needs, is of `took_s`."""
    if need_s <= 0 or took_s <= 0:
        return None
    return 100.0 * need_s / took_s
