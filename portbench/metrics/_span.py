"""Device time and launches under the program's spans, per request
(`infer.request`) or per optimizer step (`train.step`) of the traced
window (`devtrace.Summary.by_span`).  Both count a span's own work and
that of every span opened inside it, so a span nested inside another
later does not lower the outer one's number."""

from __future__ import annotations

from typing import Optional

REQUEST = "infer.request"
STEP = "train.step"


def _per_unit(r, unit: str, spans, key: str) -> Optional[float]:
    if r.trace is None:
        return None
    n = r.trace.by_span.get(unit, {}).get("count", 0)
    total = sum(r.trace.by_span.get(s, {}).get(key, 0) for s in spans)
    return total / n if n and total else None


def device_ms(r, unit: str, spans) -> Optional[float]:
    """Device ms per `unit` under `spans` (none of them inside another);
    None where the window holds no `unit` or the spans no device time."""
    v = _per_unit(r, unit, spans, "device_incl_s")
    return None if v is None else 1e3 * v


def launches(r, unit: str, spans) -> Optional[float]:
    """Device operations launched per `unit` under `spans` (none of them
    inside another)."""
    return _per_unit(r, unit, spans, "launches_incl")
