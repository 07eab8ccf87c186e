"""Per-layer readers: `<metric>.py` holds `read(readings) -> float | None`
for the metric of that name in BENCHMARK.json (`drivers.Readings`).  A
reader that finds nothing to read returns None, and the run leaves the
metric out."""
