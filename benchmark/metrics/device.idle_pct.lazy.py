"""device.idle_pct.lazy: device.idle_pct (device.idle_pct.py) in the lazy
cell, where it moves that cell's latency_p95_ms.lazy."""

from benchmark.spec import reader

read = reader("device.idle_pct").read
