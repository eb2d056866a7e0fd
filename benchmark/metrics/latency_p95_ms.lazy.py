"""latency_p95_ms.lazy: latency_p95_ms (latency_p95_ms.py) in the lazy
cell, under a bound of its own."""

from benchmark.spec import reader

read = reader("latency_p95_ms").read
