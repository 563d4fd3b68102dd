"""``idle_pct.requests`` in the recordings cell, apart so that it moves that
cell's own throughput metric."""

from benchmark.harness import reader

read = reader("idle_pct.requests").read
