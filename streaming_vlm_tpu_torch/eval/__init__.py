"""Evaluation harnesses of the port: `soak` (constant KV occupancy and flat
latency over a long stream) and `efficiency` (the paper's four attention
policies). Ports of the JAX package's eval/soak.py and eval/efficiency.py."""

from . import efficiency, soak  # noqa: F401
