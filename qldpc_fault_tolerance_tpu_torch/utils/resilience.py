"""Recoverable units of work.

The port's counterpart of the JAX package's ``utils/resilience.py``, less
what makes it resilient: ``run_cell`` runs one sweep cell once and lets any
error rise.  The retry policy (transient faults retried with backoff), the
watchdog around host reads, the device reset and the degradation ladder
wait for ROADMAP queue A item 10.
"""
from __future__ import annotations

__all__ = ["run_cell"]


def run_cell(fn, *, label: str = ""):
    """Run one unit of work (a sweep cell) once and return its result;
    ``label`` names it, as the JAX package's retry policy does."""
    del label
    return fn()
