"""Ordered-statistics decoding helpers shared by the device OSD and the
BPOSD decoder: method names, the order cap and the signed channel cost."""
from __future__ import annotations

import numpy as np

__all__ = ["OSD_CS_MAX_ORDER", "METHODS", "DEVICE_METHODS"]

#: reprocessing methods by name -> 0 (OSD-0), 1 (OSD-E), 2 (OSD-CS)
METHODS = {"osd_0": 0, "osd0": 0, "osd_e": 1, "osd_cs": 2, "exhaustive": 1}
#: the methods this port runs on the device
DEVICE_METHODS = ("osd_e", "osd0", "osd_0", "exhaustive", "osd_cs")

#: Shared order cap for the reprocessing stages — OSD-E's candidate count is
#: 2^order and OSD-CS's pair block is order^2/2, so an uncapped order is a
#: resource bug, not a knob; entry points raise above it instead of silently
#: clamping.
OSD_CS_MAX_ORDER = 20


def _check_osd_order(osd_order: int) -> int:
    order = int(osd_order)
    if order > OSD_CS_MAX_ORDER:
        raise ValueError(
            f"osd_order={order} exceeds OSD_CS_MAX_ORDER={OSD_CS_MAX_ORDER} — "
            f"candidate counts grow as 2^order (OSD-E) / order^2 (OSD-CS); "
            f"raise OSD_CS_MAX_ORDER deliberately rather than relying on a "
            f"silent clamp")
    return order


def _channel_cost(channel_probs) -> np.ndarray:
    """Signed per-bit cost log((1-p)/p) of setting a bit in the candidate.

    Kept signed: a channel prior > 1/2 makes setting that bit cheaper than
    leaving it clear, which a clamp-to-positive would silently invert.  Only
    the p->0/1 endpoints are clipped for finiteness."""
    p = np.clip(np.asarray(channel_probs, dtype=np.float64), 1e-12, 1 - 1e-7)
    return np.log((1 - p) / p)
