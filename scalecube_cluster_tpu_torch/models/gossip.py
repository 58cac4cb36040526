"""Gossip piggyback occupancy, the health registry's gossip gauge.

Counterpart of ``piggyback_occupancy`` in
``scalecube_cluster_tpu/models/gossip.py``.  The reference module is
also a gossip-only simulator (``gossip_tick``, ``run``,
``dissemination_rounds``), a separate model with its own draws; it is
not ported (ROADMAP).
"""

from __future__ import annotations

import torch


def piggyback_occupancy(hot_count, capacity):
    """The share of live tracked records still inside their
    retransmission window: ``hot_count`` (records the send path would
    piggyback) over ``capacity`` (live members x tracked subjects, at
    least 1).  Near 0 in the steady state, near 1 when membership churns
    faster than the spread windows drain.  float32, as the reference
    computes it: int32 totals cast, then one division."""
    cap = torch.clamp(torch.as_tensor(capacity).to(torch.float32), min=1.0)
    return torch.as_tensor(hot_count).to(torch.float32) / cap
