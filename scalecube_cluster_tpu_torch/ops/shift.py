"""Cyclic-shift message delivery.

Counterpart of ``scalecube_cluster_tpu/ops/shift.py`` on one device.
Each send channel uses one random shift ``s`` per round: channel ``c``
delivers sender ``i``'s row to receiver ``(i + s_c) mod N``.  The shifts
are host ints, so a shifted view is a slice of the doubled buffer — no
gather and no device sync.
"""

from __future__ import annotations

import torch


def doubled(x: torch.Tensor) -> torch.Tensor:
    """``x`` concatenated with itself along dim 0 (the lookup buffer)."""
    return torch.cat([x, x], dim=0)


def deliver(doubled_x: torch.Tensor, shift: int, n: int) -> torch.Tensor:
    """Receiver view of a send-by-shift: row ``j`` = sender
    ``(j - shift) % n``; ``shift`` is a host int in [0, n)."""
    start = n - int(shift)
    return doubled_x[start:start + n]


def look(doubled_x: torch.Tensor, shift: int, n: int) -> torch.Tensor:
    """Sender view of its target's attribute: row ``i`` =
    ``x[(i + shift) % n]``."""
    start = int(shift)
    return doubled_x[start:start + n]


class ShiftEngine:
    """Single-device global-cyclic-shift delivery.

    World vectors and payloads are doubled once per round and sliced per
    channel; every view is a contiguous slice of the doubled buffer.
    """

    def __init__(self, n: int):
        self.n = n

    def prep(self, x: torch.Tensor) -> torch.Tensor:
        return doubled(x)

    def look(self, dx: torch.Tensor, shift: int) -> torch.Tensor:
        return look(dx, shift, self.n)

    def deliver(self, dx: torch.Tensor, shift: int) -> torch.Tensor:
        return deliver(dx, shift, self.n)
