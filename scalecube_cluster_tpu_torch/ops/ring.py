"""Delayed-delivery ring primitives.

Counterpart of ``scalecube_cluster_tpu/ops/ring.py``.  The network delays
every message by an exponential draw; on the round-quantized tick a
message's delay becomes a round offset ``floor(delay / round_ms)``,
saturating at the ring depth.  A ring is a ``[D, N, ...]`` buffer: slot
``round % D`` holds the messages due in that round, and reading a
round's slot clears it for reuse.

The reference builds a new ring on every update; here each update works
in place on one slot (``ring[slot]`` is a contiguous view), so a caller
that must keep its input ring clones it first.

Randomness arrives as unit exponentials ``e = -log1p(-u)`` drawn once
behind the ``RoundDraws`` seam (``ops/prng.py``): float32 ``log1p``
differs between XLA, PyTorch's CPU and CUDA by an ulp in a few percent
of draws, so it is never recomputed here.
"""

from __future__ import annotations

import torch


def delay_bins(e: torch.Tensor, mean_ms: torch.Tensor, round_ms: float,
               max_delay_rounds: int) -> torch.Tensor:
    """Round offset per message: ``floor(e * mean / round_ms)`` clamped to
    ``[0, max_delay_rounds]``, int32.

    The reference's order of float32 operations: one product, then a
    true division (by a 0-dim tensor, never a Python number: CUDA turns
    a division by a host scalar into a multiply by its reciprocal)."""
    d_ms = e * mean_ms
    q = torch.floor(d_ms / d_ms.new_full((), round_ms)).to(torch.int32)
    return torch.clamp(q, 0, max_delay_rounds)


def open_slot(ring: torch.Tensor, slot: int, fill_value) -> torch.Tensor:
    """The messages due now (a copy of ``ring[slot]``); the slot is reset
    to ``fill_value`` in place."""
    now = ring[slot].clone()
    ring[slot].fill_(fill_value)
    return now


def push_max(ring: torch.Tensor, slot: int, values: torch.Tensor) -> None:
    """Max-merge ``values`` into ``ring[slot]`` in place (record keys)."""
    torch.maximum(ring[slot], values, out=ring[slot])


def push_or(ring: torch.Tensor, slot: int, values: torch.Tensor) -> None:
    """Or-merge ``values`` into ``ring[slot]`` in place (flag bits)."""
    ring[slot] |= values
