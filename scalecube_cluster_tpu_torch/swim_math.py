"""Closed-form SWIM/gossip round budgets (the reference's ``ClusterMath``).

Counterpart of ``scalecube_cluster_tpu/swim_math.py`` for the functions
the round schedule needs, as plain Python on ints
(cluster/src/main/java/io/scalecube/cluster/ClusterMath.java:99-135),
and :func:`ceil_log2_tensor` for int32 tensors.
"""

from __future__ import annotations

import torch


def ceil_log2(num: int) -> int:
    """``32 - numberOfLeadingZeros(num)`` == ``ceil(log2(num + 1))``
    (ClusterMath.java:133-135): 0->0, 1->1, 2->2, 3->2, 4->3, 1000->10."""
    if num < 0:
        raise ValueError("num must be non-negative")
    return int(num).bit_length()


def ceil_log2_tensor(num: torch.Tensor) -> torch.Tensor:
    """:func:`ceil_log2` of every element of an int32 tensor >= 0, as
    int32 (the reference's ``ceil_log2_jnp``, ``32 - clz(num)``): the
    count of powers 2^0 .. 2^30 at or below the value, one compare
    each, exact for every int32 >= 0 and with no host sync."""
    num = num.to(torch.int32)
    powers = torch.bitwise_left_shift(
        torch.ones(31, dtype=torch.int32, device=num.device),
        torch.arange(31, dtype=torch.int32, device=num.device))
    return (num[..., None] >= powers).sum(dim=-1, dtype=torch.int32)


def gossip_periods_to_spread(repeat_mult: int, cluster_size: int) -> int:
    """Periods a node retransmits a gossip (ClusterMath.java:111-113)."""
    return repeat_mult * ceil_log2(cluster_size)


def gossip_periods_to_sweep(repeat_mult: int, cluster_size: int) -> int:
    """Periods after which a gossip is garbage-collected
    (ClusterMath.java:99-103)."""
    return 2 * (gossip_periods_to_spread(repeat_mult, cluster_size) + 1)


def suspicion_timeout(suspicion_mult: int, cluster_size: int,
                      ping_interval_ms: int) -> int:
    """``suspicionMult * ceilLog2(n) * pingInterval`` in ms
    (ClusterMath.java:123-125)."""
    return suspicion_mult * ceil_log2(cluster_size) * ping_interval_ms
