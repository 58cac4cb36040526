"""Closed-form SWIM/gossip model (the reference's ``ClusterMath``).

Counterpart of ``scalecube_cluster_tpu/swim_math.py``, every function as
plain Python on ints and floats
(cluster/src/main/java/io/scalecube/cluster/ClusterMath.java:8-136):
the round budgets the schedule needs, the gossip convergence, message
and time model the gossip simulator is held against, and the failure
detector's false-suspicion model; :func:`ceil_log2_tensor` for int32
tensors.
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


def gossip_convergence_probability(fanout: int, repeat_mult: int,
                                   cluster_size: int, loss: float) -> float:
    """P(a gossip reaches everyone), ``loss`` a probability in [0, 1]
    (ClusterMath.java:38-43)."""
    fanout_with_loss = (1.0 - loss) * fanout
    spread_size = cluster_size - cluster_size ** -(
        fanout_with_loss * repeat_mult - 2)
    return spread_size / cluster_size


def gossip_convergence_percent(fanout: int, repeat_mult: int,
                               cluster_size: int,
                               loss_percent: float) -> float:
    """:func:`gossip_convergence_probability` in percent, the loss in
    percent too (ClusterMath.java:23-28)."""
    return gossip_convergence_probability(
        fanout, repeat_mult, cluster_size, loss_percent / 100.0) * 100.0


def max_messages_per_gossip_per_node(fanout: int, repeat_mult: int,
                                     cluster_size: int) -> int:
    """``fanout * repeatMult * ceilLog2(n)`` (ClusterMath.java:65-67)."""
    return fanout * repeat_mult * ceil_log2(cluster_size)


def max_messages_per_gossip_total(fanout: int, repeat_mult: int,
                                  cluster_size: int) -> int:
    """``n`` x :func:`max_messages_per_gossip_per_node`
    (ClusterMath.java:53-55)."""
    return cluster_size * max_messages_per_gossip_per_node(
        fanout, repeat_mult, cluster_size)


def gossip_periods_to_spread(repeat_mult: int, cluster_size: int) -> int:
    """Periods a node retransmits a gossip (ClusterMath.java:111-113)."""
    return repeat_mult * ceil_log2(cluster_size)


def gossip_periods_to_sweep(repeat_mult: int, cluster_size: int) -> int:
    """Periods after which a gossip is garbage-collected
    (ClusterMath.java:99-103)."""
    return 2 * (gossip_periods_to_spread(repeat_mult, cluster_size) + 1)


def gossip_dissemination_time(repeat_mult: int, cluster_size: int,
                              gossip_interval_ms: int) -> int:
    """Spread periods x interval, in ms (ClusterMath.java:77-79)."""
    return gossip_periods_to_spread(repeat_mult, cluster_size) \
        * gossip_interval_ms


def gossip_timeout_to_sweep(repeat_mult: int, cluster_size: int,
                            gossip_interval_ms: int) -> int:
    """Sweep periods x interval, in ms (ClusterMath.java:86-90)."""
    return gossip_periods_to_sweep(repeat_mult, cluster_size) \
        * gossip_interval_ms


def suspicion_timeout(suspicion_mult: int, cluster_size: int,
                      ping_interval_ms: int) -> int:
    """``suspicionMult * ceilLog2(n) * pingInterval`` in ms
    (ClusterMath.java:123-125)."""
    return suspicion_mult * ceil_log2(cluster_size) * ping_interval_ms


def fd_false_suspect_probability(loss: float, ping_req_members: int,
                                 cluster_size: int) -> float:
    """P(one probe of a live member ends SUSPECT) under symmetric i.i.d.
    per-message loss ``p``: the 2-hop direct chain drops and each of the
    ``ping_req_members`` 4-hop proxy chains drops or drew the target as
    its proxy (probability ``1/(n-1)``, a proxy cannot rescue its own
    probe):

      P = (1 - (1-p)^2) * (1 - (1 - 1/(n-1)) * (1-p)^4) ^ R

    The round collapses each chain to one Bernoulli against the product
    of its hops' delivery probabilities, which is what makes this exact
    for the model (the reference's extension of ``ClusterMath``)."""
    p = float(loss)
    n = cluster_size
    direct_fail = 1.0 - (1.0 - p) ** 2
    proxy_rescue = (1.0 - 1.0 / (n - 1)) * (1.0 - p) ** 4
    return direct_fail * (1.0 - proxy_rescue) ** ping_req_members


def fd_expected_false_onsets(loss: float, ping_req_members: int,
                             cluster_size: int, fd_rounds: int) -> float:
    """Expected first false suspicions of an FD-only run (warm full view,
    everyone live, nothing refuted or removed): each of the n(n-1)
    entries is probed with probability 1/(n-1) an FD round and turns
    SUSPECT once,

      E = n (n-1) (1 - (1 - P_fs / (n-1)) ^ fd_rounds)."""
    n = cluster_size
    q = fd_false_suspect_probability(loss, ping_req_members, n) / (n - 1)
    return n * (n - 1) * (1.0 - (1.0 - q) ** fd_rounds)
