"""Cluster configuration with LAN/WAN/LOCAL presets.

Counterpart of ``scalecube_cluster_tpu/config.py``: the reference's
``ClusterConfig`` (cluster/src/main/java/io/scalecube/cluster/
ClusterConfig.java:24-419) as a frozen dataclass, and ``to_sim``, which
quantizes the millisecond knobs to protocol rounds with the gossip
interval as the base round.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from scalecube_cluster_tpu_torch import swim_math

# Default settings for LAN cluster (ClusterConfig.java:26-36).
DEFAULT_SYNC_GROUP = "default"
DEFAULT_SYNC_INTERVAL = 30_000
DEFAULT_SYNC_TIMEOUT = 3_000
DEFAULT_SUSPICION_MULT = 5
DEFAULT_PING_INTERVAL = 1_000
DEFAULT_PING_TIMEOUT = 500
DEFAULT_PING_REQ_MEMBERS = 3
DEFAULT_GOSSIP_INTERVAL = 200
DEFAULT_GOSSIP_FANOUT = 3
DEFAULT_GOSSIP_REPEAT_MULT = 3
DEFAULT_METADATA_TIMEOUT = 3_000

# Transport defaults (transport/TransportConfig.java:5-9).
DEFAULT_PORT = 0
DEFAULT_CONNECT_TIMEOUT = 3_000
DEFAULT_MAX_FRAME_LENGTH = 2 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """All protocol knobs for one cluster (times in ms), field for field
    ClusterConfig.java:64-81."""

    seed_members: Tuple[str, ...] = ()
    metadata: Tuple[Tuple[str, str], ...] = ()

    # MembershipConfig (membership/MembershipConfig.java:7-26)
    sync_interval: int = DEFAULT_SYNC_INTERVAL
    sync_timeout: int = DEFAULT_SYNC_TIMEOUT
    sync_group: str = DEFAULT_SYNC_GROUP
    suspicion_mult: int = DEFAULT_SUSPICION_MULT

    # FailureDetectorConfig (fdetector/FailureDetectorConfig.java:3-10)
    ping_interval: int = DEFAULT_PING_INTERVAL
    ping_timeout: int = DEFAULT_PING_TIMEOUT
    ping_req_members: int = DEFAULT_PING_REQ_MEMBERS

    # GossipConfig (gossip/GossipConfig.java:3-10)
    gossip_interval: int = DEFAULT_GOSSIP_INTERVAL
    gossip_fanout: int = DEFAULT_GOSSIP_FANOUT
    gossip_repeat_mult: int = DEFAULT_GOSSIP_REPEAT_MULT

    metadata_timeout: int = DEFAULT_METADATA_TIMEOUT

    # TransportConfig (transport/TransportConfig.java:3-126)
    port: int = DEFAULT_PORT
    connect_timeout: int = DEFAULT_CONNECT_TIMEOUT
    max_frame_length: int = DEFAULT_MAX_FRAME_LENGTH
    member_host: Optional[str] = None
    member_port: Optional[int] = None

    def __post_init__(self) -> None:
        # ClusterConfig.Builder.build() (ClusterConfig.java:412-415).
        if self.ping_timeout >= self.ping_interval:
            raise ValueError(
                f"ping_timeout ({self.ping_timeout}) must be smaller than "
                f"ping_interval ({self.ping_interval})"
            )

    @staticmethod
    def default() -> "ClusterConfig":
        """LAN defaults (ClusterConfig.java:107-114)."""
        return ClusterConfig()

    default_lan = default

    @staticmethod
    def default_wan() -> "ClusterConfig":
        """WAN overrides (ClusterConfig.java:116-126)."""
        return ClusterConfig(
            suspicion_mult=6,
            sync_interval=60_000,
            ping_timeout=3_000,
            ping_interval=5_000,
            gossip_fanout=4,
            connect_timeout=10_000,
        )

    @staticmethod
    def default_local() -> "ClusterConfig":
        """Loopback overrides (ClusterConfig.java:128-140)."""
        return ClusterConfig(
            suspicion_mult=3,
            sync_interval=15_000,
            ping_timeout=200,
            ping_interval=1_000,
            gossip_repeat_mult=2,
            ping_req_members=1,
            gossip_interval=100,
            connect_timeout=1_000,
        )

    def replace(self, **kwargs) -> "ClusterConfig":
        return dataclasses.replace(self, **kwargs)

    def metadata_dict(self) -> Dict[str, str]:
        return dict(self.metadata)

    def to_sim(self, cluster_size: int) -> "SimParams":
        """Quantize the millisecond knobs to protocol rounds: the gossip
        interval is the base round, ping and sync intervals become
        multiples of it, and the suspicion timeout becomes a round count
        via ClusterMath.java:123-125."""
        base = self.gossip_interval

        def rounds(ms: int) -> int:
            return max(1, int(round(ms / base)))

        return SimParams(
            cluster_size=cluster_size,
            ping_every=rounds(self.ping_interval),
            sync_every=rounds(self.sync_interval),
            suspicion_rounds=rounds(
                swim_math.suspicion_timeout(self.suspicion_mult, cluster_size,
                                            self.ping_interval)
            ),
            ping_req_members=self.ping_req_members,
            gossip_fanout=self.gossip_fanout,
            gossip_repeat_mult=self.gossip_repeat_mult,
            periods_to_spread=swim_math.gossip_periods_to_spread(
                self.gossip_repeat_mult, cluster_size
            ),
            periods_to_sweep=swim_math.gossip_periods_to_sweep(
                self.gossip_repeat_mult, cluster_size
            ),
        )


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Round-quantized schedule of the dense tick (all Python ints)."""

    cluster_size: int
    ping_every: int
    sync_every: int
    suspicion_rounds: int
    ping_req_members: int
    gossip_fanout: int
    gossip_repeat_mult: int
    periods_to_spread: int
    periods_to_sweep: int
