"""The gossip-only dissemination model, and the health registry's gossip
gauge.

Counterpart of ``scalecube_cluster_tpu/models/gossip.py``: G tracked
gossips spreading over N members, one period a round, the batched
equivalent of the reference gossip component alone (its statistical
experiment matrix, GossipProtocolTest.java:50-66: {N, loss, mean delay}).
Each member spreads each gossip it holds for ``periods_to_spread``
rounds after first receiving it, to ``fanout`` uniform targets other
than itself a round (drawn with replacement), each message dropped with
``loss_probability``; delivery dedups by gossip id (the infection bit).
With ``max_delay_rounds`` D > 0 a message's exponential delay becomes a
round offset ``floor(delay / round_ms)`` clamped to D, and later offsets
wait in a [D + 1, N, G] ring.

It is a separate model from the protocol round: its own draws
(:class:`GossipDraws`, a round's raw targets, drop uniforms and unit
exponentials) behind its own seam (``draws=`` of :func:`run`, any
callable ``round_idx -> GossipDraws``); :class:`GossipTorchDraws` is the
port's source.  State is O(N x G) bits, so the model runs millions of
members on one card.

Also :func:`piggyback_occupancy`, the share of live tracked records
inside their retransmission window (a gauge of ``telemetry/metrics``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from scalecube_cluster_tpu_torch import swim_math
from scalecube_cluster_tpu_torch.models import swim
from scalecube_cluster_tpu_torch.ops import delivery
from scalecube_cluster_tpu_torch.ops import prng
from scalecube_cluster_tpu_torch.ops import ring as ring_ops

METRICS = ("infected_count", "messages_sent", "newly_infected")


@dataclasses.dataclass(frozen=True)
class GossipSimParams:
    """Static knobs of the gossip tick, from a ``ClusterConfig``'s gossip
    settings for a cluster size (the reference's fields and defaults)."""

    n_members: int
    n_gossips: int
    fanout: int
    periods_to_spread: int
    loss_probability: float = 0.0
    mean_delay_ms: float = 0.0
    round_ms: float = 200.0
    max_delay_rounds: int = 0

    @staticmethod
    def from_config(config, n_members: int, n_gossips: int = 1,
                    loss_probability: float = 0.0,
                    mean_delay_ms: float = 0.0,
                    max_delay_rounds: int = 0) -> "GossipSimParams":
        return GossipSimParams(
            n_members=n_members,
            n_gossips=n_gossips,
            fanout=config.gossip_fanout,
            periods_to_spread=swim_math.gossip_periods_to_spread(
                config.gossip_repeat_mult, n_members),
            loss_probability=loss_probability,
            mean_delay_ms=mean_delay_ms,
            round_ms=float(config.gossip_interval),
            max_delay_rounds=max_delay_rounds,
        )

    @property
    def ring_slots(self) -> int:
        """D + 1 with the delay ring on, else 0."""
        return self.max_delay_rounds + 1 if self.max_delay_rounds > 0 else 0


@dataclasses.dataclass
class GossipState:
    """The carry: ``infected`` [N, G] bool (the member holds the gossip,
    the dedup bit), ``spread_until`` [N, G] int32 (the first round it no
    longer retransmits it), ``ring`` [D, N, G] bool (bits due in later
    rounds; D = ``max_delay_rounds + 1``, or 0 with the ring off)."""

    infected: torch.Tensor
    spread_until: torch.Tensor
    ring: torch.Tensor


@dataclasses.dataclass
class GossipDraws:
    """Exactly the randomness one gossip round consumes.

    ``targets`` [N, F] int32: raw draws in [0, N - 1), each shifted past
    its sender (``prng.targets_excluding_self``).  ``drop_u`` [N, F]
    float32: the loss uniforms.  ``delay_e`` [N, F] float32: unit
    exponentials ``-log1p(-u)`` of the delay, only with the ring on
    (``max_delay_rounds > 0``), else None."""

    targets: torch.Tensor
    drop_u: torch.Tensor
    delay_e: Optional[torch.Tensor] = None

    def to(self, device) -> "GossipDraws":
        return GossipDraws(
            self.targets.to(device), self.drop_u.to(device),
            None if self.delay_e is None else self.delay_e.to(device))


class GossipTorchDraws:
    """The port's draw source for ``(seed, device)``: a
    :class:`GossipDraws` a round, its generator seeded with
    ``prng.round_seed(seed, round_idx)`` (targets, then drop uniforms,
    then with the ring on the delay uniforms)."""

    def __init__(self, seed: int, device, params: GossipSimParams):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.n, self.f = params.n_members, params.fanout
        self.delayed = params.max_delay_rounds > 0
        self._gen = torch.Generator(device=self.device)

    def __call__(self, round_idx: int) -> GossipDraws:
        self._gen.manual_seed(prng.round_seed(self.seed, round_idx))
        shape = (self.n, self.f)
        targets = torch.randint(0, self.n - 1, shape, generator=self._gen,
                                device=self.device, dtype=torch.int32)
        drop_u = torch.rand(shape, generator=self._gen, device=self.device,
                            dtype=torch.float32)
        delay_e = None
        if self.delayed:
            delay_e = prng.unit_exponential(torch.rand(
                shape, generator=self._gen, device=self.device,
                dtype=torch.float32))
        return GossipDraws(targets, drop_u, delay_e)


def initial_state(params: GossipSimParams, origin=None,
                  device="cuda") -> GossipState:
    """Gossip g starts at member ``origin[g]`` (default member g mod N)
    at round 0, spreading for ``periods_to_spread`` rounds."""
    device = swim.resolve_device(device)
    n, g = params.n_members, params.n_gossips
    if origin is None:
        origin = torch.arange(g, dtype=torch.int64) % n
    origin = torch.as_tensor(origin, dtype=torch.int64, device=device)
    infected = torch.zeros((n, g), dtype=torch.bool, device=device)
    infected[origin, torch.arange(g, device=device)] = True
    spread_until = torch.where(
        infected, params.periods_to_spread, 0).to(torch.int32)
    ring = torch.zeros((params.ring_slots, n, g), dtype=torch.bool,
                       device=device)
    return GossipState(infected, spread_until, ring)


def gossip_tick(state: GossipState, round_idx: int, draws: GossipDraws,
                params: GossipSimParams) -> Tuple[GossipState, Dict]:
    """One gossip period (the reference's ``gossip_tick``): the members
    inside their spread window send every gossip they hold to their
    targets; returns ``(new_state, metrics)`` with [G] int32
    ``infected_count``, ``messages_sent`` and ``newly_infected``.  The
    input state is not modified."""
    n = params.n_members
    hot = state.infected & (round_idx < state.spread_until)
    senders = torch.arange(n, dtype=torch.int32, device=hot.device)
    targets = prng.targets_excluding_self(draws.targets, senders)
    drop = draws.drop_u < params.loss_probability
    ring = state.ring
    if params.max_delay_rounds == 0:
        inbox = delivery.scatter_or(hot, targets, drop, n)
    else:
        # Offset-0 messages land now; the slot due now is opened before
        # the later offsets or-fold into their slots, one scatter each.
        d = params.ring_slots
        slot0 = round_idx % d
        mean = torch.tensor(params.mean_delay_ms, dtype=torch.float32,
                            device=hot.device)
        q = ring_ops.delay_bins(draws.delay_e, mean, params.round_ms,
                                params.max_delay_rounds)
        ring = ring.clone()
        due_now = ring_ops.open_slot(ring, slot0, False)
        inbox = delivery.scatter_or(hot, targets, drop | (q != 0), n)
        inbox |= due_now
        for j in range(1, d):
            ring_ops.push_or(ring, (slot0 + j) % d, delivery.scatter_or(
                hot, targets, drop | (q != j), n))
    newly = inbox & ~state.infected
    infected = state.infected | inbox
    spread_until = torch.where(
        newly, torch.tensor(round_idx + 1 + params.periods_to_spread,
                            dtype=torch.int32, device=hot.device),
        state.spread_until)
    metrics = {
        "infected_count": infected.sum(dim=0, dtype=torch.int32),
        "messages_sent": hot.sum(dim=0, dtype=torch.int32) * params.fanout,
        "newly_infected": newly.sum(dim=0, dtype=torch.int32),
    }
    return GossipState(infected, spread_until, ring), metrics


def run(seed: int, params: GossipSimParams, n_rounds: int,
        state: Optional[GossipState] = None,
        draws: Optional[Callable[[int], GossipDraws]] = None,
        device="cuda"):
    """The gossip tick over rounds 0 .. ``n_rounds - 1`` from ``state``
    (default :func:`initial_state`).  Returns ``(final_state, metrics)``,
    each metric [n_rounds, G] int32: the dissemination trace.  ``draws``
    (default ``GossipTorchDraws(seed, device, params)``) gives each
    round's :class:`GossipDraws`, moved to the device if made elsewhere.
    The caller's state is not modified."""
    device = swim.resolve_device(device)
    if state is None:
        state = initial_state(params, device=device)
    elif state.infected.device != device:
        raise ValueError(f"state is on {state.infected.device}, the run on "
                         f"{device}")
    if draws is None:
        draws = GossipTorchDraws(seed, device, params)
    rows = {name: [] for name in METRICS}
    for r in range(n_rounds):
        state, metrics = gossip_tick(state, r, draws(r).to(device), params)
        for name in METRICS:
            rows[name].append(metrics[name])
    if n_rounds == 0:
        empty = torch.zeros((0, params.n_gossips), dtype=torch.int32,
                            device=device)
        return state, {name: empty.clone() for name in METRICS}
    return state, {name: torch.stack(rows[name]) for name in METRICS}


def dissemination_rounds(metrics, n_members: int) -> torch.Tensor:
    """[G] int32: the first round at which each gossip reached all N
    members, -1 if it never did (ClusterMath.gossipDisseminationTime's
    measured counterpart, in rounds)."""
    full = (metrics["infected_count"] >= n_members).to(torch.int32)
    ever = full.any(dim=0)
    first = full.argmax(dim=0).to(torch.int32)
    return torch.where(ever, first, -1).to(torch.int32)


def piggyback_occupancy(hot_count, capacity):
    """The share of live tracked records still inside their
    retransmission window: ``hot_count`` (records the send path would
    piggyback) over ``capacity`` (live members x tracked subjects, at
    least 1).  Near 0 in the steady state, near 1 when membership churns
    faster than the spread windows drain.  float32, as the reference
    computes it: int32 totals cast, then one division."""
    cap = torch.clamp(torch.as_tensor(capacity).to(torch.float32), min=1.0)
    return torch.as_tensor(hot_count).to(torch.float32) / cap
