"""The declarative fault-scenario DSL and its seeded campaign generator.

Counterpart of ``scalecube_cluster_tpu/chaos/scenarios.py``, every public
name.  A :class:`Scenario` is a named list of fault OPS over an N-member
world and a horizon; ``Scenario.build(params, device=...)`` compiles the
ops onto the port's world builders (``models/swim.SwimWorld``'s crash,
leave, partition, link-fault, join and config-push schedules) and
derives the :class:`~scalecube_cluster_tpu_torch.chaos.monitor.
MonitorSpec` of what the scenario promises:

  - ``check_false_suspicion`` only on PRISTINE networks (no loss, no
    link rules, no delays, no partitions);
  - per-subject completeness deadlines ``complete_by``: a permanently
    crashed or left subject must be dropped by every eligible observer
    within :func:`completeness_bound` rounds of max(its fault round, the
    end of the last network disruption), with no promise under a
    PERMANENT network disruption;
  - the join deadlines (``join_known_by``) by the same rule, and the
    post-heal agreement round when the anti-entropy plane is on and
    every fault quiesces before its heal.

Ops (frozen dataclasses; ``apply(world, n, horizon)`` composes on the
world builders, so op order is schedule-override order): ``Crash``,
``CrashBurst``, ``Leave``, ``ChurnStorm`` (staggered crash/revive waves,
optionally admitting new identities), ``Join``, ``LinkLoss``,
``FlappingLink``, ``Brownout`` (a loss and delay ramp between id ranges),
``RollingPartition``, ``ConfigPush`` and ``StagedRollout``.

:func:`generate_scenario` is pure in (seed, n, severity), so a failing
scenario of a campaign is the one-line repro ``generate_scenario(seed=S,
n=N, severity='tier')``; the same call gives the same scenario in the
reference.  Horizons are quantized (multiples of 64), and every built
world's link-fault rules are padded with match-nothing rules (empty id
ranges, a [0, 0) window) to a multiple of 8 as the reference pads them:
the padding changes no loss or delay, but a world with any rule takes
the per-hop FD chains and their draws (``ops/prng.DrawFacts.delayed``),
so the padded world is the one whose runs equal the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from scalecube_cluster_tpu_torch.chaos.monitor import MonitorSpec
from scalecube_cluster_tpu_torch.models import metadata, swim

INT32_MAX = swim.INT32_MAX

SEVERITIES = ("mild", "moderate", "severe")

# Fixed LinkFaults width generated scenarios pad to (match-nothing
# rules are free: an empty id range matches no message).
_RULE_PAD = 8
_HORIZON_QUANTUM = 64


def quiesce_bound(params: "swim.SwimParams", n: int) -> int:
    """Rounds a fault's effects need to go COLD: cross-fault suspicions
    detected and spread, suspicion timers matured to tombstones, and the
    tombstones' gossip windows expired.  A partition healed (or a node
    revived) after at least this many rounds re-converges monotonically
    under the SYNC anti-entropy plane; a shorter window releases
    freshly-hot tombstones into the healed cluster, a regime the merge
    precedence cannot bound (models/sync.py "quiesced-heal
    precondition")."""
    log2n = math.ceil(math.log2(n + 1))
    return (24 * max(1, params.ping_every)      # detection + verdict spread
            + params.suspicion_rounds           # timers mature
            + params.periods_to_spread + 1      # tombstone gossip expires
            + 4 * log2n + 16)


def post_heal_agreement_bound(params: "swim.SwimParams", n: int) -> int:
    """Rounds after the last heal within which every live table must
    agree (the POST_HEAL_DIVERGENCE window): one anti-entropy exchange
    interval + the dissemination bound for the reopened records + probe
    slack for in-flight FD refute pushes: a ``sync_interval +
    dissemination_bound`` contract, deliberately generous — it is a
    convergence CONTRACT, not a latency benchmark (``bench.py --sync``
    measures the actual figure)."""
    log2n = math.ceil(math.log2(n + 1))
    return (params.sync_interval
            + 4 * log2n + params.periods_to_spread
            + 2 * max(1, params.ping_every) + 16)


def metadata_convergence_bound(params: "swim.SwimParams", n: int) -> int:
    """Rounds within which a pushed metadata word must reach every live
    table: one anti-entropy exchange interval (the full-table lane that
    crosses healed partitions — models/metadata.py) + the piggyback
    dissemination bound for the hot window + probe slack.  Like
    :func:`post_heal_agreement_bound` this is a convergence CONTRACT,
    deliberately generous — ``bench.py --rollout`` measures the actual
    p99 (``metadata_convergence_p99``); the staged-rollout gate and the
    telemetry regress consume THIS bound so the deadline arithmetic
    lives in one place."""
    log2n = math.ceil(math.log2(n + 1))
    return (params.sync_interval
            + 4 * log2n + params.periods_to_spread
            + 2 * max(1, params.ping_every) + 16)


def quiesced_heal_scenario(params: "swim.SwimParams", n: int,
                           name: str = "quiesced-heal",
                           slack: int = 32) -> "Scenario":
    """The canonical single split/heal cycle sized to QUIESCE: one
    RollingPartition whose split clears :func:`quiesce_bound` (rounded
    up to the 16-round phase quantum) and whose horizon covers the heal
    plus one :func:`post_heal_agreement_bound` window plus ``slack`` —
    the schedule ``bench.py --sync``, the monitor tests, and the oracle
    partition cross-validation all measure, built in ONE place so the
    bound arithmetic cannot drift between them.  The split length is
    exposed as ``ops[0].phase_rounds`` (= the heal round)."""
    phase = -(-quiesce_bound(params, n) // 16) * 16
    horizon = 2 * phase + post_heal_agreement_bound(params, n) + slack
    return Scenario(
        name=name, n_members=n, horizon=horizon,
        ops=(RollingPartition(from_round=0, phase_rounds=phase,
                              n_cycles=1),),
    )


def completeness_bound(params: "swim.SwimParams", n: int) -> int:
    """Rounds within which a permanent crash/leave must be DEAD in every
    eligible observer's view: detection slack (FD probe discovery has a
    geometric tail over target draws) + the suspicion timeout +
    dissemination/anti-entropy slack.  Deliberately generous — the
    monitor's completeness check is a liveness CONTRACT, not a latency
    benchmark (the latency histograms in telemetry/ measure that)."""
    log2n = math.ceil(math.log2(n + 1))
    return (params.suspicion_rounds
            + 24 * max(1, params.ping_every)
            + 4 * log2n
            + 2 * max(1, params.sync_every)
            + 16)


# --------------------------------------------------------------------------
# Ops
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Crash:
    """Crash ``node`` during [at_round, until_round); INT32_MAX = forever."""

    node: int
    at_round: int
    until_round: int = INT32_MAX

    def apply(self, world, n, horizon):
        return world.with_crash(self.node, self.at_round, self.until_round)

    def disruption(self, n, horizon):
        return None                      # process fault, not network


@dataclasses.dataclass(frozen=True)
class CrashBurst:
    """Correlated burst: every node in ``nodes`` crashes at the same
    round (revived together when ``until_round`` is finite)."""

    nodes: Tuple[int, ...]
    at_round: int
    until_round: int = INT32_MAX

    def apply(self, world, n, horizon):
        return world.with_crash(list(self.nodes), self.at_round,
                                self.until_round)

    def disruption(self, n, horizon):
        return None


@dataclasses.dataclass(frozen=True)
class Leave:
    """Graceful leave at ``at_round`` (DEAD@inc+1 self-gossip, then down)."""

    node: int
    at_round: int

    def apply(self, world, n, horizon):
        return world.with_leave(self.node, self.at_round)

    def disruption(self, n, horizon):
        return None


@dataclasses.dataclass(frozen=True)
class ChurnStorm:
    """Staggered crash(/revive) waves: wave w crashes
    ``nodes[w*wave_size:(w+1)*wave_size]`` at
    ``start_round + w*wave_every``, each down for ``down_rounds``
    (0 = permanent).  Node slices are disjoint by construction, so
    waves never clobber each other's windows.

    Arrival waves (the open-world extension — SwimParams.open_world
    must be on for the joins to execute): ``join_wave_size > 0`` makes
    each wave ALSO admit that many NEW members (fresh identities) into
    recycled DEAD slots, ``join_lag`` rounds after the wave's crashes.
    Join targets drain a FIFO of free slots: the ``arrivals`` pool
    (slots crashed at round 0 — the pre-dead free capacity that makes
    NET-POSITIVE growth possible: joins - permanent crashes =
    n_waves*join_wave_size - len(nodes)) first, then each wave's own
    crashed slots once they are eligible (dead strictly before the
    join round).  Construction raises if a wave cannot fill its join
    quota — a storm that silently joined fewer members than declared
    would corrupt the growth arithmetic (scenarios stay exact, pure in
    their fields).  ``join_wave_size > 0`` requires permanent crashes
    (``down_rounds == 0``): a revive schedule and a join cannot share
    a slot."""

    nodes: Tuple[int, ...]
    wave_size: int
    start_round: int
    wave_every: int
    down_rounds: int = 0
    join_wave_size: int = 0
    join_lag: int = 0
    arrivals: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.wave_size < 1 or len(self.nodes) % self.wave_size:
            raise ValueError(
                f"wave_size {self.wave_size} must divide the pool size "
                f"{len(self.nodes)}")
        if self.join_wave_size:
            if self.down_rounds:
                raise ValueError(
                    "ChurnStorm arrival waves need permanent crashes "
                    f"(down_rounds=0; got {self.down_rounds}) — a revive "
                    "schedule and a join cannot share a slot")
            if set(self.arrivals) & set(self.nodes):
                raise ValueError(
                    f"arrivals pool overlaps the crash pool: "
                    f"{sorted(set(self.arrivals) & set(self.nodes))}")
            self._join_schedule()        # validates quota feasibility

    @property
    def n_waves(self) -> int:
        return len(self.nodes) // self.wave_size

    def _join_schedule(self):
        """[(slot, join_round)] for every arrival, FIFO over free slots
        (class docstring); raises when a wave's quota cannot be met."""
        free = [(s, 0) for s in self.arrivals]       # (slot, death round)
        out = []
        for w in range(self.n_waves):
            at = self.start_round + w * self.wave_every
            join_at = at + self.join_lag
            free.extend(
                (s, at)
                for s in self.nodes[w * self.wave_size:
                                    (w + 1) * self.wave_size])
            taken = 0
            while taken < self.join_wave_size and free:
                slot, died = free[0]
                if died >= join_at:      # not yet dead at the join round
                    break
                free.pop(0)
                out.append((slot, join_at))
                taken += 1
            if taken < self.join_wave_size:
                raise ValueError(
                    f"ChurnStorm wave {w} can only fill {taken} of "
                    f"{self.join_wave_size} join slots at round "
                    f"{join_at} — grow the arrivals pool or the "
                    f"join_lag (free-slot FIFO exhausted)")
        return out

    def apply(self, world, n, horizon):
        if self.arrivals:
            world = world.with_crash(list(self.arrivals), 0)
        for w in range(self.n_waves):
            at = self.start_round + w * self.wave_every
            until = at + self.down_rounds if self.down_rounds else INT32_MAX
            world = world.with_crash(
                list(self.nodes[w * self.wave_size:(w + 1) * self.wave_size]),
                at, until)
        if self.join_wave_size:
            for slot, join_at in self._join_schedule():
                world = world.with_join(slot, join_at)
        return world

    def disruption(self, n, horizon):
        return None


@dataclasses.dataclass(frozen=True)
class Join:
    """Admit a NEW member into recycled DEAD ``slot`` at ``at_round``
    (``SwimWorld.with_join``: the slot must be scheduled dead first;
    op order matters, like every schedule-override op).  Requires
    ``SwimParams.open_world`` to execute as an identity join."""

    slot: int
    at_round: int

    def apply(self, world, n, horizon):
        return world.with_join(self.slot, self.at_round)

    def disruption(self, n, horizon):
        return None                      # process-level, not network


@dataclasses.dataclass(frozen=True)
class LinkLoss:
    """One per-link loss/delay rule (``src``/``dst``: id or (lo, hi))."""

    src: object
    dst: object
    loss: float
    delay_ms: float = 0.0
    from_round: int = 0
    until_round: int = INT32_MAX

    def apply(self, world, n, horizon):
        return world.with_link_fault(self.src, self.dst, self.loss,
                                     self.delay_ms, self.from_round,
                                     self.until_round)

    def disruption(self, n, horizon):
        if self.loss > 0.0 or self.delay_ms > 0.0:
            return (self.from_round, self.until_round)
        return None


@dataclasses.dataclass(frozen=True)
class FlappingLink:
    """src→dst link flaps: ``n_cycles`` windows of ``down_rounds`` at
    ``loss`` (default full block), ``up_rounds`` healthy in between."""

    src: int
    dst: int
    from_round: int
    n_cycles: int
    down_rounds: int
    up_rounds: int
    loss: float = 1.0

    def __post_init__(self):
        if self.down_rounds < 1 or self.n_cycles < 1:
            raise ValueError(
                f"FlappingLink needs down_rounds >= 1 and n_cycles >= 1 "
                f"(got down_rounds={self.down_rounds}, "
                f"n_cycles={self.n_cycles}) — a flap with no down window "
                f"is no fault")

    def apply(self, world, n, horizon):
        period = self.down_rounds + self.up_rounds
        for c in range(self.n_cycles):
            start = self.from_round + c * period
            world = world.with_link_fault(
                self.src, self.dst, self.loss,
                from_round=start, until_round=start + self.down_rounds)
        return world

    def disruption(self, n, horizon):
        period = self.down_rounds + self.up_rounds
        end = (self.from_round + (self.n_cycles - 1) * period
               + self.down_rounds)
        return (self.from_round, end)


@dataclasses.dataclass(frozen=True)
class Brownout:
    """Asymmetric range-to-range degradation ramp: loss (and optionally
    mean link delay) steps ``peak/steps .. peak`` over ``ramp_rounds``,
    holds at the peak for ``hold_rounds`` (0 = ramp straight back
    down), then steps back down — up to 2*steps+1 rules (zero-length
    windows are skipped, not emitted).

    ``peak_delay_ms`` (default 0 = pure loss, the original op) ramps a
    mean exponential per-hop delay alongside the loss — the slow-link /
    slow-host brownout whose probe failures are TIMEOUTS rather than
    drops (the regime Lifeguard's LHA timeout scaling targets,
    models/lifeguard.py; link delay enters the FD hop budgets exactly,
    models/swim._chain_ok)."""

    src: Tuple[int, int]
    dst: Tuple[int, int]
    peak_loss: float
    from_round: int
    ramp_rounds: int
    hold_rounds: int
    steps: int = 3
    peak_delay_ms: float = 0.0

    def __post_init__(self):
        if self.steps < 1 or self.ramp_rounds < 1:
            raise ValueError(
                f"Brownout needs steps >= 1 and ramp_rounds >= 1 (got "
                f"steps={self.steps}, ramp_rounds={self.ramp_rounds})")
        if self.peak_delay_ms < 0:
            raise ValueError(
                f"Brownout peak_delay_ms must be >= 0 "
                f"(got {self.peak_delay_ms})")

    def _windows(self):
        step_len = max(1, self.ramp_rounds // self.steps)
        t = self.from_round
        for i in range(1, self.steps + 1):          # ramp up
            yield (t, t + step_len, self.peak_loss * i / self.steps,
                   self.peak_delay_ms * i / self.steps)
            t += step_len
        if self.hold_rounds > 0:                    # hold at the peak
            yield (t, t + self.hold_rounds, self.peak_loss,
                   self.peak_delay_ms)
            t += self.hold_rounds
        for i in range(self.steps - 1, 0, -1):      # ramp down
            yield (t, t + step_len, self.peak_loss * i / self.steps,
                   self.peak_delay_ms * i / self.steps)
            t += step_len

    def apply(self, world, n, horizon):
        for lo, hi, loss, delay in self._windows():
            world = world.with_link_fault(tuple(self.src), tuple(self.dst),
                                          loss, delay_ms=delay,
                                          from_round=lo,
                                          until_round=hi)
        return world

    def disruption(self, n, horizon):
        end = max(hi for _, hi, _, _ in self._windows())
        return (self.from_round, end)


@dataclasses.dataclass(frozen=True)
class RollingPartition:
    """``n_cycles`` of [rotated half/half split for ``phase_rounds``,
    then heal for ``phase_rounds``], starting at ``from_round`` (must be
    a multiple of ``phase_rounds`` — the rolling schedule is
    phase-quantized).  The compiled phase list is explicitly
    zero-padded past the horizon so the cycle cannot wrap back into a
    split within the run."""

    from_round: int
    phase_rounds: int
    n_cycles: int
    rotate: int = 0

    def __post_init__(self):
        if self.from_round % self.phase_rounds:
            raise ValueError(
                f"from_round ({self.from_round}) must be a multiple of "
                f"phase_rounds ({self.phase_rounds}) — partition_at "
                f"quantizes the rolling schedule by phase")

    def apply(self, world, n, horizon):
        lead = self.from_round // self.phase_rounds
        phases = [[0] * n for _ in range(lead)]
        for c in range(self.n_cycles):
            phases.append([
                1 if ((i + c * self.rotate) % n) < n // 2 else 0
                for i in range(n)
            ])
            phases.append([0] * n)
        while len(phases) * self.phase_rounds <= horizon:
            phases.append([0] * n)
        return world.with_partition_schedule(
            np.asarray(phases, dtype=np.int8), self.phase_rounds)

    def disruption(self, n, horizon):
        lead = self.from_round // self.phase_rounds
        end = (lead + 2 * self.n_cycles - 1) * self.phase_rounds
        return (self.from_round, end)


@dataclasses.dataclass(frozen=True)
class ConfigPush:
    """Owner-local config write: ``node`` sets its metadata cell ``key``
    to ``value`` at ``at_round`` (``SwimWorld.with_metadata_push``, the
    simulator's ``Cluster.updateMetadata``).  Requires
    the metadata plane: ``SwimParams.metadata_keys > key``
    (chaos/campaign.campaign_params enables it automatically via
    :attr:`Scenario.has_metadata`).  Not a fault: no disruption window,
    no effect on membership schedules — a scenario of pushes over a
    pristine network stays pristine."""

    node: int
    key: int
    value: int
    at_round: int

    def apply(self, world, n, horizon):
        return world.with_metadata_push(self.node, self.key, self.value,
                                        self.at_round)

    def disruption(self, n, horizon):
        return None                      # config data, not network

    def push_schedule(self):
        """[(node, key, value, round)] — the flat form the staged
        rollout's gate and the oracle replay consume."""
        return [(self.node, self.key, self.value, self.at_round)]


@dataclasses.dataclass(frozen=True)
class StagedRollout:
    """Staged config rollout: ``members`` (the rollout order) split into
    ``n_stages`` equal waves; stage s's members each push ``key`` =
    ``value`` on themselves at ``start_round + s * stage_every``.

    The op compiles the OPTIMISTIC forward schedule — every stage fires
    on time.  The convergence GATE between stages is the runner's job
    (``bench.py --rollout``): it runs segment-by-segment, polls
    ``models/metadata.divergence_probe`` at each stage boundary, and
    rolls the remaining stages forward only while each stage converges
    within its deadline (``stage_every`` must cover
    :func:`metadata_convergence_bound`, validated here so a rollout
    whose stages cannot possibly converge in time is a build-time
    error, not a mystery breach) — otherwise it REBUILDS the tail as a
    rollback push of ``rollback_value`` on the already-flipped members
    (:meth:`rollback_ops`).  A gate cannot live inside the compiled
    schedule: the world arrays are pure data, and a data-dependent push
    round would break the one-compile-per-shape campaign contract.
    """

    members: Tuple[int, ...]
    n_stages: int
    key: int
    value: int
    start_round: int
    stage_every: int
    rollback_value: int = 0

    def __post_init__(self):
        if self.n_stages < 1 or len(self.members) % self.n_stages:
            raise ValueError(
                f"n_stages {self.n_stages} must be >= 1 and divide the "
                f"member count {len(self.members)}")
        if len(set(self.members)) != len(self.members):
            raise ValueError(
                f"StagedRollout members must be distinct (got "
                f"{self.members}) — one owner cannot join two stages")
        if self.stage_every < 1:
            raise ValueError(
                f"stage_every {self.stage_every} must be >= 1")

    @property
    def stage_size(self) -> int:
        return len(self.members) // self.n_stages

    def stage_round(self, s: int) -> int:
        return self.start_round + s * self.stage_every

    def stage_members(self, s: int) -> Tuple[int, ...]:
        return self.members[s * self.stage_size:(s + 1) * self.stage_size]

    def validate_gate(self, params, n) -> None:
        """Raise unless ``stage_every`` covers the convergence bound —
        a stage that CANNOT meet its own deadline is a schedule bug,
        not a finding (the runner calls this before running)."""
        bound = metadata_convergence_bound(params, n)
        if self.stage_every < bound:
            raise ValueError(
                f"StagedRollout stage_every={self.stage_every} is below "
                f"the convergence bound {bound} for this config — no "
                f"stage could ever pass its gate "
                f"(chaos/scenarios.metadata_convergence_bound)")

    def apply(self, world, n, horizon):
        for node, key, value, at in self.push_schedule():
            world = world.with_metadata_push(node, key, value, at)
        return world

    def disruption(self, n, horizon):
        return None

    def push_schedule(self):
        return [(m, self.key, self.value, self.stage_round(s))
                for s in range(self.n_stages)
                for m in self.stage_members(s)]

    def rollback_ops(self, failed_stage: int, at_round: int
                     ) -> Tuple[ConfigPush, ...]:
        """The rollback tail after ``failed_stage`` breached its gate:
        one :class:`ConfigPush` of ``rollback_value`` at ``at_round``
        for every member of stages ``0..failed_stage`` (the flipped
        set — later stages never fired, nothing to undo)."""
        flipped = [m for s in range(failed_stage + 1)
                   for m in self.stage_members(s)]
        return tuple(ConfigPush(node=m, key=self.key,
                                value=self.rollback_value,
                                at_round=at_round) for m in flipped)


# --------------------------------------------------------------------------
# Scenario
# --------------------------------------------------------------------------


def _pad_rules(faults: "swim.LinkFaults", total: int) -> "swim.LinkFaults":
    """Pad the rule arrays to ``total`` with match-nothing rules (empty
    id ranges) so scenarios with different rule counts share one traced
    shape — the last-match-wins evaluation is unaffected."""
    r = faults.n_rules
    if r >= total:
        return faults
    pad = total - r
    # Every field 0: an empty id range (src_hi == src_lo) and an empty
    # window, loss 0, no delay.  ``LinkFaults.add`` refuses such a rule,
    # so the arrays are built here.
    return swim.LinkFaults(**{
        name: torch.cat([getattr(faults, name),
                         getattr(faults, name).new_zeros((pad,))])
        for name in swim.LinkFaults.ARRAYS})


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One declarative fault scenario (module docstring).

    ``loss_probability`` is the background symmetric wire loss the
    scenario asks the run for (a params knob, not a world schedule —
    campaign.run_scenario applies it).  ``extra_slack`` widens the
    completeness deadlines for hand-built scenarios whose network is
    harsher than the generator's tiers.  ``seed``/``severity`` are
    campaign provenance; :meth:`repro` is the one-line reconstruction
    of a generated scenario.
    """

    name: str
    n_members: int
    horizon: int
    ops: Tuple[object, ...]
    loss_probability: float = 0.0
    seed: Optional[int] = None
    severity: Optional[str] = None
    extra_slack: int = 0

    def repro(self) -> str:
        if self.seed is not None and self.severity is not None:
            return (f"chaos.generate_scenario(seed={self.seed}, "
                    f"n={self.n_members}, severity={self.severity!r})")
        return f"<hand-built scenario {self.name!r}>"

    @property
    def has_joins(self) -> bool:
        """True when any op schedules an open-world JOIN — the runner
        must enable ``SwimParams.open_world`` or the joins degrade to
        same-identity revivals (chaos/campaign.campaign_params does
        this automatically)."""
        return any(
            isinstance(op, Join)
            or (isinstance(op, ChurnStorm) and op.join_wave_size > 0)
            for op in self.ops
        )

    @property
    def has_metadata(self) -> bool:
        """True when any op pushes a metadata word — the runner must
        enable ``SwimParams.metadata_keys`` or the pushes compile to
        no-ops (chaos/campaign.campaign_params does this
        automatically, sized by :meth:`metadata_keys_needed`)."""
        return any(isinstance(op, (ConfigPush, StagedRollout))
                   for op in self.ops)

    def metadata_keys_needed(self) -> int:
        """Smallest ``SwimParams.metadata_keys`` covering every pushed
        key (0 when no op pushes — the plane stays off)."""
        keys = [op.key for op in self.ops
                if isinstance(op, (ConfigPush, StagedRollout))]
        return max(keys) + 1 if keys else 0

    def build(self, params: "swim.SwimParams",
              rule_pad: int = _RULE_PAD, device="cuda"):
        """Compile to ``(SwimWorld, MonitorSpec)`` for ``params`` on
        ``device``."""
        n = params.n_members
        if n != self.n_members:
            raise ValueError(
                f"scenario {self.name!r} is for n_members="
                f"{self.n_members}, params has {n}")
        world = swim.SwimWorld.healthy(params, device=device)
        for op in self.ops:
            world = op.apply(world, n, self.horizon)
        r = world.faults.n_rules
        pad_to = max(rule_pad, -(-r // max(1, rule_pad)) * rule_pad)
        world = dataclasses.replace(
            world, faults=_pad_rules(world.faults, pad_to))

        disruptions = [d for d in
                       (op.disruption(n, self.horizon) for op in self.ops)
                       if d is not None]
        permanent_disruption = any(d[1] >= INT32_MAX for d in disruptions)
        disruption_end = max((d[1] for d in disruptions), default=0)
        pristine = (not disruptions
                    and params.loss_probability == 0.0
                    and self.loss_probability == 0.0
                    and params.mean_delay_ms == 0.0)

        bound = completeness_bound(params, n) + self.extra_slack
        df = world.down_from.cpu().numpy().astype(np.int64)
        du = world.down_until.cpu().numpy().astype(np.int64)
        la = world.leave_at.cpu().numpy().astype(np.int64)
        fault = np.minimum(df, la)
        permanent = (fault < INT32_MAX) & (du >= INT32_MAX)
        checkable = permanent & (not permanent_disruption)
        deadline = np.where(
            checkable,
            np.minimum(np.maximum(fault, disruption_end) + bound,
                       INT32_MAX),
            INT32_MAX,
        )
        slot = world.slot_of_node.cpu().numpy()
        complete_by = np.full(params.n_subjects, INT32_MAX, dtype=np.int64)
        tracked = slot >= 0
        complete_by[slot[tracked]] = deadline[tracked]

        # JOIN-propagation deadlines (NO_RESURRECTION /
        # JOIN_COMPLETENESS): a joined identity must be globally known
        # — and no dead epoch's record survive as live — within the
        # same generous completeness bound, measured from the join (or
        # the end of the last network disruption).  No promise under a
        # permanent disruption, the COMPLETENESS rule.
        ja = world.join_at.cpu().numpy().astype(np.int64)
        join_known_by = np.full(params.n_subjects, INT32_MAX,
                                dtype=np.int64)
        joins_checkable = (ja < INT32_MAX) & (not permanent_disruption)
        j_deadline = np.where(
            joins_checkable,
            np.minimum(np.maximum(ja, disruption_end) + bound, INT32_MAX),
            INT32_MAX,
        )
        join_known_by[slot[tracked]] = j_deadline[tracked]
        check_joins = bool(params.open_world and joins_checkable.any())

        # Post-heal agreement promise (POST_HEAL_DIVERGENCE): made only
        # when the SYNC anti-entropy plane is ON, the background network
        # is pristine, and every fault quiesces before its heal — the
        # preconditions under which bounded re-convergence actually
        # holds (models/sync.py "quiesced-heal precondition").
        agree_from = INT32_MAX
        if (params.sync_interval > 0
                and not permanent_disruption
                and params.loss_probability == 0.0
                and self.loss_probability == 0.0
                and params.mean_delay_ms == 0.0
                and all(self._op_quiesces(op, params, n)
                        for op in self.ops)):
            # Settling deadlines: a HEAL (disruption end, revive) needs
            # one agreement window; a fault START (crash/leave round)
            # additionally needs its own effects to mature first —
            # detection, suspicion timers, tombstone spread
            # (quiesce_bound) — before the agreement clock can run, or a
            # legitimate mid-maturation ALIVE/SUSPECT/DEAD mixture trips
            # the invariant.
            qb = quiesce_bound(params, n)
            settle = [disruption_end]
            finite_du = du[du < INT32_MAX]
            if finite_du.size:
                settle.append(int(finite_du.max()))
            for arr in (df, la):
                finite = arr[arr < INT32_MAX]
                if finite.size:
                    settle.append(int(finite.max()) + qb)
            agree_from = min(
                max(settle) + post_heal_agreement_bound(params, n)
                + self.extra_slack,
                INT32_MAX,
            )

        device = world.device
        spec = MonitorSpec(
            complete_by=torch.from_numpy(
                complete_by.astype(np.int32)).to(device),
            agree_from=int(agree_from),
            check_agreement=agree_from < INT32_MAX,
            check_false_suspicion=pristine,
            join_known_by=torch.from_numpy(
                join_known_by.astype(np.int32)).to(device),
            check_joins=check_joins,
        )
        return world, spec

    @staticmethod
    def _op_quiesces(op, params: "swim.SwimParams", n: int) -> bool:
        """Does this op's disturbance go cold before its own heal (the
        agreement-promise precondition)?  Process faults must be
        permanent or down for >= quiesce_bound; partitions must hold
        each phase >= quiesce_bound; probabilistic network ops (loss,
        flaps, brownouts) never promise — their false suspicions mature
        on their own clocks."""
        qb = quiesce_bound(params, n)
        if isinstance(op, (Crash, CrashBurst)):
            return (op.until_round >= INT32_MAX
                    or op.until_round - op.at_round >= qb)
        if isinstance(op, Leave):
            return True                  # announces its own death
        if isinstance(op, Join):
            return False                 # identity rebirth: join codes own it
        if isinstance(op, ChurnStorm):
            if op.join_wave_size:
                # Arrival storms rebirth slots mid-run; the live-consensus
                # agreement clock has no settled meaning across identity
                # epochs — the join codes own that contract instead.
                return False
            return op.down_rounds == 0 or op.down_rounds >= qb
        if isinstance(op, RollingPartition):
            return op.phase_rounds >= qb
        if isinstance(op, (ConfigPush, StagedRollout)):
            return True                  # config data: no fault to cool
        return False


def asymmetric_degraded_range(n: int) -> int:
    """Size of :func:`asymmetric_degradation`'s degraded observer range
    (ids ``[0, q)``) — ONE place, consumed by the scenario builder AND
    ``bench.py --lifeguard`` (which crashes exactly this rack for its
    detection-parity probe; a drifted copy would silently crash healthy
    members and corrupt the A/B)."""
    return max(2, n // 8)


def asymmetric_degradation(seed: int, n: int = 32,
                           peak_loss: float = 0.3,
                           peak_delay_ms: float = 300.0,
                           hold_rounds: int = 200,
                           params: Optional["swim.SwimParams"] = None
                           ) -> Scenario:
    """Seeded composite for the Lifeguard headline experiment
    (bench.py --lifeguard): observer-side asymmetric degradation.

    A small minority of the id range (``max(2, n // 8)`` members —
    Lifeguard's operating regime: degraded members are rare, a cluster
    losing a quarter of its probe capacity cannot keep detection
    latency flat under ANY adaptivity) are the DEGRADED OBSERVERS: a
    :class:`Brownout` ramps loss AND mean link delay on their INBOUND
    links (src = the healthy majority, dst = the degraded range) up to
    the peaks and holds — their probes of perfectly healthy peers drop
    or time out on the ack hop, which is exactly the observer-local
    unreliability Lifeguard's LHM detects (the outbound direction
    stays clean, so their false SUSPECT verdicts still disseminate at
    full rate — the worst case for cluster-wide false positives).  The
    delay component is the regime the LHA *timeout* scaling repairs
    outright (a stretched budget lets the slow acks land) while true
    crash detection is untouched (a crashed target never acks, at any
    budget).  A seeded :class:`FlappingLink` into the same range rides
    along for non-stationary flap noise.  The rest of the network is
    pristine.

    Pure in ``(seed, n)`` like :func:`generate_scenario` — one-line
    repro: ``chaos.asymmetric_degradation(seed=S, n=N)``.
    """
    if n < 16:
        raise ValueError(
            f"asymmetric_degradation needs n >= 16 (got {n}) — the "
            f"degraded range must stay a strict minority")
    if params is None:
        from scalecube_cluster_tpu_torch.chaos.campaign import campaign_config
        params = swim.SwimParams.from_config(campaign_config(), n_members=n)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x11F6]))
    q = asymmetric_degraded_range(n)            # degraded observer range
    ops = (
        Brownout(src=(q, n), dst=(0, q), peak_loss=float(peak_loss),
                 peak_delay_ms=float(peak_delay_ms),
                 from_round=0, ramp_rounds=12,
                 hold_rounds=int(hold_rounds), steps=3),
        FlappingLink(src=int(rng.integers(q, n)),
                     dst=int(rng.integers(0, q)),
                     from_round=int(rng.integers(0, 9)),
                     n_cycles=4, down_rounds=6, up_rounds=10),
    )
    ends = [op.disruption(n, 10 ** 9)[1] for op in ops]
    horizon = _quantize_horizon(
        max(ends) + completeness_bound(params, n) // 2 + 24)
    return Scenario(name=f"asym-deg-{seed}-n{n}", n_members=n,
                    horizon=horizon, ops=ops, seed=seed)


def alarm_drill_scenario(seed: int, n: int = 32,
                         pulse_loss: float = 0.6,
                         onset_round: int = 128,
                         pulse_rounds: int = 128,
                         cool_rounds: int = 128) -> Scenario:
    """Seeded square-pulse fault for the live-alarm drill
    (bench.py --alarms): a sharp-edged inbound :class:`LinkLoss` window
    on the drill range's links.

    During ``[onset_round, onset_round + pulse_rounds)`` messages from
    the healthy majority INTO ids ``[0, q)`` (``q =``
    :func:`asymmetric_degraded_range` — the lifeguard drill's rack)
    drop at ``pulse_loss``; outside the pulse the network is pristine.
    A square pulse on purpose, where :func:`asymmetric_degradation`
    ramps: the drill measures DETECTION LAG against a known onset
    round, so the fault edge must be one round wide — a ramp would
    smear the very quantity under test.  Probes of the range fail on
    the ping hop, false suspicions onset at the pulse edge and stop at
    the heal, which is exactly the breach/resolve timeline the alarm's
    pending→firing→resolved machine must track.

    The horizon leaves ``cool_rounds`` after the heal so the resolve
    hysteresis has clear windows to consume.  Pure in its arguments
    (the pulse is deterministic; ``seed`` seeds the RUN key and names
    the repro): ``chaos.alarm_drill_scenario(seed=S, n=N)``.
    """
    if n < 16:
        raise ValueError(
            f"alarm_drill_scenario needs n >= 16 (got {n}) — the "
            f"pulsed range must stay a strict minority")
    if pulse_rounds < 1 or cool_rounds < 1:
        raise ValueError(
            f"alarm_drill_scenario needs pulse_rounds >= 1 and "
            f"cool_rounds >= 1 (got {pulse_rounds}, {cool_rounds}) — "
            f"no pulse means no breach, no cooldown means no resolve")
    q = asymmetric_degraded_range(n)
    ops = (
        LinkLoss(src=(q, n), dst=(0, q), loss=float(pulse_loss),
                 from_round=int(onset_round),
                 until_round=int(onset_round + pulse_rounds)),
    )
    return Scenario(name=f"alarm-drill-{seed}-n{n}", n_members=n,
                    horizon=int(onset_round + pulse_rounds + cool_rounds),
                    ops=ops, seed=seed)


def blame_drill_scenario(seed: int, n: int = 32,
                         victim: int = 3, observer: int = 11,
                         onset_round: int = 32,
                         pulse_rounds: int = 96,
                         cool_rounds: int = 96) -> Scenario:
    """Seeded single-fault drill for the provenance blame engine
    (bench.py --blame): ONE asymmetric faulty link, one victim.

    During ``[onset_round, onset_round + pulse_rounds)`` every message
    from ``victim`` TO ``observer`` drops (``loss=1.0`` on that one
    directed link) while every other link — including the reverse
    direction — stays pristine.  The observer's direct probes of the
    victim reach it fine but the acks never come back, so the observer
    (and ONLY the observer, first-hand) times the victim out and
    starts the false suspicion; everyone else learns of it second-hand
    via piggyback gossip, and the victim — alive the whole time —
    refutes with an incarnation bump that spreads through third
    parties.  That is exactly the asymmetry the blame report must see
    through: ``origin_observer`` must name the observer even though
    most of the cluster heard the rumor from a gossip carrier.

    Run it with ``ping_req_members=0`` (the bench does) so the
    first-hand sighting is unambiguously ``fd_direct`` — a ping-req
    proxy probing on the observer's behalf would get an ack (the
    victim→proxy link is clean) and mask the fault.  The pulse heals
    after ``pulse_rounds`` and the horizon leaves ``cool_rounds`` for
    the refutation to settle.  Pure in its arguments (the fault is
    deterministic; ``seed`` seeds the RUN key and names the repro):
    ``chaos.blame_drill_scenario(seed=S, n=N)``.
    """
    if n < 16:
        raise ValueError(
            f"blame_drill_scenario needs n >= 16 (got {n}) — the "
            f"rumor needs a crowd of second-hand observers")
    if not (0 <= victim < n and 0 <= observer < n) or victim == observer:
        raise ValueError(
            f"blame_drill_scenario needs distinct victim/observer ids "
            f"in [0, {n}) (got {victim}, {observer})")
    if pulse_rounds < 1 or cool_rounds < 1:
        raise ValueError(
            f"blame_drill_scenario needs pulse_rounds >= 1 and "
            f"cool_rounds >= 1 (got {pulse_rounds}, {cool_rounds}) — "
            f"no pulse means no suspicion, no cooldown means no "
            f"refutation window")
    ops = (
        LinkLoss(src=int(victim), dst=int(observer), loss=1.0,
                 from_round=int(onset_round),
                 until_round=int(onset_round + pulse_rounds)),
    )
    return Scenario(name=f"blame-drill-{seed}-n{n}", n_members=n,
                    horizon=int(onset_round + pulse_rounds + cool_rounds),
                    ops=ops, seed=seed)


def churn_growth_scenario(seed: int, n: int = 32, waves: int = 3,
                          wave_size: int = 2, join_wave_size: int = 3,
                          join_lag: Optional[int] = None,
                          params: Optional["swim.SwimParams"] = None
                          ) -> Scenario:
    """The canonical NET-POSITIVE arrival storm — the ``bench.py
    --churn`` A/B workload and the open-world monitor tests run this
    one schedule, so the growth arithmetic cannot drift between them.
    (The oracle mid-run-join cross-validation runs a separate QUIESCED
    scare-free schedule instead — ``campaign.cross_validate_churn``
    rejects network ops, and mid-suspicion joins make the two layers'
    REMOVED key sets legitimately diverge, so this adversarial storm
    is validated by the invariant monitor, not by oracle replay.)

    ``waves`` crash waves of ``wave_size`` kill members permanently
    while each wave admits ``join_wave_size`` NEW identities
    (``join_wave_size > wave_size`` ⇒ net growth of
    ``waves * (join_wave_size - wave_size)`` members, drawn from a
    pre-dead arrivals pool of exactly that size — every free slot is
    consumed and every crashed slot recycled).  ``join_lag`` defaults
    to 10 rounds: joins land MID-SUSPICION of the previous occupant —
    observers still hold its ALIVE/SUSPECT records and its tombstones
    mature (hot) only after the new member is already in, the
    adversarial recycling window where naive slot reuse demonstrably
    shadows, kills and resurrects identities while the epoch guard
    (plus its dead_suppress_rounds interplay) must hold.

    Each wave victim additionally suffers a pre-death SCARE — a brief
    inbound blockade that gets it falsely suspected, healed, and
    self-refuted — so the occupants die at incarnation >= 1, the
    operationally normal state of a long-lived member.  This is what
    makes naive reuse's resurrection OBSERVABLE: the dead identity's
    ALIVE@inc>=1 records outrank the new member's ALIVE@0 on an
    epoch-blind wire (chaos/monitor.NO_RESURRECTION's incarnation
    forensics), while the epoch guard drops them outright.

    Pure in ``(seed, n)``: one-line repro
    ``chaos.churn_growth_scenario(seed=S, n=N)``.
    """
    if n < 16:
        raise ValueError(
            f"churn_growth_scenario needs n >= 16 (got {n}) — the storm "
            f"pools must stay a minority of the cluster")
    if join_wave_size <= wave_size:
        raise ValueError(
            f"net-positive growth needs join_wave_size ({join_wave_size})"
            f" > wave_size ({wave_size})")
    if params is None:
        from scalecube_cluster_tpu_torch.chaos.campaign import campaign_config
        params = swim.SwimParams.from_config(campaign_config(), n_members=n)
    n_pool = waves * wave_size
    n_arrivals = waves * (join_wave_size - wave_size)
    if n_pool + n_arrivals > n - 2:
        raise ValueError(
            f"storm pools ({n_pool} crash + {n_arrivals} arrival slots) "
            f"leave fewer than 2 stable members at n={n}")
    if join_lag is None:
        join_lag = 10
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x10E6]))
    pool = [int(x) for x in rng.permutation(n)]
    nodes = tuple(pool[:n_pool])
    arrivals = tuple(pool[n_pool:n_pool + n_arrivals])
    wave_every = max(int(join_lag) + 2, 16)
    # Scare geometry: blockade ends >= ~suspicion_rounds/2 before the
    # crash so the refutation lands and goes cold pre-death, and starts
    # late enough that the suspicion cannot mature DEAD mid-scare.
    scare_len = 6
    scare_gap = min(params.suspicion_rounds - scare_len - 2, 14)
    scare_lead = scare_len + max(scare_gap, 6)
    storm = ChurnStorm(
        nodes=nodes, wave_size=wave_size,
        start_round=scare_lead + int(rng.integers(4, 11)),
        wave_every=wave_every,
        join_wave_size=join_wave_size, join_lag=int(join_lag),
        arrivals=arrivals,
    )
    scares = []
    for w in range(storm.n_waves):
        at = storm.start_round + w * wave_every
        for v in nodes[w * wave_size:(w + 1) * wave_size]:
            scares.append(LinkLoss(
                src=(0, n), dst=v, loss=1.0,
                from_round=at - scare_lead,
                until_round=at - scare_lead + scare_len,
            ))
    last_join = (storm.start_round + (storm.n_waves - 1) * wave_every
                 + storm.join_lag)
    horizon = _quantize_horizon(
        last_join + completeness_bound(params, n) + 24)
    return Scenario(name=f"churn-growth-{seed}-n{n}", n_members=n,
                    horizon=horizon, ops=(*scares, storm), seed=seed)


# --------------------------------------------------------------------------
# Seeded campaign generation
# --------------------------------------------------------------------------


def _quantize_horizon(rounds: int) -> int:
    return -(-rounds // _HORIZON_QUANTUM) * _HORIZON_QUANTUM


def generate_scenario(seed: int, n: int = 32, severity: str = "moderate",
                      params: Optional["swim.SwimParams"] = None
                      ) -> Scenario:
    """One scenario, a PURE function of (seed, n, severity) — the
    campaign repro unit.  ``params`` only shapes the completeness/
    horizon arithmetic (defaults to the campaign timing preset at n;
    chaos/campaign.campaign_config)."""
    if severity not in SEVERITIES:
        raise ValueError(f"unknown severity {severity!r} "
                         f"(choose from {SEVERITIES})")
    if n < 16:
        raise ValueError(f"campaign scenarios need n >= 16 (got {n})")
    if params is None:
        from scalecube_cluster_tpu_torch.chaos.campaign import campaign_config
        params = swim.SwimParams.from_config(campaign_config(), n_members=n)
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, SEVERITIES.index(severity)]))
    pool = [int(x) for x in rng.permutation(n)]
    bound = completeness_bound(params, n)
    revive_down = int(2 * params.suspicion_rounds + 24)

    def take(k):
        out, pool[:] = pool[:k], pool[k:]
        return out

    ops, kinds = [], []

    def add(kind, op):
        kinds.append(kind)
        ops.append(op)

    def op_crash():
        add("crash", Crash(take(1)[0], at_round=int(rng.integers(0, 11))))

    def op_crash_revive():
        at = int(rng.integers(0, 9))
        add("crash_revive",
            Crash(take(1)[0], at_round=at, until_round=at + revive_down))

    def op_leave():
        add("leave", Leave(take(1)[0], at_round=int(rng.integers(2, 13))))

    def op_flap():
        s, d = take(2)
        add("flap", FlappingLink(s, d, from_round=int(rng.integers(0, 9)),
                                 n_cycles=3, down_rounds=4, up_rounds=6))

    def op_burst(permanent=True):
        sz = int(rng.integers(2, 4))
        at = int(rng.integers(2, 11))
        until = INT32_MAX if permanent else at + revive_down
        add("burst", CrashBurst(tuple(take(sz)), at_round=at,
                                until_round=until))

    def op_churn(permanent):
        nodes = tuple(take(4))
        add("churn", ChurnStorm(nodes, wave_size=2,
                                start_round=int(rng.integers(2, 7)),
                                wave_every=int(rng.integers(6, 13)),
                                down_rounds=0 if permanent else revive_down))

    def op_churn_arrivals():
        # Net-positive arrival storm: 2 waves kill 2 + 2 and admit
        # 3 + 3 new identities (one-slot growth per wave from a
        # pre-dead arrivals pool) — the open-world severity rung.
        # Joins land as the previous occupants' tombstones mature
        # (the adversarial recycling window, churn_growth_scenario).
        nodes = tuple(take(4))
        arrivals = tuple(take(2))
        lag = int(params.suspicion_rounds) + int(rng.integers(4, 13))
        add("churn_arrivals", ChurnStorm(
            nodes, wave_size=2,
            start_round=int(rng.integers(2, 7)),
            wave_every=lag + int(rng.integers(2, 7)),
            join_wave_size=3, join_lag=lag, arrivals=arrivals))

    def op_brownout():
        half = n // 2
        add("brownout", Brownout(
            src=(0, half), dst=(half, n),
            peak_loss=float(rng.choice([0.3, 0.5])),
            from_round=int(rng.integers(0, 9)),
            ramp_rounds=12, hold_rounds=10))

    loss = 0.0
    if severity == "mild":
        rng.choice([op_crash, op_crash_revive, op_leave, op_flap])()
    elif severity == "moderate":
        loss = float(rng.choice([0.0, 0.02, 0.05]))
        menu = [lambda: op_burst(bool(rng.integers(0, 2))),
                lambda: op_churn(bool(rng.integers(0, 2))),
                op_flap, op_brownout, op_leave]
        for f in rng.choice(len(menu), size=2, replace=False):
            menu[int(f)]()
    else:                                           # severe
        loss = float(rng.choice([0.05, 0.1]))
        add("partition", RollingPartition(
            from_round=0, phase_rounds=16, n_cycles=2,
            rotate=int(rng.integers(0, n))))
        op_churn(permanent=bool(rng.integers(0, 2)))
        (op_brownout if rng.integers(0, 2) else op_flap)()

    # Open-world rung: moderate/severe tiers additionally emit
    # a net-positive arrival storm for half the seeds.  The draw TRAILS
    # every existing one, so the ops a pre-open-world seed generated are
    # unchanged — the tier grows, it does not reshuffle (the campaign
    # repro contract: generate_scenario stays pure in (seed, n,
    # severity), and historical seeds keep their historical faults).
    if severity != "mild" and n >= 24 and rng.integers(0, 2):
        op_churn_arrivals()

    # Metadata rung: every tier additionally pushes one config
    # word for half the seeds — a live owner (drawn from the untouched
    # remainder of the pool) flips a key mid-faults, so the campaign
    # invariant monitor exercises the KV plane under the tier's own
    # chaos.  The draw TRAILS every existing one including the arrival
    # coin above (the open-world rung's rule: historical seeds keep their
    # historical ops — the tier grows, it does not reshuffle).
    if rng.integers(0, 2):
        add("config_push", ConfigPush(
            node=take(1)[0], key=0,
            value=int(rng.integers(1, metadata.MD_VALUE_MAX + 1)),
            at_round=int(rng.integers(4, 17))))

    # Horizon: every fault/disruption resolved, plus the completeness
    # bound and a margin — quantized so campaigns share compilations.
    ends = [0]
    for op in ops:
        d = op.disruption(n, 10 ** 9)
        if d is not None and d[1] < INT32_MAX:
            ends.append(d[1])
        for attr in ("at_round", "until_round", "start_round"):
            v = getattr(op, attr, None)
            if v is not None and v < INT32_MAX:
                ends.append(int(v))
        if isinstance(op, ChurnStorm):
            ends.append(op.start_round
                        + op.n_waves * op.wave_every + op.down_rounds
                        + op.join_lag)
    horizon = _quantize_horizon(max(ends) + bound + 24)
    name = f"{severity}-{seed}-" + "+".join(kinds)
    return Scenario(name=name, n_members=n, horizon=horizon,
                    ops=tuple(ops), loss_probability=loss, seed=seed,
                    severity=severity)


def generate_campaign(seed: int, n_scenarios: int, n: int = 32,
                      severities: Sequence[str] = SEVERITIES) -> list:
    """``n_scenarios`` scenarios cycling through ``severities``;
    scenario i is ``generate_scenario(seed + i, n, severities[i %
    len(severities)])`` — every member is its own one-line repro."""
    return [
        generate_scenario(seed + i, n=n,
                          severity=severities[i % len(severities)])
        for i in range(n_scenarios)
    ]


def generate_fuzz_campaign(seed: int, seeds_per_tier: int, n: int = 32,
                           severities: Sequence[str] = SEVERITIES
                           ) -> list:
    """The mega-campaign form of :func:`generate_campaign`:
    ``seeds_per_tier`` scenarios PER severity tier, tier-cycled so
    scenario i's generation seed stays ``seed + i`` — the run-seed
    alignment that keeps every verdict row's repro line exact when a
    campaign runner assigns run seed ``seed + i`` by position
    (chaos/campaign.run_campaign / run_campaign_vmapped).

    By construction ``generate_fuzz_campaign(seed, k)`` ==
    ``generate_campaign(seed, k * len(severities))``; the name states
    the scaling contract: thousands of seeds per tier, quantized
    horizons and padded rule widths collapsing them into a handful of
    compile buckets, one vmapped device program per bucket
    (chaos/campaign.build_buckets)."""
    return generate_campaign(seed, seeds_per_tier * len(severities),
                             n=n, severities=severities)
