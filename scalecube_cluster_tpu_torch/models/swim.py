"""The SWIM round on PyTorch tensors: failure detection, gossip, SYNC,
merge, suspicion timers.

Counterpart of ``scalecube_cluster_tpu/models/swim.py`` for both
delivery modes, in both the focal shape (N
members x K tracked subjects) and full view (K == N): ``"scatter"`` (the
default), where every sender draws its own uniform targets and the
inbox is max-folded by scatter, and ``"shift"``, where each channel
shares one cyclic offset a round.
State is [N, K] per observer row and subject column (``SwimState``); the
world holds the ground truth and the fault schedule (``SwimWorld``).

The network model is the reference's: per-link fault rules
(``LinkFaults``, ``SwimWorld.with_link_fault`` / ``with_block``: loss
and mean delay per sender/receiver id range and round window, the last
matching rule winning), a default loss and mean delay
(``loss_probability``, ``mean_delay_ms``), delayed delivery into a ring
of ``max_delay_rounds + 1`` slots, seed-gated contacts and the joiner
<-> seed round trip of a seeded cold start (``with_seeds``, full view),
and user gossips riding the gossip channels (``n_user_gossips``,
``with_spread``).

Three layouts besides the wide one (int8 status, int32 inc/spread/
deadline, int32 wire keys), as in the reference:

- ``int16_wire``: the wide carry with int16 wire keys
  (``records.merge_key16``, incarnation cap 8191);
- ``compact_carry``: an int16 inc, int8 remaining-spread and int16
  remaining-deadline carry (``kernels/carry.py`` decodes it at the start
  of a round and encodes it at the end), with the int16 wire;
- ``compact_carry`` + ``wire24``: the compact carry with 24-bit keys in
  an int32 word (incarnation cap 32767, the carry's).

Each is trace-identical to the wide layout while incarnations stay
below its cap.  The delay ring holds keys in the wire dtype; the codec
does not touch it.

Each round (``swim_tick``; under ``k_block``, ``_tick_shift_blocked``
runs steps 0 and 3-6 column block by column block):

0. ``kernels/carry.carry_decode`` (compact carry only);
1. ``_round_context``: liveness and partition slices, the self-record
   pin, user-gossip injections, the FD and SYNC phase gates;
2. the FD probe chains and their SUSPECT verdicts (``_fd_phase``;
   scatter: ``_scatter_fd_phase``);
3. delivery, max-folded into one inbox of the wire format's dtype with
   the ring's due slot (later arrivals binned into the ring) and the
   joiner <-> seed exchange: shift (``_delivery_phase``) sends F gossip
   channels, the refute push and the SYNC channel over cyclic shifts;
   scatter (``_scatter_send_phase``, ``_scatter_deliver``) scatters
   each sender's rows to its drawn gossip and SYNC targets (the refute
   push redirects the SYNC target), with the ALIVE flags in the keys
   (``fused_wire``, the default) or in a second buffer;
4. ``_merge_and_timers``: the CUDA kernel ``kernels/merge.py``, one
   instance per wire format (its plain PyTorch version for CPU tensors),
   then the user-gossip lanes;
5. ``_round_metrics``: the per-round observability counters;
6. ``kernels/carry.carry_encode`` (compact carry only).

Each phase runs under a ``torch.profiler.record_function`` range
(``swim.carry``, ``swim.context``, ``swim.fd``, ``swim.delivery``,
``swim.merge``, ``swim.metrics``, and ``swim.metadata`` under the
metadata plane), which ``profile_round.py`` reads.

Randomness comes from a ``RoundDraws`` (shift) or ``ScatterDraws``
(scatter) per round (``ops/prng.py``): ``run(..., draws=None)`` uses the
port's ``TorchDraws``; any callable ``round_idx -> draws`` can stand in,
which is how the tests feed the reference's own draws and hold the state
and metrics bit-identical.  Which draws a round takes follows from
static facts of the params and world (``prng.DrawFacts``).

Full view has a K-tiled round for capacity runs (``k_block = Kb``,
``_tick_shift_blocked``, the reference's): shift delivery, no delay
ring, no seed-gated contacts.  The carry never leaves its stored layout:
each [N, Kb] column block is decoded, pinned, sent, delivered, merged and
encoded in turn, and written into an output carry allocated once a round,
so a round holds two carries plus [N, Kb] transients instead of the
unblocked round's [N, K] temporaries.  It gives the unblocked round's
states and metrics exactly.

``link_counters`` adds the per-sender wire counters ``sent_by_node`` /
``lost_by_node`` [N] to each round's metrics (both delivery modes), and
``node_snapshot`` is the host-side digest of one observer row.

Three tick-level planes, each off by default and then leaving the round
and its draws as they are, run in all three tick bodies:

- ``sync_interval`` (``models/sync.py``): every ``sync_interval`` rounds
  the paired full-table exchange at a shared offset, two more channels
  delivered the same round (metric ``messages_anti_entropy``);
- ``lhm_max`` (``models/lifeguard.py``): the ``lhm`` [N] lane, the
  probe gate and health-scaled budgets in the FD phase, per-row armed
  suspicion rounds in the merge kernel, and the refute push on the ack
  path whatever ``sync_every`` says;
- ``dead_suppress_rounds``: the merge kernel's suppression window, in
  which a fresh tombstone does not reopen.

The open-world plane (``open_world``, the reference's slot-recycling
lane) runs in all three tick bodies and every layout: a join scheduled
with ``SwimWorld.with_join`` resets its slot's row to a cold start at
the start of its round (``_apply_joins``), and with the epoch guard on
(``epoch_guard``, the default) every wire key carries the record's
identity epoch, the ``epoch`` lane [N, K] holds each observer's belief,
and the merge kernel drops a dead identity's records.  With
``epoch_guard=False`` (the naive-reuse control) the joins run on the
epoch-free wire.

The metadata KV plane (``metadata_keys``, ``models/metadata.py``, full
view only, not under ``k_block``) runs in the shift and scatter tick
bodies and every layout: the world's config pushes
(``SwimWorld.with_metadata_push``) are written at the start of their
round, after the joins (``_inject_pushes``; the schedule is read to the
host once per ``run``, ``SwimWorld.push_rows``); hot rows of the ``md``
lane ride the gossip channels, the refute push and the SYNC channel,
the full table the anti-entropy pair, same-round only, max-folded into
one buffer in ``swim.delivery``; the LWW merge against the merge
kernel's post-merge epoch lane and the ``metadata_divergent`` metric run
under their own range, ``swim.metadata``.

``run`` is the composed plane runner with no planes
(``models/compose.composed_scan``); ``run_traced`` adds the membership
event trace (``telemetry/trace.TracePlane``).  Both take ``knobs``, the
schedule values the reference lets vary as data (``Knobs.from_params``
by default; ``Knobs.for_params`` checks overrides against their
ceilings); ``models/fd.run`` is ``run`` with gossip and SYNC silenced.

The provenance knob (``provenance``, ``models/provenance.py``; no delay
ring) has every tick body expose its per-channel folded maxima beside
the combined inbox, ``dict(fd=, gossip=, sync=, ping_req=)`` in the
round's metrics under ``_provenance``, which the composed runner pops
into ``RoundCtx.provenance`` before it stacks the metrics.  The inbox is
built as with the knob off, so the states and metrics are the same.
``rounds_per_step`` is accepted and ignored: the reference's outputs are
bit-identical for any value.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from scalecube_cluster_tpu_torch import records
from scalecube_cluster_tpu_torch.kernels import carry
from scalecube_cluster_tpu_torch.kernels import merge as merge_kernel
from scalecube_cluster_tpu_torch.models import lifeguard
from scalecube_cluster_tpu_torch.models import metadata
from scalecube_cluster_tpu_torch.models import sync as sync_plane
from scalecube_cluster_tpu_torch.ops import delivery
from scalecube_cluster_tpu_torch.ops import prng
from scalecube_cluster_tpu_torch.ops import ring as ring_ops
from scalecube_cluster_tpu_torch.ops.shift import ShiftEngine

INT32_MAX = 2**31 - 1
# compact_carry: "no suspicion timer" in the int16 remaining-rounds
# encoding (decodes to INT32_MAX), and the int16 stored-incarnation
# ceiling.
_DEADLINE_NONE16 = carry.DEADLINE_NONE16
_CARRY16_INC_SAT = (1 << 15) - 1


def resolve_device(device) -> torch.device:
    """``device`` as a concrete ``torch.device``; raises if it asks for
    CUDA where there is none (pass ``device="cpu"`` to run on the CPU)."""
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    return d


# --------------------------------------------------------------------------
# Static parameters
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SwimParams:
    """Shape and schedule knobs of the round: every field of the
    reference's ``SwimParams`` with the same defaults, so ``from_config``
    calls read the same.  Millisecond knobs resolved within a round stay
    in ms."""

    n_members: int
    n_subjects: int
    fanout: int
    periods_to_spread: int
    ping_every: int
    sync_every: int
    suspicion_rounds: int
    ping_req_members: int
    ping_timeout_ms: float = 500.0
    ping_interval_ms: float = 1000.0
    mean_delay_ms: float = 0.0
    loss_probability: float = 0.0
    ping_known_only: bool = True
    per_subject_metrics: bool = True
    delivery: str = "scatter"
    round_ms: float = 200.0
    max_delay_rounds: int = 0
    compact_carry: bool = False
    int16_wire: bool = False
    wire24: bool = False
    fused_wire: bool = True
    shift_roll_payloads: bool = False
    link_counters: bool = False
    k_block: int = 0
    n_user_gossips: int = 0
    rounds_per_step: int = 1
    sync_interval: int = 0
    lhm_max: int = 0
    dead_suppress_rounds: int = 0
    open_world: bool = False
    epoch_guard: bool = True
    metadata_keys: int = 0
    provenance: bool = False

    def __post_init__(self):
        if self.delivery not in ("scatter", "shift"):
            raise ValueError(f"unknown delivery mode {self.delivery!r}")
        if self.rounds_per_step < 1:
            raise ValueError(
                f"rounds_per_step must be >= 1 (got {self.rounds_per_step})")
        for name in ("sync_interval", "lhm_max", "dead_suppress_rounds",
                     "metadata_keys", "max_delay_rounds", "k_block",
                     "n_user_gossips"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0 "
                                 f"(got {getattr(self, name)})")
        if self.provenance and self.max_delay_rounds > 0:
            raise ValueError(
                "provenance requires max_delay_rounds == 0: the delay "
                "ring folds every channel into shared per-round bins "
                "before delivery, so the winning record's channel is "
                "unrecoverable once it has been through the ring")
        if self.metadata_keys > 0:
            if not self.full_view:
                raise ValueError(
                    f"the metadata plane requires full view (n_subjects == "
                    f"n_members): column j is node j, which is what makes "
                    f"the owner's own row the table authority "
                    f"(got n_subjects={self.n_subjects}, "
                    f"n_members={self.n_members})")
            if self.k_block:
                raise ValueError(
                    "metadata_keys > 0 excludes k_block: the blocked "
                    "capacity path targets table sizes where an [N, N, M] "
                    "metadata lane is itself infeasible")
        if self.delivery == "shift" and self.ping_known_only != self.full_view:
            raise ValueError(
                f"shift delivery requires ping_known_only == full_view "
                f"(got ping_known_only={self.ping_known_only}, "
                f"n_subjects={self.n_subjects}, n_members={self.n_members})")
        if self.k_block:
            if self.delivery != "shift" or not self.full_view:
                raise ValueError(
                    f"k_block is the full-view shift-mode capacity path "
                    f"(got delivery={self.delivery!r}, n_subjects="
                    f"{self.n_subjects}, n_members={self.n_members})")
            if self.n_subjects % self.k_block != 0:
                raise ValueError(f"k_block ({self.k_block}) must divide "
                                 f"n_subjects ({self.n_subjects})")
            if self.max_delay_rounds != 0 or self.link_counters:
                raise ValueError("k_block supports max_delay_rounds=0 and "
                                 "link_counters=False only (capacity path)")
        if self.n_members < 2:
            raise ValueError(f"{self.delivery} delivery needs n_members >= 2 "
                             f"(a sender needs a target other than itself)")
        if not 1 <= self.n_subjects <= self.n_members:
            raise ValueError(f"n_subjects must be in [1, n_members] "
                             f"(got {self.n_subjects})")
        if self.wire24 and not self.compact_carry:
            raise ValueError(
                "wire24 is the compact-carry headroom rung: it widens the "
                "wire key while the stored table stays int16 (set "
                "compact_carry=True, or drop wire24)")
        if self.wire24 and self.int16_wire:
            raise ValueError("wire24 and int16_wire are distinct rungs of "
                             "the wire-format ladder; pick one")
        if self.compact_carry:
            if self.periods_to_spread + 1 > 127:
                raise ValueError(
                    f"compact_carry stores remaining spread rounds as int8; "
                    f"periods_to_spread={self.periods_to_spread} exceeds 126")
            if self.suspicion_rounds >= _DEADLINE_NONE16 - 1:
                raise ValueError(
                    f"compact_carry stores remaining suspicion rounds as "
                    f"int16; suspicion_rounds={self.suspicion_rounds} "
                    f"exceeds 32765")
            if (self.lhm_max > 0 and self.suspicion_rounds * self.lhm_max
                    >= _DEADLINE_NONE16 - 1):
                raise ValueError(
                    f"compact_carry stores remaining suspicion rounds as "
                    f"int16 and lhm_max arms deadlines up to "
                    f"suspicion_rounds * lhm_max = "
                    f"{self.suspicion_rounds * self.lhm_max} rounds out "
                    f"(exceeds 32765)")
            if self.dead_suppress_rounds >= _DEADLINE_NONE16 - 1:
                raise ValueError(
                    f"compact_carry stores the dead-suppression expiry in "
                    f"the int16 deadline lane; dead_suppress_rounds="
                    f"{self.dead_suppress_rounds} exceeds 32765")

    @property
    def compact_wire(self) -> bool:
        """The wire is int16 (``records.merge_key16``): chosen by
        ``int16_wire`` or implied by ``compact_carry``, unless ``wire24``
        widens it back to an int32 word."""
        return (self.compact_carry or self.int16_wire) and not self.wire24

    @property
    def wire_format(self) -> delivery.WireFormat:
        """The active rung of the wire-format ladder."""
        if self.wire24:
            return delivery.WIRE24
        return delivery.WIRE16 if self.compact_wire else delivery.WIDE

    @property
    def full_view(self) -> bool:
        return self.n_subjects == self.n_members

    @property
    def epoch_bits(self) -> int:
        """Width of the wire keys' identity-epoch field: the wire
        format's (6 wide, 4 wire24, 2 wire16) with the open-world plane
        and its epoch guard on, else 0 (no lane, the epoch-free keys;
        the naive-reuse control runs that wire)."""
        if not (self.open_world and self.epoch_guard):
            return 0
        return self.wire_format.epoch_bits

    @staticmethod
    def from_config(config, n_members: int, n_subjects: Optional[int] = None,
                    loss_probability: float = 0.0, mean_delay_ms: float = 0.0,
                    **overrides) -> "SwimParams":
        sim = config.to_sim(n_members)
        k = n_members if n_subjects is None else n_subjects
        kwargs = dict(
            n_members=n_members,
            n_subjects=k,
            fanout=sim.gossip_fanout,
            periods_to_spread=sim.periods_to_spread,
            ping_every=sim.ping_every,
            sync_every=sim.sync_every,
            suspicion_rounds=sim.suspicion_rounds,
            ping_req_members=sim.ping_req_members,
            ping_timeout_ms=float(config.ping_timeout),
            ping_interval_ms=float(config.ping_interval),
            mean_delay_ms=mean_delay_ms,
            loss_probability=loss_probability,
            ping_known_only=(k == n_members),
            round_ms=float(config.gossip_interval),
        )
        kwargs.update(overrides)
        return SwimParams(**kwargs)


@dataclasses.dataclass(frozen=True)
class Knobs:
    """The schedule values the reference lets vary as data (its traced
    sweep axes), here plain host numbers: the float knobs as float32
    values, the others as int32 values, as the reference stores them.

    The three newer knobs default to ``None``, meaning "the params
    value", so a five-field ``Knobs(...)`` builds and runs as the
    reference's does.  :meth:`from_params` takes every value from the
    params; :meth:`for_params` checks overrides against their ceilings
    first.  Each knob with a ceiling is also clipped where it is used
    (``knob_dead_suppress``, ``knob_lhm_cap``, ``knob_probe_budgets``)."""

    loss_probability: float
    suspicion_rounds: int
    ping_every: int
    sync_every: int
    fanout: int
    dead_suppress_rounds: Optional[int] = None
    lhm_max: Optional[int] = None
    ping_timeout_ms: Optional[float] = None

    @staticmethod
    def from_params(params: SwimParams) -> "Knobs":
        return Knobs(**{name: _coerce_knob(name, getattr(params, name))
                        for name in _KNOB_FIELDS})

    @staticmethod
    def for_params(params: SwimParams, **overrides) -> "Knobs":
        """:meth:`from_params` plus checked overrides (the reference's
        ``Knobs.for_params``): an unknown name, or a value outside its
        knob's ceiling, raises ``ValueError`` with the reference's
        message.  ``suspicion_rounds`` has no ceiling: the weakened
        coverage arm sweeps it above the params value (under
        ``compact_carry`` a deadline more than 32,765 rounds out is
        stored as no timer, as in the reference)."""
        unknown = sorted(set(overrides) - set(_KNOB_FIELDS))
        if unknown:
            raise ValueError(f"unknown Knobs field(s) {unknown}; "
                             f"sweepable knobs are {sorted(_KNOB_FIELDS)}")
        ceilings = {
            "fanout": (0, params.fanout,
                       "the static channel count params.fanout"),
            "ping_every": (0, None, "probe cadence must be >= 0"),
            "sync_every": (0, None, "SYNC cadence must be >= 0"),
            "loss_probability": (0.0, 1.0, "a probability"),
            "dead_suppress_rounds": (
                0, params.dead_suppress_rounds,
                "the params window (the int16 deadline-lane ceiling "
                "was validated against the params value; size the "
                "params field as the grid maximum and sweep below)"),
            "lhm_max": (
                1, params.lhm_max,
                "the static LHM cap (lane shape + TIMER_BOUND ceiling)"),
            "ping_timeout_ms": (
                0.0, params.ping_interval_ms,
                "params.ping_interval_ms (the indirect probe budget "
                "is the complement and must stay >= 0)"),
        }
        for name, val in overrides.items():
            if name not in ceilings:
                continue
            lo, hi, why = ceilings[name]
            # The value as the reference sees it: a Python float becomes
            # float32, an int int32.
            v = float(np.asarray(
                val, np.float32 if isinstance(val, float) else None))
            if (lo is not None and v < lo) or (hi is not None and v > hi):
                raise ValueError(
                    f"Knobs.{name}={v:g} outside [{lo}, {hi}] — "
                    f"ceiling: {why}")
        return dataclasses.replace(
            Knobs.from_params(params),
            **{name: _coerce_knob(name, val)
               for name, val in overrides.items()})


_KNOB_FIELDS = ("loss_probability", "suspicion_rounds", "ping_every",
                "sync_every", "fanout", "dead_suppress_rounds", "lhm_max",
                "ping_timeout_ms")
_FLOAT_KNOBS = ("loss_probability", "ping_timeout_ms")


def _coerce_knob(name: str, value):
    """A knob value in the reference's dtype: float32 for the two float
    knobs, int32 for the others (a float given for an int knob is cut
    toward zero, as ``jnp.asarray(v, jnp.int32)`` does)."""
    if name in _FLOAT_KNOBS:
        return float(np.float32(value))
    return int(np.asarray(value).astype(np.int32))


def knob_dead_suppress(kn: Knobs, params: SwimParams) -> int:
    """The suppression window: the knob, capped at the params' window
    (the int16 deadline lane was checked against that); the params
    value when the knob is None."""
    if kn.dead_suppress_rounds is None:
        return params.dead_suppress_rounds
    return min(kn.dead_suppress_rounds, params.dead_suppress_rounds)


def knob_lhm_cap(kn: Knobs, params: SwimParams) -> int:
    """The LHM clamp cap: the knob clipped into [1, params.lhm_max]; the
    params value when the knob is None."""
    if kn.lhm_max is None:
        return params.lhm_max
    return min(max(kn.lhm_max, 1), params.lhm_max)


def knob_probe_budgets(kn: Knobs, params: SwimParams) -> Tuple[float, float]:
    """``(direct, indirect)`` ms budgets of the FD probe: the direct-ping
    timeout clipped into [0, ping_interval_ms] and the rest of the
    interval, as the reference computes them.  The knob path clips and
    subtracts in float32; with the knob None the params' Python floats
    are subtracted in float64 and rounded to float32 where they are
    compared, as the reference's weakly typed scalars are.  Both values
    are exact in float32 on the knob path."""
    if kn.ping_timeout_ms is None:
        pt = params.ping_timeout_ms
        return pt, params.ping_interval_ms - pt
    interval = np.float32(params.ping_interval_ms)
    pt = min(max(np.float32(kn.ping_timeout_ms), np.float32(0.0)), interval)
    return float(pt), float(np.float32(interval - pt))


@dataclasses.dataclass
class LinkFaults:
    """Ordered per-link override rules, as [R] device tensors.

    Rule r matches messages with sender id in [src_lo[r], src_hi[r]),
    receiver id in [dst_lo[r], dst_hi[r]), during rounds
    [from_round[r], until_round[r]); the last matching rule wins.
    ``loss == 1.0`` is a blocked link; ``delay_ms`` is the mean of the
    exponential per-hop delay.  int32 bounds, float32 loss and delay.
    """

    src_lo: torch.Tensor
    src_hi: torch.Tensor
    dst_lo: torch.Tensor
    dst_hi: torch.Tensor
    from_round: torch.Tensor
    until_round: torch.Tensor
    loss: torch.Tensor
    delay_ms: torch.Tensor
    # Host copies of the round windows, and the active subsets built so
    # far (keyed by rule indices).
    _windows: tuple = dataclasses.field(init=False, repr=False,
                                        compare=False)
    _subsets: dict = dataclasses.field(init=False, repr=False,
                                       compare=False, default_factory=dict)

    ARRAYS = ("src_lo", "src_hi", "dst_lo", "dst_hi", "from_round",
              "until_round", "loss", "delay_ms")

    def __post_init__(self):
        self._windows = tuple(zip(self.from_round.tolist(),
                                  self.until_round.tolist()))

    @staticmethod
    def none(device="cpu") -> "LinkFaults":
        z = torch.zeros((0,), dtype=torch.int32, device=device)
        f = torch.zeros((0,), dtype=torch.float32, device=device)
        return LinkFaults(z, z, z, z, z, z, f, f)

    @property
    def n_rules(self) -> int:
        return self.src_lo.shape[0]

    def add(self, src, dst, loss: float, delay_ms: float = 0.0,
            from_round: int = 0, until_round: int = INT32_MAX
            ) -> "LinkFaults":
        """Append one rule.  ``src``/``dst`` are a node id or an (lo, hi)
        half-open id range.  A loss outside [0, 1], a negative delay, an
        empty id range or an inverted round window raises."""
        def rng(x):
            if isinstance(x, (tuple, list)):
                return int(x[0]), int(x[1])
            return int(x), int(x) + 1
        s_lo, s_hi = rng(src)
        d_lo, d_hi = rng(dst)
        if not 0.0 <= float(loss) <= 1.0:
            raise ValueError(
                f"loss must be a probability in [0, 1] (got {loss!r})")
        if float(delay_ms) < 0.0:
            raise ValueError(
                f"delay_ms must be non-negative (got {delay_ms!r})")
        if s_lo >= s_hi or d_lo >= d_hi:
            raise ValueError(
                f"empty id range: src=[{s_lo}, {s_hi}), dst=[{d_lo}, "
                f"{d_hi}) — a half-open range needs lo < hi, and a rule "
                f"over an empty range would silently match nothing")
        if int(from_round) >= int(until_round):
            raise ValueError(
                f"inverted round window [{from_round}, {until_round}) — "
                f"the rule would silently never apply")
        row = (s_lo, s_hi, d_lo, d_hi, int(from_round), int(until_round),
               float(loss), float(delay_ms))
        return LinkFaults(**{
            name: torch.cat([getattr(self, name),
                             getattr(self, name).new_tensor([value])])
            for name, value in zip(self.ARRAYS, row)})

    def active(self, round_idx: int) -> "LinkFaults":
        """The rules whose round window holds ``round_idx``, in their
        order (chosen on the host: the round index is a host int)."""
        idx = tuple(r for r, (lo, hi) in enumerate(self._windows)
                    if lo <= round_idx < hi)
        if idx not in self._subsets:
            pick = torch.tensor(idx, dtype=torch.long,
                                device=self.src_lo.device)
            self._subsets[idx] = LinkFaults(**{
                name: getattr(self, name).index_select(0, pick)
                for name in self.ARRAYS})
        return self._subsets[idx]


def link_eval(faults: LinkFaults, round_idx: int, src_ids, dst_ids,
              default_loss: float, default_delay_ms: float):
    """(loss probability, mean delay ms) per (src, dst) message this round,
    float32 in the broadcast shape of ``src_ids`` and ``dst_ids``.

    The delay is ``None`` when it is statically zero (no rules and a zero
    default): the FD chains then collapse to one Bernoulli draw and
    delivery skips the ring.  The rules whose window holds the round
    (``LinkFaults.active``, on the host) are evaluated in one broadcast
    against [..., A]; the last match is the largest ``match * (a + 1)``,
    and loss and delay are read from [A + 1] tables whose entry 0 holds
    the default.  The values are copied, never computed, so they equal
    the reference's unrolled ``where`` per rule."""
    shape = torch.broadcast_shapes(src_ids.shape, dst_ids.shape)
    device = src_ids.device

    def full(value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    if faults.n_rules == 0:
        return (full(default_loss),
                None if default_delay_ms == 0.0 else full(default_delay_ms))
    rules = faults.active(round_idx)
    if rules.n_rules == 0:
        return full(default_loss), full(default_delay_ms)
    s, d = src_ids[..., None], dst_ids[..., None]
    match = ((s >= rules.src_lo) & (s < rules.src_hi)
             & (d >= rules.dst_lo) & (d < rules.dst_hi))
    rank = torch.arange(1, rules.n_rules + 1, dtype=torch.int32,
                        device=device)
    last = torch.where(match, rank, 0).amax(dim=-1)

    def table(default, values):
        return torch.cat([values.new_full((1,), default), values])[last]

    return (table(default_loss, rules.loss),
            table(default_delay_ms, rules.delay_ms))


# --------------------------------------------------------------------------
# World model: ground truth + fault schedule
# --------------------------------------------------------------------------


@dataclasses.dataclass
class SwimWorld:
    """Ground-truth liveness and the fault schedule, as device tensors.

    ``down_from``/``down_until`` [N] int32: node i is crashed during
    rounds [down_from, down_until) — frozen, neither sending nor
    receiving.  ``leave_at`` [N] int32: graceful leave round (INT32_MAX =
    never).  ``partition_of`` [P, N] int8: rolling partition schedule,
    phase ``(r // partition_phase_rounds) % P`` active at round r.
    ``faults``: per-link loss/delay/block rules (:class:`LinkFaults`).
    ``seed_ids`` [S] int32: configured seed members; when non-empty, a
    full-view sender gossips and SYNCs only to members it holds live or
    to seeds, and members with ABSENT entries run the joiner <-> seed
    exchange on SYNC rounds.  ``subject_ids`` [K] int32 (distinct) and
    ``slot_of_node`` [N] int32 (slot -1 = not a tracked subject).
    ``gossip_origin``/``gossip_spread_at`` [G] int32: user gossip g is
    spread by its origin in round ``gossip_spread_at[g]`` (INT32_MAX =
    never; ``SwimParams.n_user_gossips`` = G).  ``join_at`` [N] int32:
    slot i admits a new member (a fresh identity, epoch 1) in round
    ``join_at[i]`` (INT32_MAX = never; ``with_join``, carried out under
    ``SwimParams.open_world``); None at construction means no join.
    ``md_push_at``/``md_push_node``/``md_push_key``/``md_push_value`` [P]
    int32: the config-push schedule (``with_metadata_push`` appends; run
    under ``SwimParams.metadata_keys``): at round ``md_push_at[p]`` node
    ``md_push_node[p]`` writes ``md_push_value[p]`` into its own metadata
    cell ``md_push_key[p]`` at the next version; None at construction
    means no push.
    """

    down_from: torch.Tensor
    down_until: torch.Tensor
    leave_at: torch.Tensor
    partition_of: torch.Tensor
    partition_phase_rounds: int
    faults: LinkFaults
    seed_ids: torch.Tensor
    subject_ids: torch.Tensor
    slot_of_node: torch.Tensor
    gossip_origin: torch.Tensor
    gossip_spread_at: torch.Tensor
    join_at: Optional[torch.Tensor] = None
    md_push_at: Optional[torch.Tensor] = None
    md_push_node: Optional[torch.Tensor] = None
    md_push_key: Optional[torch.Tensor] = None
    md_push_value: Optional[torch.Tensor] = None

    PUSH_FIELDS = ("md_push_at", "md_push_node", "md_push_key",
                   "md_push_value")

    def __post_init__(self):
        n = self.down_from.shape[0]
        if self.join_at is None:
            self.join_at = torch.full_like(self.down_from, INT32_MAX)
        for name in self.PUSH_FIELDS:
            if getattr(self, name) is None:
                setattr(self, name, self.down_from.new_zeros((0,)))
        ids = self.subject_ids.to("cpu", torch.int64)
        if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= n):
            raise ValueError(f"subject_ids out of range for n_members={n}")
        if torch.unique(ids).numel() != ids.numel():
            raise ValueError("subject_ids must be distinct")
        if int(self.partition_phase_rounds) < 1:
            raise ValueError("partition_phase_rounds must be >= 1")

    @property
    def device(self) -> torch.device:
        return self.down_from.device

    @property
    def n_members(self) -> int:
        return self.down_from.shape[0]

    @staticmethod
    def healthy(params: SwimParams, subject_ids=None,
                device="cuda") -> "SwimWorld":
        device = resolve_device(device)
        n, k, g = params.n_members, params.n_subjects, params.n_user_gossips
        if subject_ids is None:
            subject_ids = torch.arange(k, dtype=torch.int32)
        subject_ids = torch.as_tensor(subject_ids, dtype=torch.int32,
                                      device=device)
        slot_of_node = torch.full((n,), -1, dtype=torch.int32, device=device)
        slot_of_node[subject_ids.long()] = torch.arange(
            k, dtype=torch.int32, device=device)
        never = torch.full((n,), INT32_MAX, dtype=torch.int32, device=device)
        return SwimWorld(
            down_from=never,
            down_until=never.clone(),
            leave_at=never.clone(),
            partition_of=torch.zeros((1, n), dtype=torch.int8, device=device),
            partition_phase_rounds=1,
            faults=LinkFaults.none(device),
            seed_ids=torch.zeros((0,), dtype=torch.int32, device=device),
            subject_ids=subject_ids,
            slot_of_node=slot_of_node,
            gossip_origin=torch.arange(g, dtype=torch.int32,
                                       device=device) % max(n, 1),
            gossip_spread_at=torch.full((g,), INT32_MAX, dtype=torch.int32,
                                        device=device),
        )

    def with_spread(self, gossip_idx: int, origin,
                    at_round: int) -> "SwimWorld":
        """Schedule user gossip ``gossip_idx``'s spread at ``origin`` in
        round ``at_round`` (the origin must be alive then to spread it)."""
        if not 0 <= gossip_idx < self.gossip_origin.shape[0]:
            raise ValueError(
                f"gossip_idx {gossip_idx} out of range for n_user_gossips="
                f"{self.gossip_origin.shape[0]}")
        gossip_origin = self.gossip_origin.clone()
        gossip_spread_at = self.gossip_spread_at.clone()
        gossip_origin[gossip_idx] = int(origin)
        gossip_spread_at[gossip_idx] = int(at_round)
        return dataclasses.replace(self, gossip_origin=gossip_origin,
                                   gossip_spread_at=gossip_spread_at)

    def _node_ids(self, node, method: str) -> torch.Tensor:
        ids = torch.atleast_1d(torch.as_tensor(node, dtype=torch.int64))
        n = self.n_members
        if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= n):
            raise ValueError(f"{method}: node id(s) out of range for "
                             f"n_members={n}")
        return ids.to(self.device)

    def with_crash(self, node, at_round: int,
                   until_round: int = INT32_MAX) -> "SwimWorld":
        """Crash ``node`` (id or ids) during [at_round, until_round)."""
        ids = self._node_ids(node, "with_crash")
        down_from, down_until = self.down_from.clone(), self.down_until.clone()
        down_from[ids] = int(at_round)
        down_until[ids] = int(until_round)
        return dataclasses.replace(self, down_from=down_from,
                                   down_until=down_until)

    def with_leave(self, node, at_round: int) -> "SwimWorld":
        """Graceful leave: gossip own DEAD@inc+1 at ``at_round``, then
        down for good (overwrites any crash window of the node)."""
        ids = self._node_ids(node, "with_leave")
        leave_at = self.leave_at.clone()
        down_from, down_until = self.down_from.clone(), self.down_until.clone()
        leave_at[ids] = int(at_round)
        down_from[ids] = int(at_round) + 1
        down_until[ids] = INT32_MAX
        return dataclasses.replace(self, leave_at=leave_at,
                                   down_from=down_from, down_until=down_until)

    def with_partition_schedule(self, partition_of,
                                phase_rounds: int) -> "SwimWorld":
        partition_of = torch.as_tensor(partition_of, dtype=torch.int8,
                                       device=self.device)
        if partition_of.dim() == 1:
            partition_of = partition_of[None, :]
        return dataclasses.replace(self, partition_of=partition_of,
                                   partition_phase_rounds=int(phase_rounds))

    def with_link_fault(self, src, dst, loss: float, delay_ms: float = 0.0,
                        from_round: int = 0,
                        until_round: int = INT32_MAX) -> "SwimWorld":
        """Per-link loss/delay override for messages src -> dst only
        (``src``/``dst``: node id or (lo, hi) half-open range)."""
        return dataclasses.replace(
            self, faults=self.faults.add(src, dst, loss, delay_ms,
                                         from_round, until_round))

    def with_block(self, src, dst, from_round: int = 0,
                   until_round: int = INT32_MAX) -> "SwimWorld":
        """Block the src -> dst link (loss 1.0) during the window."""
        return self.with_link_fault(src, dst, loss=1.0,
                                    from_round=from_round,
                                    until_round=until_round)

    def with_seeds(self, seed_ids) -> "SwimWorld":
        """Configure seed members (ids range-checked)."""
        ids = self._node_ids(seed_ids, "with_seeds")
        return dataclasses.replace(self, seed_ids=ids.to(torch.int32))

    def with_join(self, slot, at_round: int) -> "SwimWorld":
        """Admit a new member (a fresh identity: epoch 1, incarnation 0,
        a cold table) into the dead ``slot`` (id or ids) at ``at_round``
        (the reference's open-world arrival schedule; run it under
        ``SwimParams.open_world``).  Raises, as the reference does, for a
        slot with no scheduled death, a join not strictly after the
        death, and a crash window that revives the old identity before
        the join.  Sets ``down_until`` to the join round."""
        ids = self._node_ids(slot, "with_join")
        at_round = int(at_round)
        cpu = ids.cpu()
        down_from, down_until = self.down_from.cpu(), self.down_until.cpu()
        fault = torch.minimum(down_from, self.leave_at.cpu())[cpu]
        live = fault >= INT32_MAX
        if bool(live.any()):
            raise ValueError(
                f"with_join: slot(s) {cpu[live].tolist()} have no scheduled "
                f"death before round {at_round}; joining a live slot would "
                f"overwrite a living member's identity (schedule "
                f"with_crash/with_leave first)")
        early = ~live & (fault >= at_round)
        if bool(early.any()):
            raise ValueError(
                f"with_join: join at round {at_round} is not strictly after "
                f"slot(s) {cpu[early].tolist()}'s scheduled death "
                f"(down_from/leave_at {fault[early].tolist()}); the old "
                f"identity must die before the new one joins")
        revived = down_until[cpu] <= at_round
        if bool(revived.any()):
            raise ValueError(
                f"with_join: slot(s) {cpu[revived].tolist()} revive the old "
                f"identity at {down_until[cpu][revived].tolist()} before the "
                f"join at {at_round}; crash it for good (or until the join "
                f"round) first")
        down_until, join_at = self.down_until.clone(), self.join_at.clone()
        down_until[ids] = at_round
        join_at[ids] = at_round
        return dataclasses.replace(self, down_until=down_until,
                                   join_at=join_at)

    def with_metadata_push(self, node, key: int, value: int,
                           at_round: int) -> "SwimWorld":
        """Append a config push: ``node`` writes ``value`` into its own
        metadata cell ``key`` at ``at_round`` (the reference's
        ``Cluster.updateMetadata``; ``SwimParams.metadata_keys`` must
        cover ``key`` for the push to write).  Raises, as the reference
        does, for more than one node, a negative key or round, and a value
        outside the 10-bit payload field."""
        ids = self._node_ids(node, "with_metadata_push")
        if ids.numel() != 1:
            raise ValueError(
                "with_metadata_push schedules ONE push per call (a push "
                "is one owner-local write; compose calls for fleets)")
        key, value, at_round = int(key), int(value), int(at_round)
        if key < 0:
            raise ValueError(f"with_metadata_push: key {key} must be >= 0")
        if not 0 <= value <= metadata.MD_VALUE_MAX:
            raise ValueError(
                f"with_metadata_push: value {value} outside the "
                f"{metadata.MD_VALUE_BITS}-bit payload field "
                f"[0, {metadata.MD_VALUE_MAX}]")
        if at_round < 0:
            raise ValueError(
                f"with_metadata_push: at_round {at_round} must be >= 0")
        row = (at_round, int(ids[0]), key, value)
        return dataclasses.replace(self, **{
            name: torch.cat([getattr(self, name),
                             getattr(self, name).new_tensor([v])])
            for name, v in zip(self.PUSH_FIELDS, row)})

    def push_rows(self) -> Dict[int, Tuple[Tuple[int, int, int], ...]]:
        """The push schedule read to the host once: each round with a
        push, mapped to its ``(node, key, value)`` in schedule order."""
        out = {}
        for at, node, key, value in zip(
                *(getattr(self, name).tolist() for name in self.PUSH_FIELDS)):
            out.setdefault(at, []).append((node, key, value))
        return {r: tuple(pushes) for r, pushes in out.items()}

    def epoch_at(self, round_idx: int) -> torch.Tensor:
        """[N] int32 ground-truth identity epoch per slot at a round: 0
        the original occupant, 1 the joined identity."""
        return (self.join_at <= round_idx).to(torch.int32)

    def joining_at(self, round_idx: int) -> torch.Tensor:
        """[N] bool: the slots whose join fires this round."""
        return self.join_at == round_idx

    def join_rows(self) -> Dict[int, torch.Tensor]:
        """The join schedule read to the host once: each round with a
        join, mapped to its joining rows (int64 on the device)."""
        at = self.join_at.cpu()
        rows = torch.nonzero(at < INT32_MAX)[:, 0]
        return {int(r): rows[at[rows] == r].to(self.device)
                for r in torch.unique(at[rows]).tolist()}

    def alive_at(self, round_idx: int) -> torch.Tensor:
        """[N] bool ground-truth liveness at a round."""
        return ~((self.down_from <= round_idx) & (round_idx < self.down_until))

    def partition_at(self, round_idx: int) -> torch.Tensor:
        """[N] partition id at a round."""
        phase = (round_idx // self.partition_phase_rounds) \
            % self.partition_of.shape[0]
        return self.partition_of[phase]


# --------------------------------------------------------------------------
# State
# --------------------------------------------------------------------------


@dataclasses.dataclass
class SwimState:
    """The carry, one row per observer.

    ``status`` [N, K] int8 and ``inc`` [N, K] int32: each observer's
    record of each subject.  ``spread_until`` [N, K] int32: gossip
    retransmission window.  ``suspect_deadline`` [N, K] int32: round a
    SUSPECT entry turns DEAD (INT32_MAX = no timer).  ``self_inc`` [N]
    int32: own incarnation.

    Under ``compact_carry`` between rounds: ``inc`` int16,
    ``spread_until`` int8 and ``suspect_deadline`` int16, the last two
    as rounds remaining from the next round (``_DEADLINE_NONE16`` = no
    timer; a stale deadline is negative).

    Delayed delivery (D = ``max_delay_rounds + 1``, or 0 when the ring is
    off): ``inbox_ring`` [D, N, K] wire keys in the wire dtype (-1 = no
    message) and ``flag_ring`` [D, N, K] int8 ALIVE flags; slot
    ``round % D`` holds the messages due in that round.  User gossips
    (G = ``n_user_gossips``): ``g_infected`` [N, G] bool possession,
    ``g_spread_until`` [N, G] int32 absolute retransmission window (in
    both carry layouts), ``g_ring`` [D or 0, N, G] bool delayed bits.
    Lifeguard (``lhm_max > 0``): ``lhm`` [N] int32 Local Health
    Multipliers in [1, lhm_max], int32 in both carry layouts.  The
    open-world plane with its epoch guard (``epoch_bits > 0``):
    ``epoch`` [N, K] each observer's belief of each subject's identity
    epoch (0 = the original occupant), int32 in the wide carry and int16
    in the compact one; [N, 0] int32 when off.  The metadata plane
    (M = ``metadata_keys``): ``md`` [N, K, M] int32 packed words
    (``models/metadata.py``) and ``md_spread`` [N, K] int32 absolute
    gossip windows, in both carry layouts.  Lanes of a feature that is
    off are zero-size.
    """

    status: torch.Tensor
    inc: torch.Tensor
    spread_until: torch.Tensor
    suspect_deadline: torch.Tensor
    self_inc: torch.Tensor
    inbox_ring: torch.Tensor
    flag_ring: torch.Tensor
    g_infected: torch.Tensor
    g_spread_until: torch.Tensor
    g_ring: torch.Tensor
    lhm: torch.Tensor
    epoch: torch.Tensor
    md: torch.Tensor
    md_spread: torch.Tensor


def ring_slots(params: SwimParams) -> int:
    """D, the delay ring's slot count (0 when delayed delivery is off)."""
    return params.max_delay_rounds + 1 if params.max_delay_rounds > 0 else 0


def empty_lanes(n: int, k: int, device, d: int = 0, g: int = 0,
                wire_dtype: torch.dtype = torch.int32) -> dict:
    """Empty delay-ring and user-gossip lanes: a ``d``-slot ring of [n, k]
    keys in ``wire_dtype`` and flags, and ``g`` user gossips held by no
    one (zero-size where ``d`` or ``g`` is 0), and zero-size ``lhm``,
    ``epoch`` and metadata lanes."""
    return dict(
        lhm=torch.zeros((0,), dtype=torch.int32, device=device),
        epoch=torch.zeros((n, 0), dtype=torch.int32, device=device),
        md=torch.zeros((n, 0, 0), dtype=torch.int32, device=device),
        md_spread=torch.zeros((n, 0), dtype=torch.int32, device=device),
        inbox_ring=torch.full((d, n, k), delivery.NO_MESSAGE,
                              dtype=wire_dtype, device=device),
        flag_ring=torch.zeros((d, n, k), dtype=torch.int8, device=device),
        g_infected=torch.zeros((n, g), dtype=torch.bool, device=device),
        g_spread_until=torch.zeros((n, g), dtype=torch.int32, device=device),
        g_ring=torch.zeros((d if g else 0, n, g), dtype=torch.bool,
                           device=device),
    )


def initial_epoch(params: SwimParams, device) -> torch.Tensor:
    """The identity-epoch lane of a fresh state: zeros (every record the
    original occupant's) [N, K], int16 in the compact carry, with the
    epoch guard on; [N, 0] int32 when ``epoch_bits`` is 0."""
    n = params.n_members
    if params.epoch_bits == 0:
        return torch.zeros((n, 0), dtype=torch.int32, device=device)
    dtype = torch.int16 if params.compact_carry else torch.int32
    return torch.zeros((n, params.n_subjects), dtype=dtype, device=device)


def initial_lanes(params: SwimParams, device) -> dict:
    """The ring, user-gossip, ``lhm``, ``epoch`` and metadata lanes of a
    fresh state under ``params``."""
    return dict(empty_lanes(params.n_members, params.n_subjects, device,
                            d=ring_slots(params), g=params.n_user_gossips,
                            wire_dtype=params.wire_format.dtype),
                lhm=lifeguard.initial_lhm(params, device),
                epoch=initial_epoch(params, device),
                **metadata.initial_lanes(params, device))


def check_lanes(state: SwimState, params: SwimParams) -> None:
    """Raise unless the ring, gossip, ``lhm``, ``epoch`` and metadata
    lanes have the shapes and dtypes ``params`` gives them."""
    for name, want in initial_lanes(params, "meta").items():
        got = getattr(state, name)
        if got.shape != want.shape or got.dtype != want.dtype:
            raise ValueError(
                f"state.{name} is {got.dtype}{tuple(got.shape)}, the params "
                f"need {want.dtype}{tuple(want.shape)} (max_delay_rounds="
                f"{params.max_delay_rounds}, n_user_gossips="
                f"{params.n_user_gossips}, lhm_max={params.lhm_max}, "
                f"epoch_bits={params.epoch_bits}, metadata_keys="
                f"{params.metadata_keys})")


def initial_state(params: SwimParams, world: SwimWorld, warm: bool = True,
                  device="cuda") -> SwimState:
    """Warm: everyone knows every subject ALIVE at incarnation 0.  Cold
    (``warm=False``): rows are ABSENT except each node's own record, hot
    for a full spread window, and the configured seeds' columns, which
    every node knows ALIVE."""
    device = resolve_device(device)
    _check_world_device(world, device)
    n, k = params.n_members, params.n_subjects
    compact = params.compact_carry
    fill = records.ALIVE if warm else records.ABSENT
    status = torch.full((n, k), fill, dtype=torch.int8, device=device)
    if not warm and world.seed_ids.shape[0] > 0:
        seed_slot = world.slot_of_node[world.seed_ids.long()]
        status[:, seed_slot[seed_slot >= 0].long()] = records.ALIVE
    # The self cells (subject_ids[c], c), written in place: no [N, K]
    # mask or wide temporary.
    self_cells = (world.subject_ids.long(),
                  torch.arange(k, dtype=torch.long, device=device))
    status[self_cells] = records.ALIVE
    spread = torch.zeros((n, k), dtype=torch.int8 if compact else torch.int32,
                         device=device)
    if not warm:
        # A full spread window from round 0 (compact: rounds remaining
        # from round 0, re-relativized every round by carry_encode).
        spread[self_cells] = params.periods_to_spread + 1
    narrow = torch.int16 if compact else torch.int32
    return SwimState(
        status=status,
        inc=torch.zeros((n, k), dtype=narrow, device=device),
        spread_until=spread,
        suspect_deadline=torch.full(
            (n, k), _DEADLINE_NONE16 if compact else INT32_MAX, dtype=narrow,
            device=device),
        self_inc=torch.zeros((n,), dtype=torch.int32, device=device),
        **initial_lanes(params, device))


def _check_world_device(world: SwimWorld, device: torch.device) -> None:
    if world.device != device:
        raise ValueError(f"world is on {world.device}, run asks for {device}")


def _is_self(world: SwimWorld, n: int) -> torch.Tensor:
    """[N, K] bool: cell (i, k) is node i's record about itself."""
    node_ids = torch.arange(n, dtype=torch.int32, device=world.device)
    return world.subject_ids[None, :] == node_ids[:, None]


# --------------------------------------------------------------------------
# The round
# --------------------------------------------------------------------------


def _apply_joins(state: SwimState, rows: torch.Tensor, round_idx: int,
                 params: SwimParams, world: SwimWorld) -> SwimState:
    """Reset the rows of the slots whose join fires this round (``rows``
    int64) to a fresh identity's cold start, in the state's stored
    layout (the reference's ``_apply_joins``): ABSENT except self and
    the configured seeds, which are ALIVE; incarnation 0; a hot
    self-announcement; no timer; ``self_inc`` 0, ``lhm`` 1, epoch beliefs
    0; the rows of the delay rings (in place: the round owns them), of
    the user-gossip lanes and of the metadata lanes cleared.  The planes
    are copied, so the input state is not modified.  Under ``k_block``
    with the compact carry the stored form is the relative one: spread
    ``periods_to_spread + 1`` and the int16 no-timer sentinel; otherwise
    the carry is wide here (decoded first)."""
    compact_layout = params.compact_carry and bool(params.k_block)
    k = state.status.shape[1]
    device = state.status.device
    cols = torch.arange(k, dtype=torch.int32, device=device)
    own = cols[None, :] == world.slot_of_node[rows][:, None]      # [J, K]
    reset = torch.full((k,), records.ABSENT, dtype=torch.int8, device=device)
    if world.seed_ids.shape[0] > 0:
        seed_slot = world.slot_of_node[world.seed_ids.long()]
        reset[seed_slot[seed_slot >= 0].long()] = records.ALIVE
    fresh_spread = (params.periods_to_spread + 1 if compact_layout
                    else round_idx + 1 + params.periods_to_spread)

    def reset_rows(lane, value):
        lane = lane.clone()
        lane[rows] = torch.as_tensor(value, device=device).to(lane.dtype)
        return lane

    new = dict(
        status=reset_rows(state.status,
                          torch.where(own, records.ALIVE, reset[None, :])),
        inc=reset_rows(state.inc, 0),
        spread_until=reset_rows(state.spread_until,
                                torch.where(own, fresh_spread, 0)),
        suspect_deadline=reset_rows(
            state.suspect_deadline,
            _DEADLINE_NONE16 if compact_layout else INT32_MAX),
        self_inc=reset_rows(state.self_inc, 0))
    if params.epoch_bits:
        new["epoch"] = reset_rows(state.epoch, 0)
    if params.lhm_max > 0:
        new["lhm"] = reset_rows(state.lhm, 1)
    if params.max_delay_rounds > 0:
        # Messages in flight to the old occupant die with it.
        state.inbox_ring[:, rows] = delivery.NO_MESSAGE
        state.flag_ring[:, rows] = 0
    if params.n_user_gossips > 0:
        new["g_infected"] = reset_rows(state.g_infected, False)
        new["g_spread_until"] = reset_rows(state.g_spread_until, 0)
        if state.g_ring.shape[0] > 0:
            state.g_ring[:, rows] = False
    if params.metadata_keys > 0:
        # A reborn slot starts with an empty table; stale words about it
        # die at the receivers through the merge's epoch gate.
        new["md"] = reset_rows(state.md, 0)
        new["md_spread"] = reset_rows(state.md_spread, 0)
    return dataclasses.replace(state, **new)


def _inject_pushes(state: SwimState, pushes, round_idx: int,
                   params: SwimParams, world: SwimWorld) -> SwimState:
    """The round's config pushes (``pushes``: its ``(node, key, value)``
    host tuples, ``SwimWorld.push_rows``) written into copies of the
    metadata lanes (``metadata.inject_pushes``): each live owner's own
    cell at the next version, stamped with its ground-truth epoch under
    the open-world plane."""
    own_epoch = world.epoch_at(round_idx) if params.open_world else None
    md, md_spread = metadata.inject_pushes(
        state.md, state.md_spread, round_idx, params, pushes, own_epoch,
        world.alive_at(round_idx))
    return dataclasses.replace(state, md=md, md_spread=md_spread)


def _round_context(state: SwimState, round_idx: int, params: SwimParams,
                   world: SwimWorld, kn: Knobs) -> dict:
    """Per-round preamble: world liveness/partition slices, the self
    pin (a node always holds itself ALIVE at self_inc; under ``k_block``
    the raw carry, pinned per block), the user-gossip
    spreads due this round, the contact gate's seed mask, the ``lhm``
    lane, the raw ``epoch`` lane and each row's ground-truth epoch
    (``own_epoch``, with the epoch guard on) and the phase gates (host
    bools: the round index and cadences are host ints, so is the
    anti-entropy exchange's ``ae_due``)."""
    n = params.n_members
    alive = world.alive_at(round_idx)
    part = world.partition_at(round_idx)
    node_ids = torch.arange(n, dtype=torch.int32, device=world.device)
    if params.k_block:
        # The blocked round pins block by block; its FD pre-pass reads the
        # raw carry (a well-formed carry holds the pinned values, and a
        # shift is never 0, so no prober targets itself).
        is_self, status, inc = None, state.status, state.inc
    else:
        is_self = _is_self(world, n)
        status = torch.where(is_self, records.ALIVE,
                             state.status).to(torch.int8)
        inc = torch.where(is_self, state.self_inc[:, None], state.inc)
    g_infected, g_spread_until = state.g_infected, state.g_spread_until
    if params.n_user_gossips > 0:
        # A spread() injects gossip g at its live origin, which starts
        # sending it the same round.
        inject = ((world.gossip_spread_at[None, :] == round_idx)
                  & (world.gossip_origin[None, :] == node_ids[:, None])
                  & alive[:, None])
        g_spread_until = torch.where(
            inject & ~g_infected, round_idx + 1 + params.periods_to_spread,
            g_spread_until)
        g_infected = g_infected | inject
    # Contact gating (full view with seeds): a sender gossips/SYNCs only
    # to members it holds live, or to seeds.
    is_seed = None
    if params.full_view and world.seed_ids.shape[0] > 0:
        is_seed = torch.zeros((n,), dtype=torch.bool, device=world.device)
        is_seed[world.seed_ids.long()] = True
    fd_round = kn.ping_every > 0 and round_idx % max(kn.ping_every, 1) == 0
    sync_round = kn.sync_every > 0 and round_idx % max(kn.sync_every, 1) == 0
    ae_due = (params.sync_interval > 0
              and sync_plane.due(round_idx, params.sync_interval))
    # The open-world plane: the raw epoch lane (the FD reads it at
    # targets, never at the self cell; the send and the merge kernel pin
    # the self cell) and each row's ground-truth epoch.
    own_epoch = world.epoch_at(round_idx) if params.epoch_bits else None
    return dict(alive=alive, part=part, node_ids=node_ids, is_self=is_self,
                status=status, inc=inc, g_infected=g_infected,
                g_spread_until=g_spread_until, is_seed=is_seed,
                lhm=state.lhm, fd_round=fd_round, sync_round=sync_round,
                ae_due=ae_due, epoch=state.epoch, own_epoch=own_epoch)


def _fma32(e: torch.Tensor, mean: torch.Tensor,
           total: torch.Tensor) -> torch.Tensor:
    """float32 ``fma(e, mean, total)``: the correctly rounded float32 of
    ``e * mean + total``, as XLA fuses the reference's delay sum.

    The float32 product and ``total`` are exact in float64; their
    float64 sum ``s`` rounds once, and TwoSum gives that rounding's
    exact error.  Rounding ``s`` to float32 as it stands would round
    twice, wrong where ``s`` lands on a float32 midpoint it did not
    start on; so where the error is nonzero, ``s`` first rounds to odd
    (its last float64 bit set, stepping one ulp toward the error),
    which no float32 midpoint is.  Round-to-odd in float64 then
    round-to-nearest in float32 is one correct rounding (53 >= 24 + 2
    bits), the same on every device."""
    p = e.double() * mean.double()
    t = total.double()
    s = p + t
    s_p = s - t
    err = (p - s_p) + (t - (s - s_p))
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where(even & (err != 0), torch.nextafter(s, toward), s)
    return s.float()


def _chain_ok(u: torch.Tensor, e: Optional[torch.Tensor],
              hop_losses: Sequence[torch.Tensor],
              hop_delays: Sequence[Optional[torch.Tensor]],
              budget_ms) -> torch.Tensor:
    """Multi-hop success: every hop delivered and the summed delay within
    ``budget_ms``.

    With every hop delay statically zero (``None``): one Bernoulli draw
    ``u`` [...] against the product of per-hop delivery probabilities
    (exact for independent losses), built in float32 in the reference's
    order.  Otherwise ``u`` [..., H] holds per-hop loss uniforms (hop h
    delivered iff ``u_h >= loss_h``) and ``e`` [..., D] the unit
    exponentials of the D delayed hops, summed in hop order as
    ``fma(e_j, mean_j, total)``.  ``budget_ms``: a number, or a float32
    tensor broadcasting against the chains."""
    delayed = [h for h, d in enumerate(hop_delays) if d is not None]
    if not delayed:
        p_chain = torch.ones(u.shape, dtype=torch.float32, device=u.device)
        for loss in hop_losses:
            p_chain = p_chain * (1.0 - loss)
        return (u < p_chain) & (0.0 <= budget_ms)
    ok = u[..., 0] >= hop_losses[0]
    for h in range(1, len(hop_losses)):
        ok &= u[..., h] >= hop_losses[h]
    total = torch.zeros(ok.shape, dtype=torch.float32, device=u.device)
    for j, h in enumerate(delayed):
        total = _fma32(e[..., j], hop_delays[h], total)
    return ok & (total <= torch.as_tensor(budget_ms, dtype=torch.float32,
                                          device=u.device))


def _hop_links(pairs, world: SwimWorld, round_idx: int, kn: Knobs,
               params: SwimParams):
    """``(losses, delays)``: ``link_eval`` of each (src ids, dst ids) hop
    of a probe chain, in hop order."""
    links = [link_eval(world.faults, round_idx, src, dst,
                       kn.loss_probability, params.mean_delay_ms)
             for src, dst in pairs]
    return [lo for lo, _ in links], [de for _, de in links]


def _entry_at_slot(mat: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """``mat[i, slot[i]]`` for ``slot`` in [0, K) (the reference's
    one-hot max over K, equal here because table values are >= 0)."""
    return mat.gather(1, slot[:, None].long())[:, 0]


def _held_epoch(epoch: torch.Tensor, slot: torch.Tensor,
                params: SwimParams) -> Optional[torch.Tensor]:
    """Each prober's held epoch of its target (raw lane; a target is
    never the prober itself) as int32, or None with the guard off."""
    if not params.epoch_bits:
        return None
    return _entry_at_slot(epoch, slot).to(torch.int32)


def _shift_fd_chains(eng, d_ids, d_alive, d_part, fd_shift: int,
                     proxy_shifts: Sequence[int], draws: prng.RoundDraws,
                     params: SwimParams, kn: Knobs, world: SwimWorld,
                     round_idx: int, node_ids, part_here, ping_budget=None,
                     ping_req_budget=None):
    """FD network outcomes as [N] vectors: the direct ping round trip and
    the ping-req proxy chains (FailureDetectorImpl.java:128-213), each
    hop with its link's loss and delay.  ``ping_budget`` /
    ``ping_req_budget``: [N] float32 budgets (Lifeguard's scaled ones),
    or None for the knobs' base budgets.

    Returns ``(t, alive_t, part_t, direct_ok, ack_ok)`` with ``t`` each
    prober's target and ``ack_ok`` including proxy rescues."""
    if ping_budget is None:
        ping_budget, ping_req_budget = knob_probe_budgets(kn, params)
    t = eng.look(d_ids, fd_shift)
    alive_t = eng.look(d_alive, fd_shift)
    part_t = eng.look(d_part, fd_shift)

    def hops(pairs):
        return _hop_links(pairs, world, round_idx, kn, params)

    delayed = draws.u_direct is None
    losses, delays = hops(((node_ids, t), (t, node_ids)))
    direct_ok = (_chain_ok(draws.chain_u_direct if delayed else draws.u_direct,
                           draws.chain_e_direct, losses, delays, ping_budget)
                 & alive_t & (part_here == part_t))
    ack_ok = direct_ok
    for r in range(params.ping_req_members):
        ps = proxy_shifts[r]
        p_ids = eng.look(d_ids, ps)
        p_alive = eng.look(d_alive, ps)
        p_part = eng.look(d_part, ps)
        losses, delays = hops(((node_ids, p_ids), (p_ids, t), (t, p_ids),
                               (p_ids, node_ids)))
        u, e = ((draws.chain_u_proxy[r], draws.chain_e_proxy[r]) if delayed
                else (draws.u_proxy[r], None))
        ok_pr = (_chain_ok(u, e, losses, delays, ping_req_budget)
                 & p_alive & alive_t
                 & (part_here == p_part) & (p_part == part_t)
                 & (ps != fd_shift))                     # proxy != target
        ack_ok = ack_ok | ok_pr
    return t, alive_t, part_t, direct_ok, ack_ok


def _shift_sender_gate(eng, d_ids, d_alive, d_part, s: int, node_ids,
                       kn: Knobs, params: SwimParams, world: SwimWorld,
                       round_idx: int):
    """The sender's id/alive/partition views through shift ``s`` and the
    sender->receiver hop's loss and delay, evaluated at the receiver.

    Returns ``(sender, sender_alive, sender_part, loss, delay)``."""
    sender = eng.deliver(d_ids, s)
    sender_alive = eng.deliver(d_alive, s)
    sender_part = eng.deliver(d_part, s)
    loss, delay = link_eval(world.faults, round_idx, sender, node_ids,
                            kn.loss_probability, params.mean_delay_ms)
    return sender, sender_alive, sender_part, loss, delay


def _send_components(state: SwimState, status, inc, round_idx: int,
                     params: SwimParams, world: SwimWorld, is_self,
                     epoch=None, own_epoch=None):
    """(record_keys, hot, syncable): one payload in the wire format, two
    transmit masks.

    Gossip carries hot records (changed within the spread window); a
    leaver's final-round gossip carries its own DEAD@inc+1
    (MembershipProtocolImpl.java:197-206); SYNC carries the row minus
    tombstones, masked on the sender's table status.  With the epoch
    guard on, every key carries its record's epoch: ``epoch`` is the raw
    lane (int32), pinned here to ``own_epoch`` at the self cells, so the
    leaver's DEAD notice goes out at its own epoch."""
    wf, eb = params.wire_format, params.epoch_bits
    leaving_now = (world.leave_at == round_idx)[:, None] & is_self
    hot = ((status != records.ABSENT) & (round_idx < state.spread_until)) \
        | leaving_now
    own = None
    if eb:
        own = own_epoch[:, None]
        epoch = torch.where(is_self, own, epoch)
    record_keys = delivery.pack_record(status, inc, fmt=wf, epoch=epoch,
                                       epoch_bits=eb)
    leave_key = delivery.pack_record(records.DEAD, state.self_inc[:, None] + 1,
                                     fmt=wf, epoch=own, epoch_bits=eb)
    record_keys = torch.where(leaving_now, leave_key, record_keys)
    syncable = status != records.DEAD
    return record_keys, hot, syncable


def _fd_phase(eng, views, ctx: dict, shifts, round_idx: int,
              params: SwimParams, kn: Knobs, world: SwimWorld,
              draws: prng.RoundDraws) -> dict:
    """Phase 1, the failure-detector probe: each prober's verdict about
    its shared-offset target, as [N] masks plus the SUSPECT verdicts as an
    [N, K] inbox contribution.  Verdicts are masked by the fd round and,
    with Lifeguard on, by the probe gate."""
    d_ids, d_alive, d_part = views
    k = params.n_subjects
    status, inc = ctx["status"], ctx["inc"]
    alive_here, part_here = ctx["alive"], ctx["part"]
    fd_shift = shifts[0]
    ping_budget, ping_req_budget, gate = lifeguard.lha_probe_setup(
        params, ctx["lhm"], draws.lhm_gate_u,
        *knob_probe_budgets(kn, params))
    t, _, _, direct_ok, ack_ok = _shift_fd_chains(
        eng, d_ids, d_alive, d_part, fd_shift,
        shifts[1:1 + params.ping_req_members], draws, params, kn, world,
        round_idx, ctx["node_ids"], part_here, ping_budget, ping_req_budget)
    if params.full_view:
        slot = t
        entry_t_status = _entry_at_slot(status, t)
        entry_t_inc = _entry_at_slot(inc, t)
        has_target = ((entry_t_status == records.ALIVE)
                      | (entry_t_status == records.SUSPECT))
    else:
        slot = eng.look(eng.prep(world.slot_of_node), fd_shift)  # -1: none
        slot_sf = torch.clamp(slot, min=0)
        entry_t_status = _entry_at_slot(status, slot_sf)
        entry_t_inc = _entry_at_slot(inc, slot_sf)
        has_target = (slot >= 0) & ((entry_t_status == records.ALIVE)
                                    | (entry_t_status == records.SUSPECT))
    active = has_target & alive_here & ctx["fd_round"]
    if gate is not None:
        active = active & gate
    verdict_suspect = active & ~ack_ok
    # Every live member probes its offset target each fd round; ``active``
    # gates only the tracked-subject bookkeeping.
    probes_sent = (active if params.ping_known_only
                   else alive_here & ctx["fd_round"])
    if gate is not None and not params.ping_known_only:
        probes_sent = probes_sent & gate
    fd_slot_onehot = (torch.arange(k, dtype=torch.int32,
                                   device=status.device)[None, :]
                      == torch.clamp(slot, min=0)[:, None])
    wf = params.wire_format
    # The verdict is about the record the observer holds: its
    # incarnation and its epoch.
    fd_suspect_key = delivery.pack_record(
        records.SUSPECT, entry_t_inc, fmt=wf,
        epoch=_held_epoch(ctx["epoch"], torch.clamp(slot, min=0), params),
        epoch_bits=params.epoch_bits)
    return dict(
        active=active,
        push_refute=active & ack_ok & (entry_t_status == records.SUSPECT),
        probes_sent=probes_sent,
        ping_req_launches=probes_sent & ~direct_ok,
        lhm_clean=probes_sent & direct_ok,
        fd_inbox=torch.where(fd_slot_onehot & verdict_suspect[:, None],
                             fd_suspect_key[:, None],
                             delivery.no_message(wf)),
    )


class _DelayRing:
    """The state's delay rings during one round's delivery: the due slot
    is read and cleared at construction (the flag ring's only
    ``with_flags``), later arrivals are pushed by :meth:`route` or into
    :meth:`slot` (in place: the caller owns the rings)."""

    def __init__(self, state: SwimState, params: SwimParams, round_idx: int,
                 with_flags: bool = True):
        self.params = params
        self.d = ring_slots(params)
        self.slot0 = round_idx % self.d
        self.keys, self.flags = state.inbox_ring, state.flag_ring
        self.g = state.g_ring if params.n_user_gossips > 0 else None
        self.keys_now = ring_ops.open_slot(self.keys, self.slot0,
                                           delivery.NO_MESSAGE)
        # The fused scatter wire never writes or reads the flag ring (the
        # merge gate derives the flags from the folded keys), so it stays
        # all zeros, as in the reference.
        self.flags_now = (ring_ops.open_slot(self.flags, self.slot0,
                                             0).bool()
                          if with_flags else None)
        self.g_now = (None if self.g is None
                      else ring_ops.open_slot(self.g, self.slot0, False))

    def route(self, ok, delivered, delivered_flags, delay, e, g_bits=None):
        """Split one channel's delivery into now and later: messages with
        delay bin j >= 1 go to slot ``(slot0 + j) % D``; returns the mask
        of those arriving this round.  ``delay`` None (statically zero)
        means all arrive now.  ``g_bits`` [N, G]: user-gossip bits riding
        the same message (the same bin)."""
        if delay is None:
            return ok
        q = ring_ops.delay_bins(e, delay, self.params.round_ms,
                                self.params.max_delay_rounds)
        for j in range(1, self.d):
            m = (ok & (q == j))[:, None]
            slot = (self.slot0 + j) % self.d
            ring_ops.push_max(self.keys, slot, torch.where(
                m, delivered, delivery.NO_MESSAGE))
            ring_ops.push_or(self.flags, slot,
                             (delivered_flags & m).to(torch.int8))
            if g_bits is not None:
                ring_ops.push_or(self.g, slot, g_bits & m)
        return ok & (q == 0)

    def slot(self, j: int) -> int:
        """The ring slot of messages ``j`` rounds late."""
        return (self.slot0 + j) % self.d


def _seed_anti_entropy(status, sync_keys, inbox, inbox_alive,
                       round_idx: int, params: SwimParams, kn: Knobs,
                       world: SwimWorld, ctx: dict, draws: prng.RoundDraws):
    """The joiner <-> seed SYNC round trip of a SYNC round (the
    reference's join protocol, MembershipProtocolImpl.java:298-367):
    every live member still holding ABSENT entries pushes its syncable
    row to its drawn seed (``draws.seed_sel``) and, if the push arrived,
    gets the seed's pre-merge row back the same round.  Returns
    ``(inbox, inbox_alive, sent, lost)``; ``inbox_alive`` None (the fused
    scatter wire, whose flags follow from the keys) stays None; ``sent``/
    ``lost`` [N] int32 are the exchange's wire counters (pushes at the
    pushers, acks at the seed; lost: dropped in flight)."""
    wf = params.wire_format
    no_msg = delivery.no_message(wf)
    node_ids, alive, part = ctx["node_ids"], ctx["alive"], ctx["part"]
    pusher = alive & (status == records.ABSENT).any(dim=1)
    sent = torch.zeros(node_ids.shape, dtype=torch.int32,
                       device=node_ids.device)
    lost = torch.zeros_like(sent)
    for si in range(world.seed_ids.shape[0]):
        sid = world.seed_ids[si]
        mask_i = pusher & (draws.seed_sel == si) & (node_ids != sid)
        loss_push, _ = link_eval(world.faults, round_idx, node_ids, sid,
                                 kn.loss_probability, params.mean_delay_ms)
        part_ok = part == part[sid]
        wire_drop_push = draws.seed_push_u[si] < loss_push
        ok_push = mask_i & alive[sid] & part_ok & ~wire_drop_push
        # The seed merges the columnwise max over its arriving pushes.
        is_seed_row = (node_ids == sid)[:, None]
        contribution = torch.where(ok_push[:, None], sync_keys,
                                   no_msg).amax(dim=0)
        inbox = torch.maximum(inbox, torch.where(
            is_seed_row, contribution[None, :], no_msg))
        if inbox_alive is not None:
            inbox_alive |= is_seed_row & delivery.is_alive_key(
                contribution, fmt=wf)[None, :]
        # The ack: the seed's row back to every successful pusher.
        seed_row = sync_keys[sid.long()]
        loss_ack, _ = link_eval(world.faults, round_idx, sid, node_ids,
                                kn.loss_probability, params.mean_delay_ms)
        wire_drop_ack = ok_push & (draws.seed_ack_u[si] < loss_ack)
        ok_ack = (ok_push & ~wire_drop_ack)[:, None]
        inbox = torch.maximum(inbox, torch.where(ok_ack, seed_row[None, :],
                                                 no_msg))
        if inbox_alive is not None:
            inbox_alive |= ok_ack & delivery.is_alive_key(seed_row,
                                                           fmt=wf)[None, :]
        at_seed = is_seed_row[:, 0]
        sent += mask_i.to(torch.int32) + torch.where(
            at_seed, ok_push.sum(dtype=torch.int32), 0)
        lost += (mask_i & (wire_drop_push | ~part_ok)).to(torch.int32) \
            + torch.where(at_seed, wire_drop_ack.sum(dtype=torch.int32), 0)
    return inbox, inbox_alive, sent, lost


def _unshift(eng, x: torch.Tensor, s: int) -> torch.Tensor:
    """A receiver-indexed [N] mask of shift ``s`` back at its senders
    (sender i's message reaches receiver (i + s) mod N), as int32."""
    return eng.look(eng.prep(x), s).to(torch.int32)


def _delivery_phase(state: SwimState, eng, views, ctx: dict, fd: dict,
                    shifts, round_idx: int, params: SwimParams, kn: Knobs,
                    world: SwimWorld, draws: prng.RoundDraws):
    """Phases 2-3: the ring's due slot, the F gossip channels, the refute
    push and the SYNC channel over cyclic shifts (delayed messages binned
    into the ring), the anti-entropy exchange on its rounds, and the
    joiner <-> seed exchange, max-folded with the FD verdicts into one
    inbox of the wire format's dtype.  Sender-side gates evaluate at the
    receiver through shifted views.  Under the metadata plane the hot
    md rows ride the gossip channels, the refute push and the SYNC
    channel and the full table the anti-entropy pair, with each
    channel's gates, arriving now only (never through the ring).
    Returns ``(inbox, inbox_alive, g_delivered, messages_gossip, link,
    messages_anti_entropy, md_delivered, prov)``; ``g_delivered`` [N, G]
    is None without user gossips; ``link`` is None, or under
    ``link_counters`` the channels' ``(sent, lost)`` [N] int32 wire
    counters at the senders (the exchanges' included);
    ``messages_anti_entropy`` is None with the plane off;
    ``md_delivered`` [N, K*M] int32 the max-folded md words (0: none),
    None with the metadata plane off; ``prov`` (the provenance knob, else
    None) ``{"gossip": ..., "sync": ...}``, the same channels' arrivals
    max-folded apart by family, [N, K] in the wire dtype: the gossip
    channels, and the SYNC family (the refute push, the SYNC channel, the
    anti-entropy pair, the joiner <-> seed exchange)."""
    d_ids, d_alive, d_part = views
    n, k = params.n_members, params.n_subjects
    r_proxies, f = params.ping_req_members, params.fanout
    status, inc, node_ids = ctx["status"], ctx["inc"], ctx["node_ids"]
    alive_here, part_here = ctx["alive"], ctx["part"]
    fd_shift, sync_shift = shifts[0], shifts[-1]
    wf = params.wire_format
    no_msg = delivery.no_message(wf)

    record_keys, hot, syncable = _send_components(
        state, status, inc, round_idx, params, world, ctx["is_self"],
        ctx["epoch"], ctx["own_epoch"])
    h_keys = eng.prep(record_keys)
    # Both transmit masks ride one int8 buffer (bit 0 hot, bit 1 syncable).
    h_tx = eng.prep(hot.to(torch.int8) | (syncable.to(torch.int8) << 1))
    hot_any = hot.any(dim=1)
    h_g = g_delivered = None
    if params.n_user_gossips > 0:
        # User gossips ride the same messages; a message exists when
        # either family has content.
        hot_g = (ctx["g_infected"] & alive_here[:, None]
                 & (round_idx < ctx["g_spread_until"]))
        h_g = eng.prep(hot_g)
        hot_any = hot_any | hot_g.any(dim=1)
        g_delivered = torch.zeros((n, params.n_user_gossips),
                                  dtype=torch.bool, device=status.device)
    h_hot_any = eng.prep(hot_any)
    h_status = eng.prep(status) if ctx["is_seed"] is not None else None
    h_md_hot = md_delivered = None
    if params.metadata_keys > 0:
        h_md_hot = eng.prep(metadata.hot_payload(state.md, state.md_spread,
                                                 round_idx))
        md_delivered = torch.zeros((n, k * params.metadata_keys),
                                   dtype=torch.int32, device=status.device)

    def fold_md(h_md, s, ok_now):
        """Max-fold the md payload of shift ``s`` where it arrives now."""
        if h_md is not None:
            torch.maximum(md_delivered,
                          torch.where(ok_now[:, None], eng.deliver(h_md, s),
                                      0), out=md_delivered)

    def deliver_channel(s, tx_bit):
        keys = eng.deliver(h_keys, s)
        tx = (eng.deliver(h_tx, s) & tx_bit) != 0
        payload = torch.where(tx, keys, no_msg)
        return payload, delivery.is_alive_key(payload, fmt=wf)

    def contact_ok(s):
        """Full view with seeds: the sender (j - s) holds receiver j live
        (its row's column j, the diagonal of the shifted view), or j is
        a seed."""
        knows = torch.diagonal(eng.deliver(h_status, s))
        return ((knows == records.ALIVE) | (knows == records.SUSPECT)
                | ctx["is_seed"])

    inbox = fd["fd_inbox"]
    inbox_alive = torch.zeros((n, k), dtype=torch.bool, device=status.device)
    # The provenance accumulators: each arrival folded a second time,
    # into its channel family's maximum, beside the combined inbox.
    prov = None
    if params.provenance:
        prov = {name: torch.full_like(inbox, no_msg)
                for name in ("gossip", "sync")}

    def fold(inbox, contribution, family):
        if prov is not None:
            prov[family] = torch.maximum(prov[family], contribution)
        return torch.maximum(inbox, contribution)

    ring = None
    if params.max_delay_rounds > 0:
        ring = _DelayRing(state, params, round_idx)
        inbox = torch.maximum(inbox, ring.keys_now)
        inbox_alive |= ring.flags_now
        if g_delivered is not None:
            g_delivered |= ring.g_now

    def arriving(ok, delivered, flags, delay, e, g_bits=None):
        """The channel's messages arriving now (later ones go to the
        ring)."""
        if ring is None:
            return ok
        return ring.route(ok, delivered, flags, delay, e, g_bits)

    drop_u = draws.drop_u
    n_gossip_sent = torch.zeros((), dtype=torch.int32, device=status.device)
    # Per-sender wire counters: a channel's gates evaluate at the
    # receiver, so its attempt and loss masks are unshifted to the
    # sender; a message toward a crashed receiver counts as sent, only
    # in-flight drops (loss, partition walls) count as lost.
    link = None
    if params.link_counters:
        link = (torch.zeros((n,), dtype=torch.int32, device=status.device),
                torch.zeros((n,), dtype=torch.int32, device=status.device))

    def count(s, attempt, dropped):
        link[0].add_(_unshift(eng, attempt, s))
        link[1].add_(_unshift(eng, attempt & dropped, s))

    for c, s in enumerate(shifts[1 + r_proxies:1 + r_proxies + f]):
        _, sender_alive, sender_part, loss_c, delay_c = _shift_sender_gate(
            eng, d_ids, d_alive, d_part, s, node_ids, kn, params, world,
            round_idx)
        ok_c = (sender_alive & alive_here & (sender_part == part_here)
                & (drop_u[:, c] >= loss_c) & (c < kn.fanout))
        contact_c = contact_ok(s) if h_status is not None else None
        if contact_c is not None:
            ok_c &= contact_c
        if link is not None:
            attempt = (sender_alive & eng.deliver(h_hot_any, s)
                       & (c < kn.fanout))
            if contact_c is not None:
                attempt &= contact_c
            count(s, attempt, (drop_u[:, c] < loss_c)
                  | (sender_part != part_here))
        delivered, delivered_flags = deliver_channel(s, 1)
        g_bits = eng.deliver(h_g, s) if h_g is not None else None
        e_c = draws.e_gossip[c] if draws.e_gossip is not None else None
        ok_now = arriving(ok_c, delivered, delivered_flags, delay_c, e_c,
                          g_bits)
        inbox = fold(inbox, torch.where(ok_now[:, None], delivered, no_msg),
                     "gossip")
        inbox_alive |= delivered_flags & ok_now[:, None]
        if g_bits is not None:
            g_delivered |= g_bits & ok_now[:, None]
        fold_md(h_md_hot, s, ok_now)
        n_gossip_sent += (ok_c & eng.deliver(h_hot_any, s)).sum(
            dtype=torch.int32)

    # Refute push: a prober whose ALIVE verdict met a SUSPECT entry SYNCs
    # its row to the probed member t = (i + fd_shift), i.e. receiver j
    # hears sender (j - fd_shift).  A refuting sender skips its regular
    # SYNC push, seen at the receiver through the sync shift.  No contact
    # gate (as in the reference).  With Lifeguard on (the buddy system)
    # the push rides the probe's ack path, whatever the SYNC cadence.
    push_refute = _buddy_push(fd["push_refute"], params, kn)
    h_pushers = eng.prep(push_refute)
    _, sender_alive_r, sender_part_r, loss_r, delay_r = _shift_sender_gate(
        eng, d_ids, d_alive, d_part, fd_shift, node_ids, kn, params, world,
        round_idx)
    pushing_r = eng.deliver(h_pushers, fd_shift)
    ok_r = (sender_alive_r & alive_here & (sender_part_r == part_here)
            & ~(draws.u_refute < loss_r) & pushing_r)
    if link is not None:
        # The pusher mask is the sender's own; only the loss unshifts.
        dropped_r = (draws.u_refute < loss_r) | (sender_part_r != part_here)
        link[0].add_(push_refute.to(torch.int32))
        link[1].add_(_unshift(eng, pushing_r & dropped_r, fd_shift))
    delivered_r, flags_r = deliver_channel(fd_shift, 2)
    ok_r = arriving(ok_r, delivered_r, flags_r, delay_r, draws.e_refute)
    inbox = fold(inbox, torch.where(ok_r[:, None], delivered_r, no_msg),
                 "sync")
    inbox_alive |= flags_r & ok_r[:, None]
    fold_md(h_md_hot, fd_shift, ok_r)
    sender_refuting = eng.deliver(h_pushers, sync_shift)

    # SYNC channel: the periodic anti-entropy push.
    _, sender_alive, sender_part, loss_sy, delay_sy = _shift_sender_gate(
        eng, d_ids, d_alive, d_part, sync_shift, node_ids, kn, params, world,
        round_idx)
    ok_s = (sender_alive & alive_here & ~sender_refuting
            & (sender_part == part_here) & ~(drop_u[:, f] < loss_sy)
            & ctx["sync_round"])
    contact_s = contact_ok(sync_shift) if h_status is not None else None
    if contact_s is not None:
        ok_s &= contact_s
    if link is not None:
        attempt = sender_alive & ~sender_refuting & ctx["sync_round"]
        if contact_s is not None:
            attempt &= contact_s
        count(sync_shift, attempt, (drop_u[:, f] < loss_sy)
              | (sender_part != part_here))
    delivered, delivered_flags = deliver_channel(sync_shift, 2)
    ok_s = arriving(ok_s, delivered, delivered_flags, delay_sy, draws.e_sync)
    inbox = fold(inbox, torch.where(ok_s[:, None], delivered, no_msg),
                 "sync")
    inbox_alive |= delivered_flags & ok_s[:, None]
    fold_md(h_md_hot, sync_shift, ok_s)

    # The anti-entropy exchange: two syncable-payload channels at the
    # shared offset +s and N - s, so receiver j hears partners j - s and
    # j + s; delivered the same round, never through the ring.  Rounds
    # that are not due skip both (the reference computes and masks them).
    ae_sent = None
    if params.sync_interval > 0:
        ae_sent = sync_plane.sent_count(ctx["ae_due"], alive_here)
    if ctx["ae_due"]:
        h_md_full = None
        if params.metadata_keys > 0:
            h_md_full = eng.prep(metadata.full_payload(state.md))
        for d_i, sft in enumerate(_ae_shifts(draws, n)):
            ok_ae, attempt_ae, dropped_ae = _ae_gate(
                eng, views, sft, draws.ae_drop_u[d_i], ctx, kn, params, world,
                round_idx)
            if h_status is not None:
                contact_ae = contact_ok(sft)
                ok_ae &= contact_ae
                attempt_ae &= contact_ae
            if link is not None:
                count(sft, attempt_ae, dropped_ae)
            delivered, delivered_flags = deliver_channel(sft, 2)
            inbox = fold(inbox, torch.where(ok_ae[:, None], delivered,
                                            no_msg), "sync")
            inbox_alive |= delivered_flags & ok_ae[:, None]
            fold_md(h_md_full, sft, ok_ae)

    # The joiner <-> seed exchange: its pushers are gated on the SYNC
    # round, so other rounds skip it; delivered the same round.
    if h_status is not None and ctx["sync_round"]:
        sync_keys = torch.where(syncable, record_keys, no_msg)
        inbox, inbox_alive, ss_sent, ss_lost = _seed_anti_entropy(
            status, sync_keys, inbox, inbox_alive, round_idx, params, kn,
            world, ctx, draws)
        if prov is not None:
            # The same draws give the same arrivals (the join path is a
            # SYNC exchange).
            prov["sync"] = _seed_anti_entropy(
                status, sync_keys, prov["sync"], None, round_idx, params,
                kn, world, ctx, draws)[0]
        if link is not None:
            link[0].add_(ss_sent)
            link[1].add_(ss_lost)
    return (inbox, inbox_alive, g_delivered, n_gossip_sent, link, ae_sent,
            md_delivered, prov)


def _buddy_push(push_refute, params: SwimParams, kn: Knobs):
    """The refute push as sent: it rides the SYNC channel, so a disabled
    channel (``sync_every == 0``) disables it, unless Lifeguard's buddy
    system carries it on the probe's ack path (``lhm_max > 0``)."""
    if params.lhm_max > 0:
        return push_refute
    return push_refute & (kn.sync_every > 0)


def _ae_shifts(draws, n: int) -> Tuple[int, int]:
    """The anti-entropy exchange's two channel shifts: +s and N - s."""
    return draws.ae_offset, n - draws.ae_offset


def _ae_gate(eng, views, sft: int, drop_u, ctx: dict, kn: Knobs,
             params: SwimParams, world: SwimWorld, round_idx: int):
    """One anti-entropy channel's receiver-indexed gates on a due round:
    ``(ok, attempt, dropped)`` [N] bool, the message arriving, the
    sender's attempt (live sender), and its in-flight drop (loss or a
    partition wall).  The contact gate is the caller's."""
    _, sender_alive, sender_part, loss, _ = _shift_sender_gate(
        eng, *views, sft, ctx["node_ids"], kn, params, world, round_idx)
    part_ok = sender_part == ctx["part"]
    wire_drop = drop_u < loss
    ok = sender_alive & ctx["alive"] & part_ok & ~wire_drop
    return ok, sender_alive.clone(), wire_drop | ~part_ok


# --------------------------------------------------------------------------
# Scatter delivery: every sender draws its own uniform targets
# --------------------------------------------------------------------------


def _send_payloads(state: SwimState, ctx: dict, round_idx: int,
                   params: SwimParams, world: SwimWorld):
    """(gossip_keys, sync_keys): the masked payload rows each scatter
    sender ships (hot records; everything but tombstones)."""
    record_keys, hot, syncable = _send_components(
        state, ctx["status"], ctx["inc"], round_idx, params, world,
        ctx["is_self"], ctx["epoch"], ctx["own_epoch"])
    no_msg = delivery.no_message(params.wire_format)
    return (torch.where(hot, record_keys, no_msg),
            torch.where(syncable, record_keys, no_msg))


def _scatter_fd_phase(ctx: dict, round_idx: int, params: SwimParams,
                      kn: Knobs, world: SwimWorld,
                      draws: prng.ScatterDraws) -> dict:
    """Phase 1 of the scatter round, the failure-detector probe
    (FailureDetectorImpl.java:128-213): each prober's own target, known-
    only (a Gumbel argmax over the subjects its row holds live) or
    uniform over the members (focal), the direct ping round trip and R
    ping-req proxy chains over gathered ids, the verdicts (with Lifeguard
    on: the probe gate and the health-scaled budgets), the SUSPECT inbox
    contribution and the refute push."""
    k = params.n_subjects
    status, inc = ctx["status"], ctx["inc"]
    alive, part, node_ids = ctx["alive"], ctx["part"], ctx["node_ids"]
    if params.ping_known_only:
        eligible = ~ctx["is_self"] & ((status == records.ALIVE)
                                      | (status == records.SUSPECT))
        slot, has_target = prng.choose_eligible(draws.ping_gumbel, eligible)
        t = world.subject_ids[slot]
    else:
        t = prng.targets_excluding_self(draws.ping_t[:, None], node_ids)[:, 0]
        slot = world.slot_of_node[t.long()]                 # -1: untracked
        entry = _entry_at_slot(status, torch.clamp(slot, min=0))
        has_target = (slot >= 0) & ((entry == records.ALIVE)
                                    | (entry == records.SUSPECT))
    ping_budget, ping_req_budget, gate = lifeguard.lha_probe_setup(
        params, ctx["lhm"], draws.lhm_gate_u,
        *knob_probe_budgets(kn, params))
    if gate is None:
        ping_budget, proxy_budget = knob_probe_budgets(kn, params)
    else:
        proxy_budget = ping_req_budget[:, None]

    def hops(pairs):
        return _hop_links(pairs, world, round_idx, kn, params)

    delayed = draws.u_direct is None
    t_l = t.long()
    alive_t, part_t = alive[t_l], part[t_l]
    losses, delays = hops(((node_ids, t), (t, node_ids)))
    direct_ok = (_chain_ok(draws.chain_u_direct if delayed else draws.u_direct,
                           draws.chain_e_direct, losses, delays, ping_budget)
                 & alive_t & (part == part_t))
    proxies = prng.targets_excluding_self(draws.proxies, node_ids)   # [N, R]
    p_l = proxies.long()
    t_col = t[:, None]
    losses, delays = hops(((node_ids[:, None], proxies), (proxies, t_col),
                           (t_col, proxies), (proxies, node_ids[:, None])))
    u, e = ((draws.proxy_chain_u, draws.proxy_chain_e) if delayed
            else (draws.proxy_u, None))
    part_p = part[p_l]
    proxy_ok = (_chain_ok(u, e, losses, delays, proxy_budget)
                & alive[p_l] & alive_t[:, None] & (part[:, None] == part_p)
                & (part_p == part_t[:, None]) & (proxies != t_col))
    ack_ok = direct_ok | proxy_ok.any(dim=1)
    probe_active = has_target & alive & ctx["fd_round"]
    if gate is not None:
        probe_active = probe_active & gate
    # Every live member probes each fd round; in focal mode whether or
    # not the target is tracked (``probe_active`` gates the bookkeeping).
    probes_sent = (probe_active if params.ping_known_only
                   else alive & ctx["fd_round"])
    if gate is not None and not params.ping_known_only:
        probes_sent = probes_sent & gate
    slot_sf = torch.clamp(slot, min=0)
    fd_slot_onehot = (torch.arange(k, dtype=slot_sf.dtype,
                                   device=status.device)[None, :]
                      == slot_sf[:, None])
    verdict_suspect = probe_active & ~ack_ok
    wf = params.wire_format
    fd_suspect_key = delivery.pack_record(
        records.SUSPECT, _entry_at_slot(inc, slot_sf), fmt=wf,
        epoch=_held_epoch(ctx["epoch"], slot_sf, params),
        epoch_bits=params.epoch_bits)
    return dict(
        t=t, probe_active=probe_active, probes_sent=probes_sent,
        ping_req_launches=probes_sent & ~direct_ok,
        lhm_clean=probes_sent & direct_ok,
        push_refute=(probe_active & ack_ok
                     & (_entry_at_slot(status, slot_sf) == records.SUSPECT)),
        fd_inbox=torch.where(fd_slot_onehot & verdict_suspect[:, None],
                             fd_suspect_key[:, None],
                             delivery.no_message(wf)),
    )


def _scatter_send_phase(state: SwimState, ctx: dict, fd: dict,
                        round_idx: int, params: SwimParams, kn: Knobs,
                        world: SwimWorld, draws: prng.ScatterDraws) -> dict:
    """Phases 2-3 of the scatter round: the gossip and SYNC sends, as
    payload rows, targets and drop masks (the reference's
    ``_scatter_send_phase`` after the probe).  Gossip goes to F drawn
    targets, each gated on the sender and target being live and in one
    partition, the contact gate, a loss draw and the channel count; the
    SYNC goes to one drawn target, or to the probed member where an
    ALIVE verdict met a SUSPECT entry (the refute push); on an
    anti-entropy round the SYNC payload also goes to the two exchange
    partners (``ae_targets`` [N, 2], ``ae_drop``, and the link
    counters' ``ae_attempt`` / ``ae_lost``).  Under the metadata plane
    also the md payloads: ``md_hot`` [N, K*M] (hot rows, for the gossip
    and SYNC targets) and ``md_full`` (the table, for the exchange)."""
    status = ctx["status"]
    alive, part, node_ids = ctx["alive"], ctx["part"], ctx["node_ids"]
    gossip_keys, sync_keys = _send_payloads(state, ctx, round_idx, params,
                                            world)
    gate = ctx["is_seed"] is not None

    def contact_ok(targets):
        """Full view with seeds: the sender holds the target live, or
        the target is a seed."""
        held = status.gather(1, targets.long())
        return ((held == records.ALIVE) | (held == records.SUSPECT)
                | ctx["is_seed"][targets.long()])

    gossip_targets = prng.targets_excluding_self(draws.gossip_t, node_ids)
    g_l = gossip_targets.long()
    # Named components (the link counters tell in-flight drops from
    # messages never sent), fused into the one drop mask delivery reads.
    part_ok_g = part[:, None] == part[g_l]
    contact_ok_g = contact_ok(gossip_targets) if gate else None
    send_ok = alive[:, None] & alive[g_l] & part_ok_g
    if gate:
        send_ok &= contact_ok_g
    loss_g, delay_g = link_eval(world.faults, round_idx, node_ids[:, None],
                                gossip_targets, kn.loss_probability,
                                params.mean_delay_ms)
    chan_off = (torch.arange(params.fanout, device=status.device)[None, :]
                >= kn.fanout)
    wire_drop_g = draws.gossip_drop_u < loss_g
    gossip_drop = wire_drop_g | ~send_ok | chan_off

    # The refute push rides the SYNC channel (it is a SYNC to the
    # suspected member, MembershipProtocolImpl.java:379-391), so a
    # disabled channel disables it too, unless Lifeguard's buddy system
    # carries it on the ack path.
    push_refute = _buddy_push(fd["push_refute"], params, kn)
    sync_target = prng.targets_excluding_self(draws.sync_t[:, None],
                                              node_ids)
    sync_target = torch.where(push_refute[:, None], fd["t"][:, None],
                              sync_target)
    do_sync = (alive & ctx["sync_round"]) | push_refute
    if gate:
        do_sync &= contact_ok(sync_target)[:, 0] | push_refute
    target = sync_target[:, 0]
    loss_s, delay_s = link_eval(world.faults, round_idx, node_ids, target,
                                kn.loss_probability, params.mean_delay_ms)
    part_ok_s = part == part[target.long()]
    wire_drop_s = draws.sync_drop_u < loss_s
    sync_ok = alive[target.long()] & part_ok_s & ~wire_drop_s
    wf = params.wire_format
    hot_any = (gossip_keys >= 0).any(dim=1)
    hot_g = None
    if params.n_user_gossips > 0:
        hot_g = (ctx["g_infected"] & alive[:, None]
                 & (round_idx < ctx["g_spread_until"]))
        # A gossip message exists when either family has content.
        hot_any = hot_any | hot_g.any(dim=1)
    ae = {}
    if params.sync_interval > 0:
        ae["messages_anti_entropy"] = sync_plane.sent_count(ctx["ae_due"],
                                                            alive)
    if ctx["ae_due"]:
        ae_targets = sync_plane.exchange_targets(
            node_ids, draws.ae_offset, params.n_members)
        a_l = ae_targets.long()
        loss_ae, _ = link_eval(world.faults, round_idx, node_ids[:, None],
                               ae_targets, kn.loss_probability,
                               params.mean_delay_ms)
        wire_drop_ae = draws.ae_drop_u < loss_ae
        part_ok_ae = part[:, None] == part[a_l]
        attempt_ae = alive[:, None].expand(-1, 2)
        if gate:
            attempt_ae = attempt_ae & contact_ok(ae_targets)
        ae.update(ae_targets=ae_targets,
                  ae_drop=~(attempt_ae & alive[a_l] & part_ok_ae
                            & ~wire_drop_ae),
                  ae_attempt=attempt_ae,
                  ae_lost=attempt_ae & (wire_drop_ae | ~part_ok_ae))
    md = {}
    if params.metadata_keys > 0:
        md = dict(md_hot=metadata.hot_payload(state.md, state.md_spread,
                                              round_idx),
                  md_full=metadata.full_payload(state.md))
    return dict(
        ae, **md,
        gossip_keys=gossip_keys, sync_keys=sync_keys,
        gossip_targets=gossip_targets, gossip_drop=gossip_drop,
        sync_target=sync_target, sync_drop=~(do_sync & sync_ok)[:, None],
        alive_flags=delivery.is_alive_key(gossip_keys, fmt=wf),
        sync_alive_flags=delivery.is_alive_key(sync_keys, fmt=wf),
        hot_any=hot_any, hot_g=hot_g, delay_g=delay_g, delay_s=delay_s,
        wire_drop_g=wire_drop_g, part_ok_g=part_ok_g,
        contact_ok_g=contact_ok_g, chan_off=chan_off,
        wire_drop_s=wire_drop_s, part_ok_s=part_ok_s, do_sync=do_sync)


def _scatter_channel_bufs(s: dict, params: SwimParams, inbox, inbox_alive,
                          gossip_extra_drop=None, sync_extra_drop=None,
                          with_ae: bool = True, md_buf=None,
                          sync_inbox=None) -> None:
    """Fold one delay bin of the round's gossip and SYNC scatters into
    ``inbox`` (wire keys) and, on the two-buffer wire
    (``fused_wire=False``), ``inbox_alive`` (ALIVE flags), in place.
    The ``*_extra_drop`` masks keep the messages of other bins out.
    ``with_ae``: also the anti-entropy exchange's two scatters, where the
    round has them (bin 0 only: the exchange is same-round).  ``md_buf``
    [N, K*M] (bin 0 under the metadata plane): also the md payloads'
    scatters on the same targets and drops (hot rows on the gossip and
    SYNC channels, the table on the exchange's).  ``sync_inbox`` (the
    provenance knob): the SYNC family's keys (the SYNC channel and the
    exchange) fold there instead, the gossip channel's into ``inbox``."""
    g_drop, s_drop = s["gossip_drop"], s["sync_drop"]
    if gossip_extra_drop is not None:
        g_drop = g_drop | gossip_extra_drop
        s_drop = s_drop | sync_extra_drop
    s_inbox = inbox if sync_inbox is None else sync_inbox
    channels = [(inbox, "gossip_keys", "alive_flags", "md_hot",
                 "gossip_targets", g_drop),
                (s_inbox, "sync_keys", "sync_alive_flags", "md_hot",
                 "sync_target", s_drop)]
    if with_ae and "ae_targets" in s:
        channels.append((s_inbox, "sync_keys", "sync_alive_flags", "md_full",
                         "ae_targets", s["ae_drop"]))
    for into, keys, flags, md, targets, drop in channels:
        delivery.scatter_max_into(into, s[keys], s[targets], drop)
        if not params.fused_wire:
            delivery.scatter_or_into(inbox_alive, s[flags], s[targets], drop)
        if md_buf is not None:
            delivery.scatter_max_into(md_buf, s[md], s[targets], drop)


def _scatter_deliver(state: SwimState, ctx: dict, fd: dict, s: dict,
                     round_idx: int, params: SwimParams, kn: Knobs,
                     world: SwimWorld, draws: prng.ScatterDraws):
    """The scatter round's inbox: the FD verdicts, the ring's due slot
    and the bin-0 scatters max-folded together, later bins pushed into
    the ring (keys only under the fused wire), the joiner <-> seed
    exchange, and the user-gossip bits on the gossip channels' targets
    and drops.  Under the fused wire the ALIVE flags are those of the
    folded winners.  Returns ``(inbox, inbox_alive, g_delivered,
    seed_counters, md_delivered, prov)``: ``seed_counters`` the seed
    exchange's ``(sent, lost)`` [N] or None where it did not run,
    ``md_delivered`` [N, K*M] the bin-0 md scatters (-1: none; same-round
    only), None with the metadata plane off.  With the provenance knob the gossip channel
    and the SYNC family scatter into two buffers of their own, max-folded
    with the FD verdicts into the inbox (an integer max in any order gives
    the same keys); returned as ``prov`` (``{"gossip", "sync"}``, the seed
    exchange folded into the SYNC family), else None."""
    n, k = params.n_members, params.n_subjects
    wf = params.wire_format
    inbox = fd["fd_inbox"]
    inbox_alive = (None if params.fused_wire else
                   torch.zeros((n, k), dtype=torch.bool, device=inbox.device))
    ring = None
    if params.max_delay_rounds > 0:
        ring = _DelayRing(state, params, round_idx,
                          with_flags=not params.fused_wire)
        inbox = torch.maximum(inbox, ring.keys_now)
        if inbox_alive is not None:
            inbox_alive |= ring.flags_now
    # The messages' delay bins; None: every message arrives now.
    q_g = q_s = None
    if ring is not None and s["delay_g"] is not None:
        q_g = ring_ops.delay_bins(draws.gossip_e, s["delay_g"],
                                  params.round_ms, params.max_delay_rounds)
        q_s = ring_ops.delay_bins(draws.e_sync, s["delay_s"],
                                  params.round_ms,
                                  params.max_delay_rounds)[:, None]

    def late(q, j):
        return None if q is None else q != j

    md_delivered = None
    if params.metadata_keys > 0:
        md_delivered = torch.full(s["md_hot"].shape, delivery.NO_MESSAGE,
                                  dtype=torch.int32, device=inbox.device)
    prov = None
    if params.provenance:
        # No delay ring under the knob: every message arrives now.
        prov = {name: torch.full_like(inbox, delivery.no_message(wf))
                for name in ("gossip", "sync")}
        _scatter_channel_bufs(s, params, prov["gossip"], inbox_alive,
                              md_buf=md_delivered, sync_inbox=prov["sync"])
        inbox = torch.maximum(inbox, torch.maximum(prov["gossip"],
                                                   prov["sync"]))
    else:
        _scatter_channel_bufs(s, params, inbox, inbox_alive, late(q_g, 0),
                              late(q_s, 0), md_buf=md_delivered)
    if q_g is not None:
        for j in range(1, ring.d):
            slot = ring.slot(j)
            _scatter_channel_bufs(
                s, params, ring.keys[slot],
                None if params.fused_wire else ring.flags[slot],
                q_g != j, q_s != j, with_ae=False)
    seed_counters = None
    if ctx["is_seed"] is not None and ctx["sync_round"]:
        inbox, inbox_alive, *seed_counters = _seed_anti_entropy(
            ctx["status"], s["sync_keys"], inbox, inbox_alive, round_idx,
            params, kn, world, ctx, draws)
        if prov is not None:
            # The same draws give the same arrivals (the join path is a
            # SYNC exchange).
            prov["sync"] = _seed_anti_entropy(
                ctx["status"], s["sync_keys"], prov["sync"], None,
                round_idx, params, kn, world, ctx, draws)[0]
    if params.fused_wire:
        inbox_alive = delivery.is_alive_key(inbox, fmt=wf)
    g_delivered = None
    if params.n_user_gossips > 0:
        # User gossips ride the same gossip messages: the same targets,
        # drops and delay bins.
        g_delivered = (ring.g_now if ring is not None else
                       torch.zeros((n, params.n_user_gossips),
                                   dtype=torch.bool, device=inbox.device))
        g_drop = s["gossip_drop"]
        delivery.scatter_or_into(
            g_delivered, s["hot_g"], s["gossip_targets"],
            g_drop if q_g is None else g_drop | (q_g != 0))
        if q_g is not None:
            for j in range(1, ring.d):
                delivery.scatter_or_into(ring.g[ring.slot(j)], s["hot_g"],
                                         s["gossip_targets"],
                                         g_drop | (q_g != j))
    return (inbox, inbox_alive, g_delivered, seed_counters, md_delivered,
            prov)


def _scatter_send_aux(fd: dict, s: dict, params: SwimParams, alive,
                      seed_counters) -> dict:
    """The scatter round's send-side counters; a gossip message counts
    per channel whose sender has content and whose message was not
    dropped.  Under ``link_counters`` also the per-sender wire counters:
    a gossip message per live sender with content, open channel and
    admitting contact gate, the SYNC (or refute push), the probes and
    ping-req fan-outs, the seed exchange, the anti-entropy exchange's
    two messages; lost: wire drops and partition walls."""
    aux = {}
    if params.link_counters:
        g_attempt = (alive & s["hot_any"])[:, None] & ~s["chan_off"]
        if s["contact_ok_g"] is not None:
            g_attempt &= s["contact_ok_g"]
        g_lost = g_attempt & (s["wire_drop_g"] | ~s["part_ok_g"])
        s_lost = s["do_sync"] & (s["wire_drop_s"] | ~s["part_ok_s"])
        sent = (g_attempt.sum(dim=1, dtype=torch.int32)
                + s["do_sync"].to(torch.int32)
                + fd["probes_sent"].to(torch.int32)
                + fd["ping_req_launches"].to(torch.int32)
                * params.ping_req_members)
        lost = g_lost.sum(dim=1, dtype=torch.int32) + s_lost.to(torch.int32)
        if seed_counters is not None:
            sent = sent + seed_counters[0]
            lost = lost + seed_counters[1]
        if "ae_attempt" in s:
            sent = sent + s["ae_attempt"].sum(dim=1, dtype=torch.int32)
            lost = lost + s["ae_lost"].sum(dim=1, dtype=torch.int32)
        aux = dict(sent_by_node=sent, lost_by_node=lost)
    if "messages_anti_entropy" in s:
        aux["messages_anti_entropy"] = s["messages_anti_entropy"]
    return dict(
        aux,
        messages_gossip=(s["hot_any"][:, None] & ~s["gossip_drop"]).sum(
            dtype=torch.int32),
        messages_ping=fd["probe_active"].sum(dtype=torch.int32),
        messages_ping_sent=fd["probes_sent"].sum(dtype=torch.int32),
        messages_ping_req_sent=(fd["ping_req_launches"].sum(dtype=torch.int32)
                                * params.ping_req_members),
    )


def _tick_scatter(state: SwimState, ctx: dict, round_idx: int,
                  params: SwimParams, kn: Knobs, world: SwimWorld,
                  draws: prng.ScatterDraws):
    """The scatter round's FD, delivery and merge phases, each under a
    profiler range (``swim.fd`` / ``swim.delivery`` / ``swim.merge``);
    returns ``(new_state, aux counters)``."""
    _check_draws(draws, prng.DrawFacts.of(params, world))
    with record_function("swim.fd"):
        fd = _scatter_fd_phase(ctx, round_idx, params, kn, world, draws)
    with record_function("swim.delivery"):
        s = _scatter_send_phase(state, ctx, fd, round_idx, params, kn, world,
                                draws)
        (inbox, inbox_alive, g_delivered, seed_counters, md_delivered,
         prov) = _scatter_deliver(state, ctx, fd, s, round_idx, params, kn,
                                  world, draws)
    with record_function("swim.merge"):
        new_state, refuted = _merge_and_timers(
            state, ctx, inbox, inbox_alive, g_delivered, round_idx, params,
            kn, world, lhm_signals=(fd["ping_req_launches"],
                                    fd["lhm_clean"]))
    aux = dict(_scatter_send_aux(fd, s, params, ctx["alive"], seed_counters),
               refutations=(refuted & ctx["alive"]).sum(dtype=torch.int32))
    if prov is not None:
        aux["_provenance"] = _exposure(fd["fd_inbox"], prov["gossip"],
                                       prov["sync"], fd["ping_req_launches"])
    return _metadata_phase(new_state, md_delivered, ctx, round_idx, params,
                           aux)


def _check_draws(draws, facts: prng.DrawFacts) -> None:
    """Raise unless ``draws`` is the delivery mode's kind of draws and
    holds exactly the chain draws and every other field ``facts`` call
    for."""
    kind = getattr(draws, "DELIVERY", None)
    if kind != facts.delivery:
        raise ValueError(
            f"a {facts.delivery} round got {type(draws).__name__} (draws of "
            f"{kind} delivery); make the draws for these params")
    need, other = draws.fields_for(facts)
    missing = [name for name in need if getattr(draws, name) is None]
    stray = [name for name in other if getattr(draws, name) is not None]
    if missing or stray:
        raise ValueError(
            f"draws lack {missing} / carry {stray} for this round's "
            f"{facts} (make them for these params and this world)")


def _shift_setup(ctx: dict, params: SwimParams, world: SwimWorld,
                 draws: prng.RoundDraws):
    """Check a shift round's draws; returns its channel shifts ([fd,
    proxies..., gossip..., sync]), the shift engine, and the doubled id,
    liveness and partition vectors the channel views slice."""
    _check_draws(draws, prng.DrawFacts.of(params, world))
    shifts = draws.shifts
    n_shifts = 1 + params.ping_req_members + params.fanout + 1
    if len(shifts) != n_shifts:
        raise ValueError(f"draws carry {len(shifts)} shifts, the round "
                         f"needs {n_shifts}")
    eng = ShiftEngine(params.n_members)
    views = (eng.prep(ctx["node_ids"]), eng.prep(ctx["alive"]),
             eng.prep(ctx["part"]))
    return shifts, eng, views


def _tick_shift(state: SwimState, ctx: dict, round_idx: int,
                params: SwimParams, kn: Knobs, world: SwimWorld,
                draws: prng.RoundDraws):
    """The shift round's FD, delivery and merge phases, each under a
    profiler range (``swim.fd`` / ``swim.delivery`` / ``swim.merge``);
    returns ``(new_state, aux counters)``."""
    shifts, eng, views = _shift_setup(ctx, params, world, draws)
    with record_function("swim.fd"):
        fd = _fd_phase(eng, views, ctx, shifts, round_idx, params, kn, world,
                       draws)
    with record_function("swim.delivery"):
        (inbox, inbox_alive, g_delivered, n_gossip_sent, link, ae_sent,
         md_delivered, prov) = _delivery_phase(state, eng, views, ctx, fd,
                                               shifts, round_idx, params, kn,
                                               world, draws)
    with record_function("swim.merge"):
        new_state, refuted = _merge_and_timers(
            state, ctx, inbox, inbox_alive, g_delivered, round_idx, params,
            kn, world, lhm_signals=(fd["ping_req_launches"],
                                    fd["lhm_clean"]))
    aux = dict(
        messages_gossip=n_gossip_sent,
        messages_ping=fd["active"].sum(dtype=torch.int32),
        messages_ping_sent=fd["probes_sent"].sum(dtype=torch.int32),
        messages_ping_req_sent=(fd["ping_req_launches"].sum(dtype=torch.int32)
                                * params.ping_req_members),
        refutations=(refuted & ctx["alive"]).sum(dtype=torch.int32),
    )
    if ae_sent is not None:
        aux["messages_anti_entropy"] = ae_sent
    if link is not None:
        aux["sent_by_node"] = (link[0] + fd["probes_sent"].to(torch.int32)
                               + fd["ping_req_launches"].to(torch.int32)
                               * params.ping_req_members)
        aux["lost_by_node"] = link[1]
    if prov is not None:
        aux["_provenance"] = _exposure(fd["fd_inbox"], prov["gossip"],
                                       prov["sync"], fd["ping_req_launches"])
    return _metadata_phase(new_state, md_delivered, ctx, round_idx, params,
                           aux)


def _exposure(fd, gossip, sync, ping_req) -> dict:
    """The provenance knob's per-channel evidence of one round
    (``models/provenance.py``): the FD verdicts, the gossip channels' and
    the SYNC family's max-folded arrivals ([N, K], the wire dtype, -1 = no
    message) and the rows whose direct probe failed (``ping_req`` [N]
    bool)."""
    return dict(fd=fd, gossip=gossip, sync=sync, ping_req=ping_req)


def _metadata_phase(new_state: SwimState, md_delivered, ctx: dict,
                    round_idx: int, params: SwimParams, aux: dict):
    """The metadata plane's merge and metric, under ``swim.metadata``:
    ``metadata.merge`` of the round's delivered words against the merge
    kernel's post-merge epoch lane (with the epoch guard on), with the
    kernel's self cells and frozen rows, then ``metadata_divergent`` of
    the merged table into ``aux``.  ``new_state`` holds the round's
    input md lanes; nothing runs with the plane off.  Returns
    ``(new_state, aux)``."""
    if params.metadata_keys == 0:
        return new_state, aux
    alive = ctx["alive"]
    with record_function("swim.metadata"):
        md, md_spread = metadata.merge(
            new_state.md, new_state.md_spread, md_delivered, round_idx,
            params, ctx["is_self"],
            new_state.epoch if params.epoch_bits else None, ~alive)
        aux = dict(aux, metadata_divergent=metadata.divergent_count(
            md, alive, alive))
    return dataclasses.replace(new_state, md=md, md_spread=md_spread), aux


def _tick_shift_blocked(state: SwimState, ctx: dict, round_idx: int,
                        params: SwimParams, kn: Knobs, world: SwimWorld,
                        draws: prng.RoundDraws):
    """The shift round as a loop over [N, Kb] column blocks of the full-
    view carry (``k_block = Kb``; the reference's ``_tick_shift_blocked``),
    giving ``_tick_shift``'s states and metrics exactly: the shifts rotate
    rows, so each column block's delivery and merge is independent of
    the others, and every draw is K-independent.

    The FD chains and every channel's gates are [N] vectors made once
    (the FD target's entry read from the raw carry), as are the merge's
    plane arguments (Lifeguard's armed rounds, the suppression window).
    Each block is decoded (compact carry), pinned, turned into payloads,
    delivered over the F gossip channels, the refute push, the SYNC
    channel and, on its rounds, the anti-entropy pair with the FD
    verdicts on its columns, merged (the merge kernel in block form,
    writing the output carry's columns) and encoded into the output
    carry; its column reductions fill the metric histograms.  ``self_inc``
    is the maximum and ``refuted`` the or over the blocks, each block
    reading the pre-round ``self_inc``; the ``lhm`` lane is updated once,
    after the loop, with that or.  The output carry is allocated
    once a round, so the input state is not modified.  Returns
    ``(new_state, aux counters)``, the column reductions in
    ``aux["hists"]``."""
    if ctx["is_seed"] is not None:
        raise NotImplementedError(
            "k_block does not support seed-gated contacts (the gate reads a "
            "full-status column per channel)")
    shifts, eng, (d_ids, d_alive, d_part) = _shift_setup(ctx, params, world,
                                                         draws)
    n, k, kb = params.n_members, params.n_subjects, params.k_block
    r_proxies, f = params.ping_req_members, params.fanout
    node_ids, alive_here = ctx["node_ids"], ctx["alive"]
    part_here = ctx["part"]
    fd_shift, sync_shift = shifts[0], shifts[-1]
    gossip_shifts = shifts[1 + r_proxies:1 + r_proxies + f]
    compact, wf = params.compact_carry, params.wire_format
    eb = params.epoch_bits
    no_msg = delivery.no_message(wf)
    device = node_ids.device

    with record_function("swim.fd"):
        ping_budget, ping_req_budget, gate = lifeguard.lha_probe_setup(
            params, ctx["lhm"], draws.lhm_gate_u,
            *knob_probe_budgets(kn, params))
        t, _, _, direct_ok, ack_ok = _shift_fd_chains(
            eng, d_ids, d_alive, d_part, fd_shift,
            shifts[1:1 + r_proxies], draws, params, kn, world, round_idx,
            node_ids, part_here, ping_budget, ping_req_budget)
        entry_t_status = _entry_at_slot(state.status, t)
        entry_t_inc = _entry_at_slot(state.inc, t).to(torch.int32)
        has_target = ((entry_t_status == records.ALIVE)
                      | (entry_t_status == records.SUSPECT))
        active = has_target & alive_here & ctx["fd_round"]
        if gate is not None:
            active = active & gate
        verdict_suspect = active & ~ack_ok
        push_refute = _buddy_push(
            active & ack_ok & (entry_t_status == records.SUSPECT), params,
            kn)
        ping_req_launches = active & ~direct_ok
        fd_key = delivery.pack_record(
            records.SUSPECT, entry_t_inc, fmt=wf,
            epoch=_held_epoch(state.epoch, t, params),
            epoch_bits=params.epoch_bits)

    with record_function("swim.delivery"):
        # The channels' receiver-indexed gates, as in _delivery_phase.
        def gate(s):
            return _shift_sender_gate(eng, d_ids, d_alive, d_part, s,
                                      node_ids, kn, params, world,
                                      round_idx)

        drop_u = draws.drop_u
        ok_gossip = []
        for c, s in enumerate(gossip_shifts):
            _, sender_alive, sender_part, loss_c, _ = gate(s)
            ok_gossip.append(sender_alive & alive_here
                             & (sender_part == part_here)
                             & (drop_u[:, c] >= loss_c) & (c < kn.fanout))
        h_pushers = eng.prep(push_refute)
        _, sender_alive, sender_part, loss_r, _ = gate(fd_shift)
        ok_refute = (sender_alive & alive_here & (sender_part == part_here)
                     & ~(draws.u_refute < loss_r)
                     & eng.deliver(h_pushers, fd_shift))
        sender_refuting = eng.deliver(h_pushers, sync_shift)
        _, sender_alive, sender_part, loss_sy, _ = gate(sync_shift)
        ok_sync = (sender_alive & alive_here & ~sender_refuting
                   & (sender_part == part_here) & ~(drop_u[:, f] < loss_sy)
                   & ctx["sync_round"])
        channels = ([(s, 1, ok[:, None]) for s, ok in zip(gossip_shifts,
                                                          ok_gossip)]
                    + [(fd_shift, 2, ok_refute[:, None]),
                       (sync_shift, 2, ok_sync[:, None])])
        # The anti-entropy pair's gates, in the reference's order.
        ae_sent = None
        if params.sync_interval > 0:
            ae_sent = sync_plane.sent_count(ctx["ae_due"], alive_here)
        if ctx["ae_due"]:
            for d_i, sft in enumerate(_ae_shifts(draws, n)):
                ok_ae, _, _ = _ae_gate(eng, (d_ids, d_alive, d_part), sft,
                                       draws.ae_drop_u[d_i], ctx, kn,
                                       params, world, round_idx)
                channels.append((sft, 2, ok_ae[:, None]))
        g_delivered = hot_g = None
        if params.n_user_gossips > 0:
            hot_g = (ctx["g_infected"] & alive_here[:, None]
                     & (round_idx < ctx["g_spread_until"]))
            h_g = eng.prep(hot_g)
            g_delivered = torch.zeros((n, params.n_user_gossips),
                                      dtype=torch.bool, device=device)
            for s, ok in zip(gossip_shifts, ok_gossip):
                g_delivered |= eng.deliver(h_g, s) & ok[:, None]

    new = SwimState(
        status=torch.empty_like(state.status),
        inc=torch.empty_like(state.inc),
        spread_until=torch.empty_like(state.spread_until),
        suspect_deadline=torch.empty_like(state.suspect_deadline),
        self_inc=state.self_inc, inbox_ring=state.inbox_ring,
        flag_ring=state.flag_ring, g_infected=state.g_infected,
        g_spread_until=state.g_spread_until, g_ring=state.g_ring,
        lhm=state.lhm,
        epoch=torch.empty_like(state.epoch) if eb else state.epoch,
        md=state.md, md_spread=state.md_spread)
    plane_args = _merge_plane_args(ctx, params, kn)
    hists = {name: torch.zeros((k,), dtype=torch.int32, device=device)
             for name in ("hist_alive", "hist_suspect", "hist_dead",
                          "still_suspect")}
    hot_any = torch.zeros((n,), dtype=torch.bool, device=device)
    refuted = torch.zeros((n,), dtype=torch.bool, device=device)
    self_inc = state.self_inc
    # The provenance accumulators, filled block by block (the gossip
    # channels carry tx bit 1, the SYNC family bit 2).
    prov = None
    if params.provenance:
        prov = {name: torch.full((n, k), no_msg, dtype=wf.dtype,
                                 device=device)
                for name in ("gossip", "sync")}
    for c0 in range(0, k, kb):
        blk = slice(c0, c0 + kb)
        with record_function("swim.carry"):
            timers = (state.inc[:, blk], state.spread_until[:, blk],
                      state.suspect_deadline[:, blk])
            if compact:
                timers = carry.carry_decode(*timers, round_idx)
            # The block's raw epoch lane (compact: the codec's plain
            # int16 -> int32 cast).
            epoch_b = None
            if eb:
                epoch_b = state.epoch[:, blk]
                if compact:
                    epoch_b = epoch_b.to(torch.int32)
        with record_function("swim.delivery"):
            inc_b, spread_b, deadline_b = timers
            cols = torch.arange(c0, c0 + kb, dtype=torch.int32,
                                device=device)
            is_self_b = cols[None, :] == node_ids[:, None]
            status_b = torch.where(is_self_b, records.ALIVE,
                                   state.status[:, blk]).to(torch.int8)
            inc_b = torch.where(is_self_b, state.self_inc[:, None], inc_b)
            record_keys, hot, syncable = _send_components(
                dataclasses.replace(state, spread_until=spread_b), status_b,
                inc_b, round_idx, params, world, is_self_b, epoch_b,
                ctx["own_epoch"])
            hot_any |= hot.any(dim=1)
            h_keys = eng.prep(record_keys)
            h_tx = eng.prep(hot.to(torch.int8)
                            | (syncable.to(torch.int8) << 1))
            inbox = torch.where((cols[None, :] == t[:, None])
                                & verdict_suspect[:, None],
                                fd_key[:, None], no_msg)
            inbox_alive = torch.zeros((n, kb), dtype=torch.bool,
                                      device=device)
            for s, tx_bit, ok in channels:
                tx = (eng.deliver(h_tx, s) & tx_bit) != 0
                payload = torch.where(tx & ok, eng.deliver(h_keys, s),
                                      no_msg)
                inbox = torch.maximum(inbox, payload)
                if prov is not None:
                    family = prov["gossip" if tx_bit == 1 else "sync"][:, blk]
                    family.copy_(torch.maximum(family, payload))
                inbox_alive |= delivery.is_alive_key(payload, fmt=wf)
        with record_function("swim.merge"):
            # The new planes go straight into the output carry's columns
            # (compact: the status; the wide timers to the encode).
            if compact:
                timers_out = tuple(torch.empty((n, kb), dtype=torch.int32,
                                               device=device)
                                   for _ in range(3))
            else:
                timers_out = (new.inc[:, blk], new.spread_until[:, blk],
                              new.suspect_deadline[:, blk])
            if eb:
                timers_out += ((torch.empty((n, kb), dtype=torch.int32,
                                            device=device) if compact
                                else new.epoch[:, blk]),)
            merged = merge_kernel.merge_and_timers(
                status_b, inc_b, spread_b, deadline_b, inbox, inbox_alive,
                state.self_inc, alive_here, world.slot_of_node, round_idx,
                kn.suspicion_rounds, params.periods_to_spread,
                _wire_inc_sat(params), fmt=wf, col0=c0,
                out=(new.status[:, blk], *timers_out), **plane_args,
                **_epoch_args(epoch_b, ctx))
            self_inc = torch.maximum(self_inc, merged[4])
            refuted |= merged[5]
        if compact:
            with record_function("swim.carry"):
                carry.carry_encode(
                    *merged[1:4], round_idx, _wire_inc_sat(params),
                    out=(new.inc[:, blk], new.spread_until[:, blk],
                         new.suspect_deadline[:, blk]))
                if eb:
                    new.epoch[:, blk] = merged[6]
        with record_function("swim.metrics"):
            for name, value in _column_hists(merged[0], status_b,
                                             alive_here).items():
                hists[name][blk] = value

    with record_function("swim.delivery"):
        if hot_g is not None:
            hot_any |= hot_g.any(dim=1)
        h_hot_any = eng.prep(hot_any)
        n_gossip_sent = torch.zeros((), dtype=torch.int32, device=device)
        for s, ok in zip(gossip_shifts, ok_gossip):
            n_gossip_sent += (ok & eng.deliver(h_hot_any, s)).sum(
                dtype=torch.int32)
    g_infected, g_spread_until = _gossip_lanes(ctx, g_delivered, round_idx,
                                               params)
    new = dataclasses.replace(
        new, self_inc=self_inc, g_infected=g_infected,
        g_spread_until=g_spread_until,
        lhm=_lhm_update(ctx, (ping_req_launches, active & direct_ok),
                        refuted, params, kn))
    aux = dict(
        messages_gossip=n_gossip_sent,
        messages_ping=active.sum(dtype=torch.int32),
        messages_ping_sent=active.sum(dtype=torch.int32),
        messages_ping_req_sent=(ping_req_launches.sum(dtype=torch.int32)
                                * r_proxies),
        refutations=(refuted & alive_here).sum(dtype=torch.int32),
        hists=hists,
    )
    if ae_sent is not None:
        aux["messages_anti_entropy"] = ae_sent
    if prov is not None:
        # One FD verdict a row, built whole.
        fd_inbox = torch.where(
            (torch.arange(k, dtype=torch.int32, device=device)[None, :]
             == t[:, None]) & verdict_suspect[:, None], fd_key[:, None],
            no_msg)
        aux["_provenance"] = _exposure(fd_inbox, prov["gossip"],
                                       prov["sync"], ping_req_launches)
    return new, aux


def _wire_inc_sat(params: SwimParams) -> int:
    """Largest incarnation the wire format and the carry layout both hold
    exactly: the self-refutation bump and the carry encode clamp here.
    8191 on the int16 wire; 32767 (the int16 carry) under wire24.  The
    epoch field is carved out of the incarnation field, so with the
    epoch guard on: 8,388,607 wide, 2,047 on the int16 wire, 32,767
    under wire24."""
    sat = params.wire_format.inc_sat(params.epoch_bits)
    if params.compact_carry:
        sat = min(sat, _CARRY16_INC_SAT)
    return sat


def _wide_timer_fields(state: SwimState, params: SwimParams, cursor: int):
    """``(suspect_deadline, spread_until)`` as absolute int32 rounds at
    ``cursor`` in either layout: the wide carry passes through, the
    compact carry decodes as ``carry_decode`` does."""
    if not params.compact_carry:
        return state.suspect_deadline, state.spread_until
    dl = state.suspect_deadline.to(torch.int32)
    dl = torch.where(dl == _DEADLINE_NONE16, INT32_MAX, cursor + dl)
    return dl, cursor + state.spread_until.to(torch.int32)


def _carry_decode(state: SwimState, round_idx: int) -> SwimState:
    """compact -> wide at the round's cursor (one kernel launch; the
    epoch lane, an absolute counter, is a plain int16 -> int32 cast)."""
    inc, spread_until, deadline = carry.carry_decode(
        state.inc, state.spread_until, state.suspect_deadline, round_idx)
    return dataclasses.replace(state, inc=inc, spread_until=spread_until,
                               suspect_deadline=deadline,
                               epoch=_cast_epoch(state.epoch, torch.int32))


def _carry_encode(state: SwimState, round_idx: int,
                  inc_sat: int) -> SwimState:
    """wide -> compact relative to the next round (one kernel launch; the
    epoch lane narrows by a plain cast)."""
    inc, spread_until, deadline = carry.carry_encode(
        state.inc, state.spread_until, state.suspect_deadline, round_idx,
        inc_sat)
    return dataclasses.replace(state, inc=inc, spread_until=spread_until,
                               suspect_deadline=deadline,
                               epoch=_cast_epoch(state.epoch, torch.int16))


def _cast_epoch(epoch: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The epoch lane in ``dtype``; the zero-size lane of the plane off
    stays int32."""
    return epoch if epoch.shape[1] == 0 else epoch.to(dtype)


def _gossip_lanes(ctx: dict, g_delivered, round_idx: int,
                  params: SwimParams):
    """``(g_infected, g_spread_until)`` after the round: newly held user
    gossips open a spread window, rows of crashed members stay frozen
    (``g_delivered`` None: no user gossips, the lanes pass through)."""
    g_infected, g_spread_until = ctx["g_infected"], ctx["g_spread_until"]
    if g_delivered is not None:
        live = ctx["alive"][:, None]
        newly = g_delivered & ~g_infected & live
        g_spread_until = torch.where(
            newly, round_idx + 1 + params.periods_to_spread, g_spread_until)
        g_infected = g_infected | (g_delivered & live)
    return g_infected, g_spread_until


def _merge_plane_args(ctx: dict, params: SwimParams, kn: Knobs):
    """The merge kernel's plane arguments for the round: ``armed_rounds``
    (Lifeguard on: [N] int32 ``lifeguard.suspicion_deadline_rounds`` of
    each row's multiplier and the live count, once a round; else None)
    and ``dead_suppress_rounds`` (the window, 0 with suppression off)."""
    armed = None
    if params.lhm_max > 0:
        armed = lifeguard.suspicion_deadline_rounds(
            kn.suspicion_rounds, ctx["lhm"],
            ctx["alive"].sum(dtype=torch.int32), params.n_members)
    window = 0
    if params.dead_suppress_rounds > 0:
        window = knob_dead_suppress(kn, params)
        if window <= 0:
            raise ValueError(
                f"Knobs.dead_suppress_rounds={kn.dead_suppress_rounds} under "
                f"params.dead_suppress_rounds={params.dead_suppress_rounds}: "
                f"a window of 0 with the plane on is not carried")
    return dict(armed_rounds=armed, dead_suppress_rounds=window)


def _epoch_args(epoch, ctx: dict) -> dict:
    """The merge kernel's epoch-form arguments (the raw int32 lane and
    each row's own epoch), empty with the epoch guard off."""
    if ctx["own_epoch"] is None:
        return {}
    return dict(epoch=epoch, own_epoch=ctx["own_epoch"])


def _lhm_update(ctx: dict, lhm_signals, refuted, params: SwimParams,
                kn: Knobs):
    """The ``lhm`` lane after the round (``lifeguard.update`` with the FD
    phase's ``(probe_fail, probe_clean)`` signals); passes through with
    the plane off."""
    if params.lhm_max == 0:
        return ctx["lhm"]
    probe_fail, probe_clean = lhm_signals
    alive = ctx["alive"]
    return lifeguard.update(ctx["lhm"], probe_fail, probe_clean,
                            refuted & alive, alive, knob_lhm_cap(kn, params))


def _merge_and_timers(state: SwimState, ctx: dict, inbox, inbox_alive,
                      g_delivered, round_idx: int, params: SwimParams,
                      kn: Knobs, world: SwimWorld, lhm_signals):
    """Inbox merge, self-refutation, suspicion timers (per-row armed
    rounds with Lifeguard on, the suppression window with
    ``dead_suppress_rounds``, the epoch gate and the epoch lane with the
    epoch guard on) and the crash/leave freeze in one kernel launch
    (``kernels/merge.py``), then the user-gossip lanes (newly held
    gossips open a spread window, rows of crashed members stay frozen)
    and the ``lhm`` lane (``lhm_signals``: the FD phase's ``(probe_fail,
    probe_clean)`` [N] masks).  The rings pass through (delivery updated
    them in place), and so do the metadata lanes (``_metadata_phase``
    merges them).  Returns ``(new_state, refuted [N] bool)``."""
    alive_here = ctx["alive"]
    (new_status, new_inc, spread_until, deadline, self_inc, refuted,
     *epoch) = merge_kernel.merge_and_timers(
        ctx["status"], ctx["inc"], state.spread_until,
        state.suspect_deadline, inbox, inbox_alive, state.self_inc,
        alive_here, world.slot_of_node, round_idx, kn.suspicion_rounds,
        params.periods_to_spread, _wire_inc_sat(params),
        fmt=params.wire_format, **_merge_plane_args(ctx, params, kn),
        **_epoch_args(state.epoch, ctx))
    g_infected, g_spread_until = _gossip_lanes(ctx, g_delivered, round_idx,
                                               params)
    return SwimState(status=new_status, inc=new_inc, spread_until=spread_until,
                     suspect_deadline=deadline, self_inc=self_inc,
                     inbox_ring=state.inbox_ring, flag_ring=state.flag_ring,
                     g_infected=g_infected, g_spread_until=g_spread_until,
                     g_ring=state.g_ring,
                     lhm=_lhm_update(ctx, lhm_signals, refuted, params,
                                     kn),
                     epoch=epoch[0] if epoch else state.epoch,
                     md=state.md, md_spread=state.md_spread), refuted


def _column_hists(new_status, status, alive) -> dict:
    """The four column reductions of ``_round_metrics`` over [N, Kb]
    planes (the whole table, or one column block): live observers
    holding each subject ALIVE, SUSPECT, DEAD, and SUSPECT both after
    and before the merge (``status``: the pinned pre-merge status)."""
    observer_alive = alive[:, None]

    def col_sum(mask):
        return mask.sum(dim=0, dtype=torch.int32)

    suspect = new_status == records.SUSPECT
    return dict(
        hist_alive=col_sum((new_status == records.ALIVE) & observer_alive),
        hist_suspect=col_sum(suspect & observer_alive),
        hist_dead=col_sum((new_status == records.DEAD) & observer_alive),
        still_suspect=col_sum(suspect & (status == records.SUSPECT)
                              & observer_alive))


def _round_metrics(new_state: SwimState, status, aux: dict,
                   params: SwimParams, world: SwimWorld,
                   alive) -> Dict[str, torch.Tensor]:
    """Per-round observability counters from the post-merge state and the
    send-side counters; ``status`` is the pre-merge pinned status.  The
    blocked round hands its column reductions in as ``aux["hists"]``,
    made block by block.

    Four column reductions plus per-column post-ops: the self cell (pinned
    ALIVE) is subtracted after the reduce, and "absent" follows from the
    histogram identity."""
    hists = aux.get("hists")
    if hists is None:
        hists = _column_hists(new_state.status, status, alive)
    hist_alive, hist_suspect, hist_dead, still_suspect = (
        hists["hist_alive"], hists["hist_suspect"], hists["hist_dead"],
        hists["still_suspect"])
    subject_alive_i = alive[world.subject_ids.long()].to(torch.int32)
    live_observers = alive.sum(dtype=torch.int32)
    counts = {
        "alive": hist_alive - subject_alive_i,
        "suspect": hist_suspect,
        "dead": hist_dead,
        "absent": live_observers - hist_alive - hist_suspect - hist_dead,
    }
    # False positives: a live observer holds SUSPECT/DEAD about a live
    # subject; onsets count new suspicions this round.
    false_suspect_rounds = hist_suspect * subject_alive_i
    stale_view_rounds = hist_dead * subject_alive_i
    onsets = (hist_suspect - still_suspect) * subject_alive_i
    if not params.per_subject_metrics:
        def total(x):
            return x.sum(dtype=torch.int32)

        counts = {name: total(v) for name, v in counts.items()}
        false_suspect_rounds = total(false_suspect_rounds)
        stale_view_rounds = total(stale_view_rounds)
        onsets = total(onsets)
    metrics = dict(
        counts,
        false_positives=false_suspect_rounds + stale_view_rounds,
        false_suspicion_onsets=onsets,
        false_suspect_rounds=false_suspect_rounds,
        stale_view_rounds=stale_view_rounds,
        messages_gossip=aux["messages_gossip"],
        messages_ping=aux["messages_ping"],
        messages_ping_sent=aux["messages_ping_sent"],
        messages_ping_req_sent=aux["messages_ping_req_sent"],
        refutations=aux["refutations"],
    )
    if params.sync_interval > 0:
        metrics["messages_anti_entropy"] = aux["messages_anti_entropy"]
    if params.link_counters:
        metrics["sent_by_node"] = aux["sent_by_node"]
        metrics["lost_by_node"] = aux["lost_by_node"]
    if params.n_user_gossips > 0:
        # Per gossip, the members holding it.
        metrics["user_gossip_infected"] = new_state.g_infected.sum(
            dim=0, dtype=torch.int32)
    if params.metadata_keys > 0:
        metrics["metadata_divergent"] = aux["metadata_divergent"]
    if params.provenance:
        # The per-channel evidence, un-reduced; the composed runner pops
        # it before the metrics are stacked.
        metrics["_provenance"] = aux["_provenance"]
    return metrics


def metric_shapes(params: SwimParams) -> Dict[str, Tuple[int, ...]]:
    """Each metric ``_round_metrics`` gives a round, in its order, with
    its shape (every metric is int32): what a zero-round run returns
    with a leading 0, made from the params alone."""
    per = (params.n_subjects,) if params.per_subject_metrics else ()
    shapes = {name: per for name in (
        "alive", "suspect", "dead", "absent", "false_positives",
        "false_suspicion_onsets", "false_suspect_rounds",
        "stale_view_rounds")}
    shapes.update((name, ()) for name in (
        "messages_gossip", "messages_ping", "messages_ping_sent",
        "messages_ping_req_sent", "refutations"))
    if params.sync_interval > 0:
        shapes["messages_anti_entropy"] = ()
    if params.link_counters:
        shapes["sent_by_node"] = shapes["lost_by_node"] = (params.n_members,)
    if params.n_user_gossips > 0:
        shapes["user_gossip_infected"] = (params.n_user_gossips,)
    if params.metadata_keys > 0:
        shapes["metadata_divergent"] = ()
    return shapes


def _decoded(state: SwimState, round_idx: int,
             params: SwimParams) -> SwimState:
    """The round's input carry in the wide layout (decoded if compact;
    under ``k_block`` the blocked round decodes block by block)."""
    if not params.compact_carry or params.k_block:
        return state
    with record_function("swim.carry"):
        return _carry_decode(state, round_idx)


def _encoded(state: SwimState, round_idx: int,
             params: SwimParams) -> SwimState:
    """The round's output carry in the params' layout (encoded if
    compact and not already encoded block by block)."""
    if not params.compact_carry or params.k_block:
        return state
    with record_function("swim.carry"):
        return _carry_encode(state, round_idx, _wire_inc_sat(params))


def _wide_tick(state: SwimState, round_idx: int, params: SwimParams,
               world: SwimWorld, draws: prng.RoundDraws, kn: Knobs,
               join_rows: Optional[torch.Tensor] = None, pushes=()
               ) -> Tuple[SwimState, Dict[str, torch.Tensor]]:
    """One round on the wide carry (under ``k_block``, on the stored
    carry block by block); the input planes are free once this returns
    (the compact carry is encoded only after that).  ``join_rows``: the
    rows whose join fires this round (``SwimWorld.join_rows``), reset
    first under the open-world plane; None on a round without one.
    ``pushes``: the round's config pushes (``SwimWorld.push_rows``),
    written next under the metadata plane."""
    with record_function("swim.context"):
        if params.open_world and join_rows is not None:
            state = _apply_joins(state, join_rows, round_idx, params, world)
    if params.metadata_keys > 0 and pushes:
        with record_function("swim.metadata"):
            state = _inject_pushes(state, pushes, round_idx, params, world)
    with record_function("swim.context"):
        ctx = _round_context(state, round_idx, params, world, kn)
    if params.k_block:
        tick = _tick_shift_blocked
    else:
        tick = _tick_scatter if params.delivery == "scatter" else _tick_shift
    new_state, aux = tick(state, ctx, round_idx, params, kn, world, draws)
    with record_function("swim.metrics"):
        metrics = _round_metrics(new_state, ctx["status"], aux, params,
                                 world, ctx["alive"])
    return new_state, metrics


def _own_rings(state: SwimState) -> SwimState:
    """``state`` with copies of its delay rings, which a round updates in
    place (the input state's rings stay as they were)."""
    if state.inbox_ring.shape[0] == 0:
        return state
    return dataclasses.replace(state, inbox_ring=state.inbox_ring.clone(),
                               flag_ring=state.flag_ring.clone(),
                               g_ring=state.g_ring.clone())


def _schedules(params: SwimParams, world: SwimWorld):
    """``(joins, pushes)``: the join and config-push schedules read to the
    host once (empty where their plane is off)."""
    return (world.join_rows() if params.open_world else {},
            world.push_rows() if params.metadata_keys > 0 else {})


def swim_tick(state: SwimState, round_idx: int, params: SwimParams,
              world: SwimWorld, draws: prng.RoundDraws,
              knobs: Optional[Knobs] = None
              ) -> Tuple[SwimState, Dict[str, torch.Tensor]]:
    """One protocol round: (state, round, draws) -> (state', metrics);
    ``state`` is not modified."""
    check_lanes(state, params)
    kn = knobs if knobs is not None else Knobs.from_params(params)
    joins, pushes = _schedules(params, world)
    new_state, metrics = _wide_tick(
        _decoded(_own_rings(state), round_idx, params), round_idx, params,
        world, draws, kn, joins.get(round_idx), pushes.get(round_idx, ()))
    return _encoded(new_state, round_idx, params), metrics


def run(seed: int, params: SwimParams, world: SwimWorld, n_rounds: int,
        state: Optional[SwimState] = None, start_round: int = 0,
        draws: Optional[Callable[[int], prng.RoundDraws]] = None,
        knobs: Optional[Knobs] = None, shift_key: Optional[int] = None,
        device="cuda") -> Tuple[SwimState, Dict[str, torch.Tensor]]:
    """Run ``n_rounds`` rounds from ``start_round``.

    Returns ``(final_state, metrics)`` with every metric stacked on the
    device as ``[n_rounds, ...]`` (a zero-round run gives every metric
    with a leading 0); nothing syncs with the host per round.
    ``draws`` (default ``TorchDraws(seed, device, params, world)``) is
    any callable ``round_idx -> RoundDraws``.  ``shift_key`` (an int,
    default ``seed``) seeds only the port's own draws of the channel
    shifts and the anti-entropy offset (the reference's ``shift_key``,
    the shared-shift hook of ``sweep.sweep_run``).  ``knobs`` (default
    ``Knobs.from_params(params)``) are the schedule values the round
    reads.  ``state``/``start_round`` resume a run; ``state`` is not
    modified (its rings are copied once, then updated in place round
    after round), and each carry is released as soon as the next one
    exists.  The composed plane runner with no planes
    (``models/compose.composed_scan``)."""
    from scalecube_cluster_tpu_torch.models import compose

    final_state, _, metrics = compose.composed_scan(
        seed, params, world, n_rounds, planes=(), state=state,
        start_round=start_round, draws=draws, knobs=knobs,
        shift_key=shift_key, device=device)
    return final_state, metrics


def run_traced(seed: int, params: SwimParams, world: SwimWorld,
               n_rounds: int, trace_capacity: Optional[int] = None,
               state: Optional[SwimState] = None, start_round: int = 0,
               draws: Optional[Callable[[int], prng.RoundDraws]] = None,
               knobs: Optional[Knobs] = None, telemetry=None,
               shift_key: Optional[int] = None, device="cuda"):
    """``run`` with the membership event trace riding the rounds
    (``telemetry/trace.TracePlane``): each round's net cell transitions
    are coded, recorded into the fixed-capacity event buffer (overflow
    counted, never silent) and folded into the first-suspect and
    first-removed round matrices.

    Returns ``(final_state, telemetry_state, metrics)``.  ``telemetry``
    resumes an earlier trace (a previous chunk's result, or
    ``TelemetryState.resume``); its tensors are cloned once and not
    modified.  ``trace_capacity`` (default
    ``telemetry.trace.DEFAULT_CAPACITY``) sizes a fresh buffer.  For
    long runs, ``telemetry/sink.stream_traced_run`` drives this in
    segments with each segment's offload overlapped against the next
    one's rounds."""
    from scalecube_cluster_tpu_torch.models import compose
    from scalecube_cluster_tpu_torch.telemetry import trace as ttrace

    plane = ttrace.TracePlane(
        capacity=(ttrace.DEFAULT_CAPACITY if trace_capacity is None
                  else trace_capacity),
        telemetry=telemetry)
    final_state, results, metrics = compose.composed_scan(
        seed, params, world, n_rounds, planes=(plane,), state=state,
        start_round=start_round, draws=draws, knobs=knobs,
        shift_key=shift_key, device=device)
    return final_state, results["trace"], metrics


def run_metered(seed: int, params: SwimParams, world: SwimWorld,
                n_rounds: int, spec=None, state: Optional[SwimState] = None,
                start_round: int = 0,
                draws: Optional[Callable[[int], prng.RoundDraws]] = None,
                knobs: Optional[Knobs] = None, metrics_state=None,
                shift_key: Optional[int] = None, device="cuda"):
    """``run`` with the health-metrics registry riding the rounds
    (``telemetry/metrics.MetricsPlane``): each round folds its probe
    outcomes, gossip and refutation counters, suspicion transitions and
    the suspicion-lifetime histogram into the registry; the gauges are
    sampled once from the final carry.  ``spec`` declares the registry
    (default ``MetricsSpec.default()``).  The state and metrics equal
    ``run``'s.

    Returns ``(final_state, metrics_state, metrics)``.
    ``metrics_state`` resumes a registry (not modified);
    ``telemetry/metrics.stream_metered_run`` drives this in flush
    windows."""
    from scalecube_cluster_tpu_torch.models import compose
    from scalecube_cluster_tpu_torch.telemetry import metrics as tmetrics

    plane = tmetrics.MetricsPlane(
        tmetrics.MetricsSpec.default() if spec is None else spec,
        metrics_state=metrics_state)
    final_state, results, metrics = compose.composed_scan(
        seed, params, world, n_rounds, planes=(plane,), state=state,
        start_round=start_round, draws=draws, knobs=knobs,
        shift_key=shift_key, device=device)
    return final_state, results["metrics"], metrics


def node_snapshot(state: SwimState, params: SwimParams, world: SwimWorld,
                  node_id: int, round_idx: Optional[int] = None) -> dict:
    """Host-side digest of one observer row (the reference's
    ``node_snapshot``, after MembershipProtocolImpl's JMX monitor):
    incarnation, the members held ALIVE, SUSPECT, DEAD and ABSENT, the
    pending suspicion timers and the held incarnations, and with the
    epoch guard on the held identity epochs (``record_epochs``).

    ``round_idx`` is the round cursor the state is encoded against (the
    number of rounds run so far); it is required for a ``compact_carry``
    state, whose timers are relative, and optional for the wide one.
    Only row ``node_id`` is copied to the host and decoded."""
    row = slice(node_id, node_id + 1)
    inc, deadline = state.inc[row].cpu(), state.suspect_deadline[row].cpu()
    if params.compact_carry:
        if round_idx is None:
            raise ValueError(
                "node_snapshot of a compact_carry state needs round_idx "
                "(the cursor its relative encodings decode against); pass "
                "the number of rounds executed so far")
        inc, _, deadline = carry.carry_decode(
            inc, state.spread_until[row].cpu(), deadline, round_idx)
    status = state.status[node_id].cpu().tolist()
    inc, deadline = inc[0].tolist(), deadline[0].tolist()
    subjects = world.subject_ids.cpu().tolist()

    def ids_with(code):
        return [s for s, st in zip(subjects, status)
                if st == code and s != node_id]

    snapshot = {
        "node_id": int(node_id),
        "incarnation": int(state.self_inc[node_id]),
        "alive_members": ids_with(records.ALIVE),
        "suspected_members": ids_with(records.SUSPECT),
        "dead_tombstones": ids_with(records.DEAD),
        "unknown_members": ids_with(records.ABSENT),
        "pending_suspicion_timers": {
            s: d for s, d in zip(subjects, deadline) if d != INT32_MAX},
        "record_incarnations": {
            s: i for s, i, st in zip(subjects, inc, status)
            if st != records.ABSENT},
    }
    if params.epoch_bits:
        epochs = state.epoch[node_id].cpu().tolist()
        snapshot["record_epochs"] = {
            s: e for s, e, st in zip(subjects, epochs, status)
            if st != records.ABSENT}
    return snapshot
