"""The SWIM round on PyTorch tensors: failure detection, gossip, SYNC,
merge, suspicion timers.

Counterpart of ``scalecube_cluster_tpu/models/swim.py`` for the main
path: shift delivery (``delivery="shift"``), no delivery delays and no
optional planes, in both the focal shape (N members x K tracked
subjects) and full view (K == N).  State is [N, K] per observer row and
subject column (``SwimState``); the world holds the ground truth and the
fault schedule (``SwimWorld``).

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
below its cap.

Each round (``swim_tick``):

0. ``kernels/carry.carry_decode`` (compact carry only);
1. ``_round_context``: liveness and partition slices, the self-record
   pin, the FD and SYNC phase gates;
2. ``_fd_phase``: the FD probe chains and their SUSPECT verdicts;
3. ``_delivery_phase``: F gossip channels, the refute push and the SYNC
   channel over cyclic shifts, max-folded into one inbox of the wire
   format's dtype;
4. ``_merge_and_timers``: the CUDA kernel ``kernels/merge.py``, one
   instance per wire format (its plain PyTorch version for CPU tensors);
5. ``_round_metrics``: the per-round observability counters;
6. ``kernels/carry.carry_encode`` (compact carry only).

Each phase runs under a ``torch.profiler.record_function`` range
(``swim.carry``, ``swim.context``, ``swim.fd``, ``swim.delivery``,
``swim.merge``, ``swim.metrics``), which ``profile_round.py`` reads.

Randomness comes from a ``RoundDraws`` per round (``ops/prng.py``):
``run(..., draws=None)`` uses the port's ``TorchDraws``; any callable
``round_idx -> RoundDraws`` can stand in, which is how the tests feed the
reference's own draws and hold the state and metrics bit-identical.

Settings outside this slice raise ``NotImplementedError`` naming the
knob: ``delivery="scatter"``, ``max_delay_rounds > 0``,
``mean_delay_ms > 0``, ``k_block``, ``n_user_gossips``,
``sync_interval``, ``lhm_max``, ``dead_suppress_rounds``,
``open_world``, ``metadata_keys``, ``provenance``, ``link_counters``,
and worlds with seeds or link-fault rules.  ``rounds_per_step`` is accepted and ignored: the reference's
outputs are bit-identical for any value.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from scalecube_cluster_tpu_torch import records
from scalecube_cluster_tpu_torch.kernels import carry
from scalecube_cluster_tpu_torch.kernels import merge as merge_kernel
from scalecube_cluster_tpu_torch.ops import delivery
from scalecube_cluster_tpu_torch.ops import prng
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

# Knobs whose non-default values select code the port does not carry.
_UNPORTED = (
    ("max_delay_rounds", lambda p: p.max_delay_rounds > 0),
    ("mean_delay_ms", lambda p: p.mean_delay_ms > 0),
    ("k_block", lambda p: p.k_block != 0),
    ("n_user_gossips", lambda p: p.n_user_gossips != 0),
    ("sync_interval", lambda p: p.sync_interval != 0),
    ("lhm_max", lambda p: p.lhm_max != 0),
    ("dead_suppress_rounds", lambda p: p.dead_suppress_rounds != 0),
    ("open_world", lambda p: p.open_world),
    ("metadata_keys", lambda p: p.metadata_keys != 0),
    ("provenance", lambda p: p.provenance),
    ("link_counters", lambda p: p.link_counters),
)


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
        if self.delivery == "scatter":
            raise NotImplementedError(
                "delivery='scatter' is not ported; use delivery='shift'")
        for name, selected in _UNPORTED:
            if selected(self):
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported (the port "
                    f"carries the plane-off wide-carry shift round)")
        if self.ping_known_only != self.full_view:
            raise ValueError(
                f"shift delivery requires ping_known_only == full_view "
                f"(got ping_known_only={self.ping_known_only}, "
                f"n_subjects={self.n_subjects}, n_members={self.n_members})")
        if self.n_members < 2:
            raise ValueError("shift delivery needs n_members >= 2")
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
    """The schedule values the reference lets vary as data, here plain
    host values taken from the params (``from_params``)."""

    loss_probability: float
    suspicion_rounds: int
    ping_every: int
    sync_every: int
    fanout: int
    dead_suppress_rounds: int
    lhm_max: int
    ping_timeout_ms: float

    @staticmethod
    def from_params(params: SwimParams) -> "Knobs":
        return Knobs(
            loss_probability=float(params.loss_probability),
            suspicion_rounds=int(params.suspicion_rounds),
            ping_every=int(params.ping_every),
            sync_every=int(params.sync_every),
            fanout=int(params.fanout),
            dead_suppress_rounds=int(params.dead_suppress_rounds),
            lhm_max=int(params.lhm_max),
            ping_timeout_ms=float(params.ping_timeout_ms),
        )


def knob_ping_timeout(kn: Knobs, params: SwimParams) -> float:
    """Direct-ping budget (ms) clipped into [0, ping_interval_ms], so the
    indirect budget (interval - timeout) is never negative."""
    return min(max(kn.ping_timeout_ms, 0.0), params.ping_interval_ms)


def link_eval(src_ids, dst_ids, default_loss: float,
              default_delay_ms: float = 0.0):
    """(loss probability [float32], mean delay) per (src, dst) message,
    for a world without link-fault rules: the default loss everywhere,
    and ``None`` for the statically zero delay."""
    if default_delay_ms != 0.0:
        raise NotImplementedError("mean_delay_ms > 0 is not ported")
    shape = torch.broadcast_shapes(src_ids.shape, dst_ids.shape)
    loss = torch.full(shape, default_loss, dtype=torch.float32,
                      device=src_ids.device)
    return loss, None


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
    ``subject_ids`` [K] int32 (distinct) and ``slot_of_node`` [N] int32
    (slot -1 = not a tracked subject).
    """

    down_from: torch.Tensor
    down_until: torch.Tensor
    leave_at: torch.Tensor
    partition_of: torch.Tensor
    partition_phase_rounds: int
    subject_ids: torch.Tensor
    slot_of_node: torch.Tensor

    def __post_init__(self):
        n = self.down_from.shape[0]
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
        n, k = params.n_members, params.n_subjects
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
            subject_ids=subject_ids,
            slot_of_node=slot_of_node,
        )

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

    def with_seeds(self, seed_ids) -> "SwimWorld":
        raise NotImplementedError("seed_ids (seed-gated contacts) are not "
                                  "ported")

    def with_link_fault(self, *args, **kwargs) -> "SwimWorld":
        raise NotImplementedError("LinkFaults rules are not ported")

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
    """

    status: torch.Tensor
    inc: torch.Tensor
    spread_until: torch.Tensor
    suspect_deadline: torch.Tensor
    self_inc: torch.Tensor


def initial_state(params: SwimParams, world: SwimWorld, warm: bool = True,
                  device="cuda") -> SwimState:
    """Warm: everyone knows every subject ALIVE at incarnation 0.  Cold
    (``warm=False``, no seeds): rows are ABSENT except each node's own
    record, which is hot for a full spread window."""
    device = resolve_device(device)
    _check_world_device(world, device)
    n, k = params.n_members, params.n_subjects
    is_self = _is_self(world, n)
    fill = records.ALIVE if warm else records.ABSENT
    status = torch.full((n, k), fill, dtype=torch.int8, device=device)
    status = torch.where(is_self, records.ALIVE, status).to(torch.int8)
    spread0 = torch.zeros((n, k), dtype=torch.int32, device=device)
    if not warm:
        spread0 = torch.where(is_self, params.periods_to_spread + 1,
                              spread0).to(torch.int32)
    if params.compact_carry:
        # Remaining rounds from round 0 (re-relativized every round by
        # carry_encode).
        return SwimState(
            status=status,
            inc=torch.zeros((n, k), dtype=torch.int16, device=device),
            spread_until=spread0.to(torch.int8),
            suspect_deadline=torch.full((n, k), _DEADLINE_NONE16,
                                        dtype=torch.int16, device=device),
            self_inc=torch.zeros((n,), dtype=torch.int32, device=device),
        )
    return SwimState(
        status=status,
        inc=torch.zeros((n, k), dtype=torch.int32, device=device),
        spread_until=spread0,
        suspect_deadline=torch.full((n, k), INT32_MAX, dtype=torch.int32,
                                    device=device),
        self_inc=torch.zeros((n,), dtype=torch.int32, device=device),
    )


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


def _round_context(state: SwimState, round_idx: int, params: SwimParams,
                   world: SwimWorld, kn: Knobs) -> dict:
    """Per-round preamble: world liveness/partition slices, the self
    pin (a node always holds itself ALIVE at self_inc) and the phase
    gates (host bools: the round index and cadences are host ints)."""
    n = params.n_members
    alive = world.alive_at(round_idx)
    part = world.partition_at(round_idx)
    node_ids = torch.arange(n, dtype=torch.int32, device=world.device)
    is_self = _is_self(world, n)
    status = torch.where(is_self, records.ALIVE, state.status).to(torch.int8)
    inc = torch.where(is_self, state.self_inc[:, None], state.inc)
    fd_round = kn.ping_every > 0 and round_idx % max(kn.ping_every, 1) == 0
    sync_round = kn.sync_every > 0 and round_idx % max(kn.sync_every, 1) == 0
    return dict(alive=alive, part=part, node_ids=node_ids, is_self=is_self,
                status=status, inc=inc, fd_round=fd_round,
                sync_round=sync_round)


def _chain_ok(u: torch.Tensor, hop_losses: Sequence[torch.Tensor],
              budget_ms: float) -> torch.Tensor:
    """Multi-hop success with every hop delay statically zero: one
    Bernoulli draw ``u`` against the product of per-hop delivery
    probabilities (exact for independent per-hop losses), built in
    float32 in the reference's order."""
    p_chain = torch.ones(u.shape, dtype=torch.float32, device=u.device)
    for loss in hop_losses:
        p_chain = p_chain * (1.0 - loss)
    return (u < p_chain) & (0.0 <= budget_ms)


def _entry_at_slot(mat: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """``mat[i, slot[i]]`` for ``slot`` in [0, K) (the reference's
    one-hot max over K, equal here because table values are >= 0)."""
    return mat.gather(1, slot[:, None].long())[:, 0]


def _shift_fd_chains(eng, d_ids, d_alive, d_part, fd_shift: int,
                     proxy_shifts: Sequence[int], draws: prng.RoundDraws,
                     params: SwimParams, kn: Knobs, node_ids, part_here):
    """FD network outcomes as [N] vectors: the direct ping round trip and
    the ping-req proxy chains (FailureDetectorImpl.java:128-213).

    Returns ``(t, alive_t, part_t, direct_ok, ack_ok)`` with ``t`` each
    prober's target and ``ack_ok`` including proxy rescues."""
    ping_budget = knob_ping_timeout(kn, params)
    ping_req_budget = params.ping_interval_ms - ping_budget
    t = eng.look(d_ids, fd_shift)
    alive_t = eng.look(d_alive, fd_shift)
    part_t = eng.look(d_part, fd_shift)
    loss_it, _ = link_eval(node_ids, t, kn.loss_probability,
                           params.mean_delay_ms)
    loss_ti, _ = link_eval(t, node_ids, kn.loss_probability,
                           params.mean_delay_ms)
    direct_ok = (_chain_ok(draws.u_direct, [loss_it, loss_ti], ping_budget)
                 & alive_t & (part_here == part_t))
    ack_ok = direct_ok
    for r in range(params.ping_req_members):
        ps = proxy_shifts[r]
        p_ids = eng.look(d_ids, ps)
        p_alive = eng.look(d_alive, ps)
        p_part = eng.look(d_part, ps)
        hop_losses = [
            link_eval(src, dst, kn.loss_probability, params.mean_delay_ms)[0]
            for src, dst in ((node_ids, p_ids), (p_ids, t), (t, p_ids),
                             (p_ids, node_ids))
        ]
        ok_pr = (_chain_ok(draws.u_proxy[r], hop_losses, ping_req_budget)
                 & p_alive & alive_t
                 & (part_here == p_part) & (p_part == part_t)
                 & (ps != fd_shift))                     # proxy != target
        ack_ok = ack_ok | ok_pr
    return t, alive_t, part_t, direct_ok, ack_ok


def _shift_sender_gate(eng, d_ids, d_alive, d_part, s: int, node_ids,
                       kn: Knobs, params: SwimParams):
    """The sender's id/alive/partition views through shift ``s`` and the
    sender->receiver hop's loss, evaluated at the receiver.

    Returns ``(sender, sender_alive, sender_part, loss, delay)``."""
    sender = eng.deliver(d_ids, s)
    sender_alive = eng.deliver(d_alive, s)
    sender_part = eng.deliver(d_part, s)
    loss, delay = link_eval(sender, node_ids, kn.loss_probability,
                            params.mean_delay_ms)
    return sender, sender_alive, sender_part, loss, delay


def _send_components(state: SwimState, status, inc, round_idx: int,
                     params: SwimParams, world: SwimWorld, is_self):
    """(record_keys, hot, syncable): one payload in the wire format, two
    transmit masks.

    Gossip carries hot records (changed within the spread window); a
    leaver's final-round gossip carries its own DEAD@inc+1
    (MembershipProtocolImpl.java:197-206); SYNC carries the row minus
    tombstones, masked on the sender's table status."""
    wf = params.wire_format
    leaving_now = (world.leave_at == round_idx)[:, None] & is_self
    hot = ((status != records.ABSENT) & (round_idx < state.spread_until)) \
        | leaving_now
    record_keys = delivery.pack_record(status, inc, fmt=wf)
    leave_key = delivery.pack_record(records.DEAD, state.self_inc[:, None] + 1,
                                     fmt=wf)
    record_keys = torch.where(leaving_now, leave_key, record_keys)
    syncable = status != records.DEAD
    return record_keys, hot, syncable


def _fd_phase(eng, views, ctx: dict, shifts, params: SwimParams, kn: Knobs,
              world: SwimWorld, draws: prng.RoundDraws) -> dict:
    """Phase 1, the failure-detector probe: each prober's verdict about
    its shared-offset target, as [N] masks plus the SUSPECT verdicts as an
    [N, K] inbox contribution.  Verdicts are masked by the fd round."""
    d_ids, d_alive, d_part = views
    k = params.n_subjects
    status, inc = ctx["status"], ctx["inc"]
    alive_here, part_here = ctx["alive"], ctx["part"]
    fd_shift = shifts[0]
    t, _, _, direct_ok, ack_ok = _shift_fd_chains(
        eng, d_ids, d_alive, d_part, fd_shift,
        shifts[1:1 + params.ping_req_members], draws, params, kn,
        ctx["node_ids"], part_here)
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
    verdict_suspect = active & ~ack_ok
    # Every live member probes its offset target each fd round; ``active``
    # gates only the tracked-subject bookkeeping.
    probes_sent = (active if params.ping_known_only
                   else alive_here & ctx["fd_round"])
    fd_slot_onehot = (torch.arange(k, dtype=torch.int32,
                                   device=status.device)[None, :]
                      == torch.clamp(slot, min=0)[:, None])
    wf = params.wire_format
    fd_suspect_key = delivery.pack_record(records.SUSPECT, entry_t_inc,
                                          fmt=wf)
    return dict(
        active=active,
        push_refute=active & ack_ok & (entry_t_status == records.SUSPECT),
        probes_sent=probes_sent,
        ping_req_launches=probes_sent & ~direct_ok,
        fd_inbox=torch.where(fd_slot_onehot & verdict_suspect[:, None],
                             fd_suspect_key[:, None],
                             delivery.no_message(wf)),
    )


def _delivery_phase(state: SwimState, eng, views, ctx: dict, fd: dict,
                    shifts, round_idx: int, params: SwimParams, kn: Knobs,
                    world: SwimWorld, draws: prng.RoundDraws):
    """Phases 2-3: the F gossip channels, the refute push and the SYNC
    channel over cyclic shifts, max-folded with the FD verdicts into one
    inbox of the wire format's dtype.  Sender-side gates evaluate at the
    receiver through shifted views.  Returns ``(inbox, inbox_alive,
    messages_gossip)``."""
    d_ids, d_alive, d_part = views
    n, k = params.n_members, params.n_subjects
    r_proxies, f = params.ping_req_members, params.fanout
    status, inc, node_ids = ctx["status"], ctx["inc"], ctx["node_ids"]
    alive_here, part_here = ctx["alive"], ctx["part"]
    fd_shift, sync_shift = shifts[0], shifts[-1]
    wf = params.wire_format
    no_msg = delivery.no_message(wf)

    record_keys, hot, syncable = _send_components(
        state, status, inc, round_idx, params, world, ctx["is_self"])
    h_keys = eng.prep(record_keys)
    # Both transmit masks ride one int8 buffer (bit 0 hot, bit 1 syncable).
    h_tx = eng.prep(hot.to(torch.int8) | (syncable.to(torch.int8) << 1))
    h_hot_any = eng.prep(hot.any(dim=1))

    def deliver_channel(s, tx_bit):
        keys = eng.deliver(h_keys, s)
        tx = (eng.deliver(h_tx, s) & tx_bit) != 0
        payload = torch.where(tx, keys, no_msg)
        return payload, delivery.is_alive_key(payload, fmt=wf)

    drop_u = draws.drop_u
    inbox = fd["fd_inbox"]
    inbox_alive = torch.zeros((n, k), dtype=torch.bool, device=status.device)
    n_gossip_sent = torch.zeros((), dtype=torch.int32, device=status.device)
    for c, s in enumerate(shifts[1 + r_proxies:1 + r_proxies + f]):
        _, sender_alive, sender_part, loss_c, _ = _shift_sender_gate(
            eng, d_ids, d_alive, d_part, s, node_ids, kn, params)
        ok_c = (sender_alive & alive_here & (sender_part == part_here)
                & (drop_u[:, c] >= loss_c) & (c < kn.fanout))
        delivered, delivered_flags = deliver_channel(s, 1)
        inbox = torch.maximum(
            inbox, torch.where(ok_c[:, None], delivered, no_msg))
        inbox_alive |= delivered_flags & ok_c[:, None]
        n_gossip_sent += (ok_c & eng.deliver(h_hot_any, s)).sum(
            dtype=torch.int32)

    # Refute push: a prober whose ALIVE verdict met a SUSPECT entry SYNCs
    # its row to the probed member t = (i + fd_shift), i.e. receiver j
    # hears sender (j - fd_shift).  A refuting sender skips its regular
    # SYNC push, seen at the receiver through the sync shift.
    push_refute = fd["push_refute"] & (kn.sync_every > 0)
    h_pushers = eng.prep(push_refute)
    _, sender_alive_r, sender_part_r, loss_r, _ = _shift_sender_gate(
        eng, d_ids, d_alive, d_part, fd_shift, node_ids, kn, params)
    ok_r = (sender_alive_r & alive_here & (sender_part_r == part_here)
            & ~(draws.u_refute < loss_r) & eng.deliver(h_pushers, fd_shift))
    delivered_r, flags_r = deliver_channel(fd_shift, 2)
    inbox = torch.maximum(inbox, torch.where(ok_r[:, None], delivered_r,
                                             no_msg))
    inbox_alive |= flags_r & ok_r[:, None]
    sender_refuting = eng.deliver(h_pushers, sync_shift)

    # SYNC channel: the periodic anti-entropy push.
    _, sender_alive, sender_part, loss_sy, _ = _shift_sender_gate(
        eng, d_ids, d_alive, d_part, sync_shift, node_ids, kn, params)
    ok_s = (sender_alive & alive_here & ~sender_refuting
            & (sender_part == part_here) & ~(drop_u[:, f] < loss_sy)
            & ctx["sync_round"])
    delivered, delivered_flags = deliver_channel(sync_shift, 2)
    inbox = torch.maximum(inbox, torch.where(ok_s[:, None], delivered, no_msg))
    inbox_alive |= delivered_flags & ok_s[:, None]
    return inbox, inbox_alive, n_gossip_sent


def _tick_shift(state: SwimState, ctx: dict, round_idx: int,
                params: SwimParams, kn: Knobs, world: SwimWorld,
                draws: prng.RoundDraws):
    """The shift round's FD, delivery and merge phases, each under a
    profiler range (``swim.fd`` / ``swim.delivery`` / ``swim.merge``);
    returns ``(new_state, aux counters)``."""
    shifts = draws.shifts
    n_shifts = 1 + params.ping_req_members + params.fanout + 1
    if len(shifts) != n_shifts:
        raise ValueError(f"draws carry {len(shifts)} shifts, the round "
                         f"needs {n_shifts}")
    # One shift per send channel: [fd, proxies..., gossip..., sync].
    eng = ShiftEngine(params.n_members)
    views = (eng.prep(ctx["node_ids"]), eng.prep(ctx["alive"]),
             eng.prep(ctx["part"]))
    with record_function("swim.fd"):
        fd = _fd_phase(eng, views, ctx, shifts, params, kn, world, draws)
    with record_function("swim.delivery"):
        inbox, inbox_alive, n_gossip_sent = _delivery_phase(
            state, eng, views, ctx, fd, shifts, round_idx, params, kn, world,
            draws)
    with record_function("swim.merge"):
        new_state, refuted = _merge_and_timers(
            state, ctx["status"], ctx["inc"], inbox, inbox_alive, round_idx,
            params, kn, world, ctx["alive"])
    aux = dict(
        messages_gossip=n_gossip_sent,
        messages_ping=fd["active"].sum(dtype=torch.int32),
        messages_ping_sent=fd["probes_sent"].sum(dtype=torch.int32),
        messages_ping_req_sent=(fd["ping_req_launches"].sum(dtype=torch.int32)
                                * params.ping_req_members),
        refutations=(refuted & ctx["alive"]).sum(dtype=torch.int32),
    )
    return new_state, aux


def _wire_inc_sat(params: SwimParams) -> int:
    """Largest incarnation the wire format and the carry layout both hold
    exactly: the self-refutation bump and the carry encode clamp here.
    8191 on the int16 wire; 32767 (the int16 carry) under wire24."""
    sat = params.wire_format.inc_sat()
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
    """compact -> wide at the round's cursor (one kernel launch)."""
    inc, spread_until, deadline = carry.carry_decode(
        state.inc, state.spread_until, state.suspect_deadline, round_idx)
    return dataclasses.replace(state, inc=inc, spread_until=spread_until,
                               suspect_deadline=deadline)


def _carry_encode(state: SwimState, round_idx: int,
                  inc_sat: int) -> SwimState:
    """wide -> compact relative to the next round (one kernel launch)."""
    inc, spread_until, deadline = carry.carry_encode(
        state.inc, state.spread_until, state.suspect_deadline, round_idx,
        inc_sat)
    return dataclasses.replace(state, inc=inc, spread_until=spread_until,
                               suspect_deadline=deadline)


def _merge_and_timers(state: SwimState, status, inc, inbox, inbox_alive,
                      round_idx: int, params: SwimParams, kn: Knobs,
                      world: SwimWorld, alive_here):
    """Inbox merge, self-refutation, suspicion timers and the crash/leave
    freeze in one kernel launch (``kernels/merge.py``).  Returns
    ``(new_state, refuted [N] bool)``."""
    (new_status, new_inc, spread_until, deadline, self_inc,
     refuted) = merge_kernel.merge_and_timers(
        status, inc, state.spread_until, state.suspect_deadline, inbox,
        inbox_alive, state.self_inc, alive_here, world.slot_of_node,
        round_idx, kn.suspicion_rounds, params.periods_to_spread,
        _wire_inc_sat(params), fmt=params.wire_format)
    return SwimState(status=new_status, inc=new_inc, spread_until=spread_until,
                     suspect_deadline=deadline, self_inc=self_inc), refuted


def _round_metrics(new_state: SwimState, status, aux: dict,
                   params: SwimParams, world: SwimWorld,
                   alive) -> Dict[str, torch.Tensor]:
    """Per-round observability counters from the post-merge state and the
    send-side counters; ``status`` is the pre-merge pinned status.

    Four column reductions plus per-column post-ops: the self cell (pinned
    ALIVE) is subtracted after the reduce, and "absent" follows from the
    histogram identity."""
    new_status = new_state.status
    observer_alive = alive[:, None]
    subject_alive_i = alive[world.subject_ids.long()].to(torch.int32)

    def col_sum(mask):
        return mask.sum(dim=0, dtype=torch.int32)

    hist_alive = col_sum((new_status == records.ALIVE) & observer_alive)
    hist_suspect = col_sum((new_status == records.SUSPECT) & observer_alive)
    hist_dead = col_sum((new_status == records.DEAD) & observer_alive)
    still_suspect = col_sum((new_status == records.SUSPECT)
                            & (status == records.SUSPECT) & observer_alive)
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
    return dict(
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


def _decoded(state: SwimState, round_idx: int,
             params: SwimParams) -> SwimState:
    """The round's input carry in the wide layout (decoded if compact)."""
    if not params.compact_carry:
        return state
    with record_function("swim.carry"):
        return _carry_decode(state, round_idx)


def _encoded(state: SwimState, round_idx: int,
             params: SwimParams) -> SwimState:
    """The round's output carry in the params' layout (encoded if
    compact)."""
    if not params.compact_carry:
        return state
    with record_function("swim.carry"):
        return _carry_encode(state, round_idx, _wire_inc_sat(params))


def _wide_tick(state: SwimState, round_idx: int, params: SwimParams,
               world: SwimWorld, draws: prng.RoundDraws, kn: Knobs
               ) -> Tuple[SwimState, Dict[str, torch.Tensor]]:
    """One round on the wide carry; the input planes are free once this
    returns (the compact carry is encoded only after that)."""
    with record_function("swim.context"):
        ctx = _round_context(state, round_idx, params, world, kn)
    new_state, aux = _tick_shift(state, ctx, round_idx, params, kn, world,
                                 draws)
    with record_function("swim.metrics"):
        metrics = _round_metrics(new_state, ctx["status"], aux, params,
                                 world, ctx["alive"])
    return new_state, metrics


def swim_tick(state: SwimState, round_idx: int, params: SwimParams,
              world: SwimWorld, draws: prng.RoundDraws,
              knobs: Optional[Knobs] = None
              ) -> Tuple[SwimState, Dict[str, torch.Tensor]]:
    """One protocol round: (state, round, draws) -> (state', metrics)."""
    kn = knobs if knobs is not None else Knobs.from_params(params)
    new_state, metrics = _wide_tick(_decoded(state, round_idx, params),
                                    round_idx, params, world, draws, kn)
    return _encoded(new_state, round_idx, params), metrics


def run(seed: int, params: SwimParams, world: SwimWorld, n_rounds: int,
        state: Optional[SwimState] = None, start_round: int = 0,
        draws: Optional[Callable[[int], prng.RoundDraws]] = None,
        device="cuda") -> Tuple[SwimState, Dict[str, torch.Tensor]]:
    """Run ``n_rounds`` rounds from ``start_round``.

    Returns ``(final_state, metrics)`` with every metric stacked on the
    device as ``[n_rounds, ...]``; nothing syncs with the host per round.
    ``draws`` (default ``TorchDraws(seed, device, params)``) is any
    callable ``round_idx -> RoundDraws``.  ``state``/``start_round``
    resume a run; ``state`` is not modified.
    """
    device = resolve_device(device)
    _check_world_device(world, device)
    if state is None:
        state = initial_state(params, world, device=device)
    if draws is None:
        draws = prng.TorchDraws(seed, device, params)
    kn = Knobs.from_params(params)
    rows = []
    for round_idx in range(start_round, start_round + n_rounds):
        # swim_tick's steps, with each carry released as soon as the next
        # exists: under the compact carry the narrow input is not held
        # through the round, nor the decoded planes through the encode.
        state = _decoded(state, round_idx, params)
        state, m = _wide_tick(state, round_idx, params, world,
                              draws(round_idx), kn)
        state = _encoded(state, round_idx, params)
        rows.append(m)
    metrics = {name: torch.stack([m[name] for m in rows])
               for name in (rows[0] if rows else {})}
    return state, metrics
