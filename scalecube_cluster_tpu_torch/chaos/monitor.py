"""The invariant monitor: the paper's guarantees checked every round on
the device, with graceful degradation.

Counterpart of ``scalecube_cluster_tpu/chaos/monitor.py`` (its
sequential part).  The monitor rides the rounds as a plane of
``models/compose``; its state is a fixed-capacity violation buffer
(the trace's pattern: overflow counted, never silent).

Invariant codes (:class:`InvariantCode`; lane values are stable):

  FALSE_SUSPICION   a live observer newly marks a live subject SUSPECT on
                    a pristine network (``MonitorSpec.check_false_
                    suspicion``); with the epoch lane, only suspicions of
                    the current identity count.
  INC_REGRESSION    a stored ALIVE/SUSPECT record's incarnation decreased
                    without the record turning DEAD (same identity epoch;
                    a joining row is reborn), or a node's own incarnation
                    decreased.
  TIMER_BOUND       a live observer's suspicion-timer contract broke: a
                    timer on a non-SUSPECT entry, a SUSPECT entry without
                    one, an expired timer that did not fire, a deadline
                    beyond round + suspicion_rounds x max(1, lhm_max), or
                    a DEAD entry's suppression expiry beyond its window.
  WIRE_SATURATION   an incarnation above the wire format's saturation
                    point (``models/swim._wire_inc_sat``) or negative.
  COMPLETENESS      past a subject's ``complete_by`` deadline, an
                    eligible observer (continuously alive since the
                    subject's fault) still holds it ALIVE/SUSPECT.
  POST_HEAL_DIVERGENCE  from ``agree_from`` on, a live observer's record
                    differs from the live consensus (``models/sync.
                    divergent_cells``; ``check_agreement``).
  NO_RESURRECTION   a live observer holds a dead identity's record as
                    live: an incarnation above the slot's own current
                    ``self_inc`` (with the epoch lane, at cells claiming
                    the current epoch), or, past the join deadline, a
                    record of a dead epoch (``check_joins``).
  JOIN_COMPLETENESS past the join deadline, an eligible observer
                    (continuously alive since the join) does not hold the
                    live joined member live, at its true epoch where the
                    lane can say.

Evidence policy: the lanes record the violating cells of the round in
which each code first trips (``code_counts`` still 0 before it), in the
reference's order (code by code, each in cell order, then the self
lanes), overflow counted in ``dropped``; ``code_counts`` totals every
violating cell of the run, ``code_first_round`` the first round each
code tripped.

On the card the record is the codes-in ``kernels/trace.trace_record``,
one launch a checked code and one a self lane: the plane ``vio & fresh``
of code c as int8 ``c + 1`` with the code's detail plane as the
incarnations (subject ids null for the self lanes: the subject is the
observer).  Called one plane at a time, the compaction gives the
reference's slots, ``count`` and ``dropped`` exactly.  The reference
gates the record on a fresh trip with ``lax.cond``; the record of a
non-fresh code is empty, so the port records every round without a
branch and reads nothing back to the host.  Codes whose spec folds them
to zero (``check_false_suspicion``, ``check_agreement``, ``check_joins``
off, a ``complete_by`` with no deadline, an agreement deadline not
reached) are neither computed nor recorded, and no [codes, N, K] stack
is built: the spec is read to the host once a run.

Also :func:`join_deadlines`, ``chaos/scenarios.Scenario.build``'s join
rule for a world built without the DSL.  The batched monitor
(``run_monitored_batch``) is not ported.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from scalecube_cluster_tpu_torch import records
from scalecube_cluster_tpu_torch.kernels import i32
from scalecube_cluster_tpu_torch.kernels import trace as trace_kernel
from scalecube_cluster_tpu_torch.models import swim
from scalecube_cluster_tpu_torch.models import sync as msync

INT32_MAX = swim.INT32_MAX

# Violation-lane capacity: first-violation cells cluster; 4,096 lanes
# (80 KB) is far above the evidence a diagnosis needs, and overflow is
# counted.
DEFAULT_CAPACITY = 1 << 12

_N_LANES = 5  # (round, observer, subject, code, detail)


class InvariantCode(enum.IntEnum):
    """Violation kinds (module docstring; lane values stable)."""

    FALSE_SUSPICION = 0
    INC_REGRESSION = 1
    TIMER_BOUND = 2
    WIRE_SATURATION = 3
    COMPLETENESS = 4
    POST_HEAL_DIVERGENCE = 5
    NO_RESURRECTION = 6
    JOIN_COMPLETENESS = 7


N_CODES = len(InvariantCode)


# --------------------------------------------------------------------------
# Carried state and the per-scenario spec
# --------------------------------------------------------------------------


@dataclasses.dataclass
class MonitorState:
    """Violation evidence riding the rounds (module docstring).

    ``lanes[i] = (round, observer, subject, code, detail)`` for
    i < ``count`` ([capacity, 5] int32, -1 elsewhere); ``detail`` is the
    code's (incarnation, deadline, status or epoch).  ``count``,
    ``dropped`` 0-dim int32; ``code_counts`` [N_CODES] int32 totals every
    violating cell, ``code_first_round`` [N_CODES] int32 the first round
    each code tripped (INT32_MAX = never).  Green iff ``code_counts`` is
    all zero."""

    lanes: torch.Tensor
    count: torch.Tensor
    dropped: torch.Tensor
    code_counts: torch.Tensor
    code_first_round: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.lanes.shape[0]

    @staticmethod
    def init(capacity: int = DEFAULT_CAPACITY,
             device="cuda") -> "MonitorState":
        device = swim.resolve_device(device)

        def scalar():
            return torch.zeros((), dtype=torch.int32, device=device)

        return MonitorState(
            lanes=torch.full((capacity, _N_LANES), -1, dtype=torch.int32,
                             device=device),
            count=scalar(), dropped=scalar(),
            code_counts=torch.zeros((N_CODES,), dtype=torch.int32,
                                    device=device),
            code_first_round=torch.full((N_CODES,), INT32_MAX,
                                        dtype=torch.int32, device=device))

    def clone(self) -> "MonitorState":
        return MonitorState(**{f.name: getattr(self, f.name).clone()
                               for f in dataclasses.fields(self)})

    def to_arrays(self, prefix: str = "monitor/") -> dict:
        """Flat host-side ``{prefix<field>: np.ndarray}``, the reference's
        checkpoint payload."""
        return {f"{prefix}{f.name}": getattr(self, f.name).cpu().numpy()
                for f in dataclasses.fields(self)}

    @staticmethod
    def from_arrays(arrays: dict, prefix: str = "monitor/",
                    device="cuda") -> "MonitorState":
        """Inverse of :meth:`to_arrays` (a reference payload too), on
        ``device``: resumes a monitor as ``run_monitored(monitor=...)``."""
        device = swim.resolve_device(device)
        return MonitorState(**{
            f.name: torch.as_tensor(
                np.array(arrays[f"{prefix}{f.name}"], dtype=np.int32)
            ).to(device)
            for f in dataclasses.fields(MonitorState)})


@dataclasses.dataclass
class MonitorSpec:
    """What the scenario promises (the reference's fields).

    ``complete_by`` [K] int32: per-subject completeness deadline
    (INT32_MAX = unchecked).  ``agree_from``: the post-heal agreement
    round (INT32_MAX = none), enforced only with ``check_agreement``.
    ``check_false_suspicion``: the network is pristine.
    ``join_known_by`` [K] int32 (or a scalar): the join-propagation
    deadline, enforced only with ``check_joins``."""

    complete_by: torch.Tensor
    agree_from: object = INT32_MAX
    check_agreement: bool = False
    check_false_suspicion: bool = False
    join_known_by: object = INT32_MAX
    check_joins: bool = False

    @staticmethod
    def passive(params: "swim.SwimParams", device="cuda") -> "MonitorSpec":
        """Safety-only spec: monotone incarnations, timer bounds and wire
        saturation checked; no scenario-derived liveness claims."""
        device = swim.resolve_device(device)
        return MonitorSpec(complete_by=torch.full(
            (params.n_subjects,), INT32_MAX, dtype=torch.int32,
            device=device))


def join_deadlines(params: "swim.SwimParams", world: "swim.SwimWorld",
                   disruption_end: int = 0) -> Tuple[torch.Tensor, bool]:
    """``(join_known_by [K] int32, check_joins)``: each joined subject's
    deadline, ``max(join round, disruption_end) + completeness_bound``
    (INT32_MAX where no join is scheduled), and whether the codes apply
    at all (the plane on and some join scheduled):
    ``chaos/scenarios.Scenario.build``'s rule.  ``disruption_end``: the
    last round of the scenario's network disruptions (0 for none).  The
    rule also drops every deadline under a permanent disruption and adds
    a scenario's extra slack; no caller here has either."""
    from scalecube_cluster_tpu_torch.chaos.scenarios import (
        completeness_bound)

    bound = completeness_bound(params, params.n_members)
    join_at = world.join_at[world.subject_ids.long()].to(torch.int64)
    checkable = join_at < INT32_MAX
    deadline = torch.clamp(torch.clamp(join_at, min=disruption_end) + bound,
                           max=INT32_MAX)
    known_by = torch.where(checkable, deadline, INT32_MAX).to(torch.int32)
    return known_by, bool(params.open_world and bool(checkable.any()))


# --------------------------------------------------------------------------
# Per-round checking
# --------------------------------------------------------------------------


class _RunFacts:
    """What a run's checks read from the world and the spec that does
    not change from round to round, read to the host once: the self
    mask, the subjects' columns, which spec-gated codes can trip."""

    def __init__(self, spec: MonitorSpec, world: "swim.SwimWorld", n: int):
        self.subjects = world.subject_ids.long()
        self.is_self = swim._is_self(world, n)
        self.has_joins = bool((world.join_at < INT32_MAX).any())
        complete_by = torch.as_tensor(spec.complete_by).to(world.device)
        self.complete_by = complete_by.reshape(-1)[None, :]
        self.completeness = bool((complete_by < INT32_MAX).any())
        self.agree_from = int(spec.agree_from)
        self.join_known_by = torch.as_tensor(spec.join_known_by).to(
            world.device).reshape(-1)[None, :]
        self.fault_ref = torch.minimum(world.down_from,
                                       world.leave_at)[self.subjects]


def check_cells(spec: MonitorSpec, params: "swim.SwimParams",
                kn: "swim.Knobs", round_idx: int, prev: "swim.SwimState",
                new: "swim.SwimState", world: "swim.SwimWorld",
                alive_now=None, facts: Optional[_RunFacts] = None):
    """Evaluate every invariant on one round's (prev, new) wide carries:
    the reference's ``_check_cells`` without its stacks.

    Returns ``(cells, self_lanes, totals)``: ``cells`` the checked codes
    in code order as ``(code, vio [N, K] bool, detail)`` with ``detail``
    a callable giving the code's [N, K] int32 detail plane (built only
    when it is recorded); ``self_lanes`` the ``(code, v [N] bool)`` pair
    of the self-incarnation checks (detail ``new.self_inc``);
    ``totals`` [N_CODES] int32 on the device.  A code the spec folds to
    zero is left out of ``cells`` (its total is 0)."""
    n, k = prev.status.shape
    device = prev.status.device
    if facts is None:
        facts = _RunFacts(spec, world, n)
    if alive_now is None:
        alive_now = world.alive_at(round_idx)
    subjects, is_self = facts.subjects, facts.is_self
    obs_alive = alive_now[:, None]
    subj_alive = alive_now[subjects][None, :]

    ps, pi = prev.status, prev.inc.to(torch.int32)
    ns, ni = new.status, new.inc.to(torch.int32)
    dl = new.suspect_deadline
    sat = swim._wire_inc_sat(params)

    def live_records():
        return (ns == records.ALIVE) | (ns == records.SUSPECT)

    def ns_detail():
        return ns.to(torch.int32)

    def ni_detail():
        return ni

    has_epoch = new.epoch.numel() > 0
    if has_epoch:
        ne_ep = new.epoch.to(torch.int32)
        pe_ep = prev.epoch.to(torch.int32)
        true_ep = world.epoch_at(round_idx)[subjects][None, :]
    joining_vec = (world.join_at == round_idx) if facts.has_joins else None
    cells = []

    if spec.check_false_suspicion:
        v_fs = (obs_alive & subj_alive & ~is_self
                & (ns == records.SUSPECT) & (ps != records.SUSPECT))
        if has_epoch:
            v_fs = v_fs & (ne_ep == true_ep)
        cells.append((InvariantCode.FALSE_SUSPICION, v_fs, ni_detail))

    v_inc = (((ps == records.ALIVE) | (ps == records.SUSPECT))
             & (ns != records.DEAD) & (ni < pi))
    if joining_vec is not None:
        v_inc = v_inc & ~joining_vec[:, None]
    if has_epoch:
        v_inc = v_inc & (ne_ep == pe_ep)
    elif facts.has_joins:
        v_inc = v_inc & ~(world.join_at[subjects] < INT32_MAX)[None, :]
    cells.append((InvariantCode.INC_REGRESSION, v_inc, ni_detail))

    susp = ns == records.SUSPECT
    has_timer = dl != INT32_MAX
    horizon = i32(round_idx + i32(kn.suspicion_rounds
                                  * max(1, params.lhm_max)))
    if params.dead_suppress_rounds > 0:
        dead_hold = (ns == records.DEAD) & has_timer
        bad = dead_hold & (
            dl > i32(round_idx + swim.knob_dead_suppress(kn, params)))
        timed = has_timer & ~dead_hold
    else:
        dead_hold, bad, timed = None, None, has_timer
    wrong = ((timed & ~susp) | (susp & ~has_timer)
             | (susp & has_timer & (dl <= round_idx))
             | (timed & (dl > horizon)))
    if bad is not None:
        wrong = wrong | bad
    v_timer = obs_alive & wrong
    cells.append((InvariantCode.TIMER_BOUND, v_timer,
                  lambda: torch.where(has_timer, dl, -1)))

    v_sat = (ni > sat) | (ni < 0)
    cells.append((InvariantCode.WIRE_SATURATION, v_sat, ni_detail))

    if facts.completeness:
        due = facts.complete_by <= round_idx
        disturbed = ((world.down_from[:, None] <= round_idx)
                     & (world.down_until[:, None] > facts.fault_ref[None, :]))
        v_comp = due & obs_alive & ~disturbed & ~is_self & live_records()
        cells.append((InvariantCode.COMPLETENESS, v_comp, ns_detail))

    if spec.check_agreement and round_idx >= facts.agree_from:
        v_div, _ = msync.divergent_cells(ns, ni, alive_now)
        cells.append((InvariantCode.POST_HEAL_DIVERGENCE, v_div, ns_detail))

    if spec.check_joins:
        ns_live = live_records()
        join_due = facts.join_known_by <= round_idx
        join_at = world.join_at[subjects][None, :]
        joined_col = join_at < INT32_MAX
        subj_self_inc = new.self_inc[subjects][None, :]
        ghost_inc = (obs_alive & ~is_self & joined_col & ns_live
                     & (ni > subj_self_inc))
        if has_epoch:
            v_res = (ghost_inc & (ne_ep == true_ep)) | (
                join_due & obs_alive & ~is_self & ns_live & (ne_ep < true_ep))
            known = ns_live & (ne_ep == true_ep)
        else:
            v_res = ghost_inc
            known = ns_live
        disturbed_j = ((world.down_from[:, None] <= round_idx)
                       & (world.down_until[:, None] > join_at))
        v_jc = (join_due & joined_col & subj_alive & obs_alive
                & ~disturbed_j & ~is_self & ~known)
        cells.append((InvariantCode.NO_RESURRECTION, v_res,
                      (lambda: ne_ep) if has_epoch else ns_detail))
        cells.append((InvariantCode.JOIN_COMPLETENESS, v_jc, ns_detail))

    v_self_inc = new.self_inc < prev.self_inc
    if joining_vec is not None:
        v_self_inc = v_self_inc & ~joining_vec
    v_self_sat = new.self_inc > sat
    self_lanes = ((InvariantCode.INC_REGRESSION, v_self_inc),
                  (InvariantCode.WIRE_SATURATION, v_self_sat))

    sums = {int(code): vio.sum(dtype=torch.int32) for code, vio, _ in cells}
    for code, v in self_lanes:
        s = v.sum(dtype=torch.int32)
        sums[int(code)] = sums[int(code)] + s if int(code) in sums else s
    zero = torch.zeros((), dtype=torch.int32, device=device)
    totals = torch.stack([sums.get(c, zero) for c in range(N_CODES)])
    return cells, self_lanes, totals


def record_round(mon: MonitorState, round_idx: int, cells, self_lanes,
                 self_inc: torch.Tensor, subject_ids: torch.Tensor,
                 fresh: torch.Tensor, record=None) -> None:
    """Record this round's evidence into ``mon``'s lanes, ``count`` and
    ``dropped`` in place: each checked code's ``vio & fresh[code]`` cells,
    code by code, then the self lanes (the reference's ``_record_round``,
    one ``trace_record`` call a plane).  ``fresh`` [N_CODES] bool: the
    codes with no violation before this round.  ``record`` (default
    ``kernels/trace.trace_record``) takes ``trace_record``'s arguments;
    ``kernels/trace.trace_record_reference`` checks the kernel."""
    if record is None:
        record = trace_kernel.trace_record
    for code, vio, detail in cells:
        plane = (vio & fresh[int(code)]).view(torch.int8)
        if code:
            plane = plane * (int(code) + 1)
        record(mon.lanes, mon.count, mon.dropped, plane, detail(),
               subject_ids, round_idx, 0)
    incs = self_inc[:, None]
    for code, v in self_lanes:
        plane = (v & fresh[int(code)]).view(torch.int8)[:, None] \
            * (int(code) + 1)
        record(mon.lanes, mon.count, mon.dropped, plane, incs, None,
               round_idx, 0)


def check_round(mon: MonitorState, spec: MonitorSpec,
                params: "swim.SwimParams", kn: "swim.Knobs", round_idx: int,
                prev: "swim.SwimState", new: "swim.SwimState",
                world: "swim.SwimWorld", alive_now=None,
                facts: Optional[_RunFacts] = None) -> MonitorState:
    """Evaluate every invariant on one round's (prev, new) wide carries
    (:func:`check_cells`) and fold the result into the monitor: the
    evidence recorded into ``mon``'s buffer in place, the counts and
    first rounds returned in a new state.  Nothing is read back to the
    host."""
    with record_function("monitor.check"):
        if facts is None:
            facts = _RunFacts(spec, world, prev.status.shape[0])
        cells, self_lanes, totals = check_cells(
            spec, params, kn, round_idx, prev, new, world,
            alive_now=alive_now, facts=facts)
        fresh = mon.code_counts == 0
        tripped = fresh & (totals > 0)
        first_round = torch.where(tripped, i32(round_idx),
                                  mon.code_first_round)
        counts = mon.code_counts + totals
    with record_function("monitor.record"):
        record_round(mon, round_idx, cells, self_lanes, new.self_inc,
                     world.subject_ids, fresh)
    return dataclasses.replace(mon, code_counts=counts,
                               code_first_round=first_round)


# --------------------------------------------------------------------------
# The monitored runs
# --------------------------------------------------------------------------


class MonitorPlane:
    """The invariant monitor as a plane of ``models/compose``: its slice
    a :class:`MonitorState`, its round hook :func:`check_round` on the
    shared round context's wide decodes (``rc.prev_wide``,
    ``rc.new_wide``), no finalizer work.  ``monitor`` resumes an earlier
    buffer (cloned once, then updated in place).  The reference's batched
    fold (``on_round_batch``) waits for the batch runner."""

    name = "monitor"

    def __init__(self, spec: MonitorSpec, capacity: int = DEFAULT_CAPACITY,
                 monitor: Optional[MonitorState] = None):
        self.spec = spec
        self.capacity = capacity
        self.monitor = monitor
        self._facts = None

    def init(self, params, world):
        self._facts = _RunFacts(self.spec, world, params.n_members)
        if self.monitor is not None:
            if self.monitor.lanes.device != world.device:
                raise ValueError(f"monitor is on {self.monitor.lanes.device}"
                                 f", the world on {world.device}")
            return self.monitor.clone()
        return MonitorState.init(self.capacity, world.device)

    def on_round(self, rc, mon):
        return check_round(mon, self.spec, rc.params, rc.kn, rc.round_idx,
                           rc.prev_wide, rc.new_wide, rc.world,
                           alive_now=rc.alive_now, facts=self._facts)

    def finalize(self, fc, mon):
        return mon


def run_monitored(seed: int, params: "swim.SwimParams",
                  world: "swim.SwimWorld", spec: MonitorSpec, n_rounds: int,
                  capacity: int = DEFAULT_CAPACITY,
                  state: Optional["swim.SwimState"] = None,
                  start_round: int = 0, draws=None,
                  knobs: Optional["swim.Knobs"] = None,
                  monitor: Optional[MonitorState] = None, device="cuda"):
    """``models/swim.run`` with the invariant monitor riding the rounds.

    Returns ``(final_state, monitor_state, metrics)``.  The monitor only
    observes: the state and metrics equal ``run``'s, and a violated run
    completes, its verdict in the returned :class:`MonitorState`.
    ``monitor`` resumes a buffer across chunks (not modified).  Every
    carry layout works (the checks read the wide decode)."""
    from scalecube_cluster_tpu_torch.models import compose

    plane = MonitorPlane(spec, capacity=capacity, monitor=monitor)
    final_state, results, metrics = compose.composed_scan(
        seed, params, world, n_rounds, planes=(plane,), state=state,
        start_round=start_round, draws=draws, knobs=knobs, device=device)
    return final_state, results["monitor"], metrics


def run_monitored_metered(seed: int, params: "swim.SwimParams",
                          world: "swim.SwimWorld", spec: MonitorSpec,
                          n_rounds: int, capacity: int = DEFAULT_CAPACITY,
                          state: Optional["swim.SwimState"] = None,
                          start_round: int = 0, draws=None,
                          knobs: Optional["swim.Knobs"] = None,
                          monitor: Optional[MonitorState] = None,
                          metrics_spec=None, metrics_state=None,
                          device="cuda"):
    """``run_monitored`` with the health-metrics registry stacked after
    the monitor (its ``chaos_violations`` counter fed by the monitor's
    per-round count delta).  Returns ``(final_state, monitor_state,
    metrics_state, metrics)``."""
    from scalecube_cluster_tpu_torch.models import compose
    from scalecube_cluster_tpu_torch.telemetry import metrics as tmetrics

    if metrics_spec is None:
        metrics_spec = tmetrics.MetricsSpec.default()
    planes = (MonitorPlane(spec, capacity=capacity, monitor=monitor),
              tmetrics.MetricsPlane(metrics_spec, metrics_state=metrics_state,
                                    chaos_from="monitor"))
    final_state, results, metrics = compose.composed_scan(
        seed, params, world, n_rounds, planes=planes, state=state,
        start_round=start_round, draws=draws, knobs=knobs, device=device)
    return final_state, results["monitor"], results["metrics"], metrics


# --------------------------------------------------------------------------
# Host-side decoding and verdicts
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, order=True)
class InvariantViolation:
    """One recorded first-violation evidence lane."""

    round: int
    observer: int
    subject: int
    code: InvariantCode
    detail: int

    def to_json(self) -> dict:
        return {"round": self.round, "observer": self.observer,
                "subject": self.subject, "code": self.code.name,
                "detail": self.detail}


def decode_violations(mon: MonitorState) -> List[InvariantViolation]:
    """The recorded evidence as typed rows (host side; ``mon.dropped``
    counts what the capacity cut off)."""
    count = int(mon.count)
    lanes = mon.lanes[:count].cpu().numpy()
    return [InvariantViolation(round=int(row[0]), observer=int(row[1]),
                               subject=int(row[2]),
                               code=InvariantCode(int(row[3])),
                               detail=int(row[4]))
            for row in lanes]


def verdict(mon: MonitorState, max_evidence: int = 32) -> dict:
    """The reference's verdict digest: green flag, per-code totals and
    first rounds, and up to ``max_evidence`` decoded evidence lanes."""
    counts = mon.code_counts.cpu().numpy()
    firsts = mon.code_first_round.cpu().numpy()
    codes = {
        InvariantCode(c).name: {
            "violations": int(counts[c]),
            "first_round": (int(firsts[c]) if firsts[c] != INT32_MAX
                            else None),
        }
        for c in range(N_CODES)
    }
    return {
        "green": bool(counts.sum() == 0),
        "total_violations": int(counts.sum()),
        "codes": codes,
        "evidence_recorded": int(mon.count),
        "evidence_dropped": int(mon.dropped),
        "evidence": [v.to_json()
                     for v in decode_violations(mon)[:max_evidence]],
    }
