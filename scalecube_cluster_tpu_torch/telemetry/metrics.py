"""Always-on protocol health metrics: the registry riding the rounds.

Counterpart of ``scalecube_cluster_tpu/telemetry/metrics.py``.  The
event trace (``telemetry/trace.py``) answers what happened; this plane
is the numeric health signal a deployed SWIM exports (Lifeguard,
Dadgar et al., 2018): probe outcomes, suspicion lifetimes, piggyback
occupancy, wire saturation.

  - :class:`MetricsSpec`: the fixed registry declaration (counter,
    gauge and bucketed-histogram names, histogram edges), frozen and
    hashable, so a registry's shape never depends on data.
  - :class:`MetricsState`: the carried values on the device: ``[C]``
    int32 counters, ``[G]`` float32 gauges, one ``[B]`` int32 count
    vector per histogram.
  - the update ops :func:`inc`, :func:`inc_many`, :func:`set_gauge`,
    :func:`observe`, :func:`reset_window`.

:func:`observe_tick` is the one per-round entry; :func:`sample_gauges`
samples the gauges once from the final carry of a run or window.
:class:`MetricsPlane` is the registry as a plane of ``models/compose``
(``models/swim.run_metered`` and ``chaos/monitor.run_monitored_metered``
run it).  :func:`stream_metered_run` drives ``run_metered`` in flush
windows and journals one ``metrics_window`` record a window.

The reference skips the suspicion-transition block and the histogram
add with ``lax.cond`` on rounds without a status change or a sample;
both skipped branches are the identity, so the port computes them every
round on the device with the same bits and never reads a predicate back
to the host.  Gauges are float32 quotients of int32 totals, summed in
int32 first, so IEEE division gives the reference's bits.

Counters are int32 window totals and wrap as the reference's do
(:func:`to_json` warns): keep windows short enough that a total stays
under 2**31 (at 1M members, ``gossip_messages`` grows by up to N x
fanout a round).  The row-sharded registry (``aggregate_across_devices``
with an ``axis_name``) is not ported: the port runs on one device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from scalecube_cluster_tpu_torch import records

INT32_MAX = 2**31 - 1

# Suspicion lifetimes span refutations (a few probe cycles) through the
# full suspicion timeout; the same geometric grid as the trace's latency
# histogram.
DEFAULT_SUSPICION_EDGES = (0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64,
                           96, 128)

# The default protocol-health registry.  Counters are window totals
# (int32; the windowed flush resets them), gauges last-sampled values,
# histograms bucketed counts (bucket i covers [edges[i], edges[i+1]),
# the last bucket open).
DEFAULT_COUNTERS = (
    "fd_probes_sent",            # PINGs issued by live members
    "fd_ping_req_sent",          # PING_REQ fan-out messages
    "fd_tracked_verdicts",       # probe verdicts on tracked subjects
    "gossip_messages",           # wire gossip messages sent
    "refutations",               # self-refutation incarnation bumps
    "suspicions_started",        # cells newly turned SUSPECT
    "suspicions_refuted",        # SUSPECT resolved back to ALIVE
    "suspicions_fired",          # SUSPECT matured to DEAD
    "false_suspicion_onsets",    # new SUSPECT about a live subject
    "false_positive_rounds",     # observer-rounds holding FP views
    "live_observer_rounds",      # sum of live members over rounds
    "chaos_violations",          # invariant-monitor trips (monitored)
    "joins_admitted",            # open-world joins fired (0 when the
                                 # plane is off)
)
DEFAULT_GAUGES = (
    "live_members",              # ground-truth live count
    "suspect_entries",           # suspicion queue depth (live observers)
    "dead_entries",              # tombstones held by live observers
    "gossip_piggyback_occupancy",  # hot records / live tracked records
    "wire_saturation",           # gossip messages / send-slot capacity
    "lhm",                       # mean Lifeguard multiplier over live
                                 # members (0 = plane off)
    "free_slots",                # slots with no live occupant
)
DEFAULT_HISTOGRAMS = (
    ("suspicion_lifetime_rounds", DEFAULT_SUSPICION_EDGES),
)


@dataclasses.dataclass(frozen=True)
class MetricsSpec:
    """The fixed registry declaration (module docstring).  Frozen, tuples
    only, so instances hash."""

    counters: Tuple[str, ...] = DEFAULT_COUNTERS
    gauges: Tuple[str, ...] = DEFAULT_GAUGES
    histograms: Tuple[Tuple[str, Tuple[int, ...]], ...] = DEFAULT_HISTOGRAMS

    def __post_init__(self):
        for kind in ("counters", "gauges"):
            names = getattr(self, kind)
            if len(set(names)) != len(names):
                raise ValueError(f"duplicate {kind} names: {names}")
        hnames = tuple(n for n, _ in self.histograms)
        if len(set(hnames)) != len(hnames):
            raise ValueError(f"duplicate histogram names: {hnames}")
        for name, edges in self.histograms:
            if len(edges) < 2 or list(edges) != sorted(set(edges)):
                raise ValueError(
                    f"histogram {name!r} needs >= 2 strictly increasing "
                    f"edges (got {edges})")

    @staticmethod
    def default() -> "MetricsSpec":
        return MetricsSpec()

    def counter_index(self, name: str) -> int:
        return self.counters.index(name)

    def gauge_index(self, name: str) -> int:
        return self.gauges.index(name)

    def histogram_edges(self, name: str) -> Tuple[int, ...]:
        for n, edges in self.histograms:
            if n == name:
                return edges
        raise KeyError(f"histogram {name!r} not in spec")


@dataclasses.dataclass
class MetricsState:
    """The carried registry values: ``counters`` [C] int32 and ``gauges``
    [G] float32 in spec order; ``hists`` maps each histogram's name to
    its [B] int32 bucket counts."""

    counters: torch.Tensor
    gauges: torch.Tensor
    hists: Dict[str, torch.Tensor]

    @staticmethod
    def init(spec: MetricsSpec, device="cuda") -> "MetricsState":
        from scalecube_cluster_tpu_torch.models import swim

        device = swim.resolve_device(device)
        return MetricsState(
            counters=torch.zeros((len(spec.counters),), dtype=torch.int32,
                                 device=device),
            gauges=torch.zeros((len(spec.gauges),), dtype=torch.float32,
                               device=device),
            hists={name: torch.zeros((len(edges),), dtype=torch.int32,
                                     device=device)
                   for name, edges in spec.histograms},
        )

    def to(self, device) -> "MetricsState":
        return MetricsState(counters=self.counters.to(device),
                            gauges=self.gauges.to(device),
                            hists={k: v.to(device)
                                   for k, v in self.hists.items()})


# --------------------------------------------------------------------------
# Update ops (each returns a new state; the inputs are not modified)
# --------------------------------------------------------------------------


def _i32(value, device) -> torch.Tensor:
    return torch.as_tensor(value, device=device).to(torch.int32)


def inc(ms: MetricsState, spec: MetricsSpec, name: str,
        value) -> MetricsState:
    """counter[name] += value (a scalar of any integer dtype)."""
    counters = ms.counters.clone()
    counters[spec.counter_index(name)] += _i32(value, counters.device)
    return dataclasses.replace(ms, counters=counters)


def inc_many(ms: MetricsState, spec: MetricsSpec,
             updates: Dict[str, torch.Tensor]) -> MetricsState:
    """Batch counter adds: one delta vector, one add.  Unknown names
    raise (a registry mismatch is a bug, not data).  The delta is
    stacked on the device in spec order, so no index crosses from the
    host."""
    if not updates:
        return ms
    for name in updates:
        spec.counter_index(name)
    device = ms.counters.device
    zero = torch.zeros((), dtype=torch.int32, device=device)
    delta = torch.stack([_i32(updates[name], device).reshape(())
                         if name in updates else zero
                         for name in spec.counters])
    return dataclasses.replace(ms, counters=ms.counters + delta)


def set_gauge(ms: MetricsState, spec: MetricsSpec, name: str,
              value) -> MetricsState:
    """gauge[name] = value (last write wins: gauges are samples)."""
    gauges = ms.gauges.clone()
    gauges[spec.gauge_index(name)] = torch.as_tensor(
        value, device=gauges.device).to(torch.float32)
    return dataclasses.replace(ms, gauges=gauges)


def bucket_counts(edges: torch.Tensor, values: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """[B] int32: how many ``values`` where ``mask`` fall in each bucket
    (``clip(searchsorted(edges, v, side="right") - 1, 0, B - 1)``).  The
    buckets are counted by ``torch.histc`` over their indices, each at
    the middle of its unit bin and the masked-off samples below the
    range: float32 sums of ones, exact below 2**24 samples in a bucket,
    in any order.  (An integer ``index_add_`` of the mask would make one
    atomic add a cell into B addresses.)"""
    b = edges.shape[0]
    bucket = torch.clamp(
        torch.searchsorted(edges, values.reshape(-1), right=True,
                           out_int32=True) - 1, 0, b - 1)
    key = torch.where(mask.reshape(-1), bucket.to(torch.float32) + 0.5,
                      -1.0)
    return torch.histc(key, bins=b, min=0, max=b).to(torch.int32)


def observe(ms: MetricsState, spec: MetricsSpec, name: str, values,
            mask) -> MetricsState:
    """Bucketize ``values`` where ``mask`` and add to the histogram's
    counts (``values``/``mask`` broadcast to a common shape).  The
    reference skips the pass when the mask is empty; the add is then 0."""
    device = ms.hists[name].device
    edges = _edges(spec.histogram_edges(name), device)
    values = torch.as_tensor(values, device=device).to(torch.int32)
    mask = torch.as_tensor(mask, device=device).to(torch.bool)
    values, mask = torch.broadcast_tensors(values, mask)
    hists = dict(ms.hists)
    hists[name] = ms.hists[name] + bucket_counts(
        edges, values.contiguous(), mask)
    return dataclasses.replace(ms, hists=hists)


@functools.lru_cache(maxsize=None)
def _edges(edges: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """A histogram's edges as an int32 tensor on ``device``, made once
    (a host-to-device copy a round would wait for the queued work)."""
    return torch.tensor(edges, dtype=torch.int32, device=device)


def reset_window(ms: MetricsState) -> MetricsState:
    """Zero the additive lanes (counters, histograms) for the next flush
    window; gauges carry (they are samples, not totals)."""
    return MetricsState(
        counters=torch.zeros_like(ms.counters),
        gauges=ms.gauges,
        hists={k: torch.zeros_like(v) for k, v in ms.hists.items()},
    )


# --------------------------------------------------------------------------
# The per-round observation
# --------------------------------------------------------------------------


def _total(x) -> torch.Tensor:
    return torch.as_tensor(x).sum(dtype=torch.int32)


def observe_tick(ms: MetricsState, spec: MetricsSpec, params, kn,
                 round_idx: int, prev_status, prev_deadline, new_status,
                 tick_metrics, world, alive_now=None) -> MetricsState:
    """Fold one round's health signals into the registry.

    ``prev_status``/``prev_deadline`` are the carry fields before the
    round, the deadline in absolute rounds; ``new_status`` after it;
    ``tick_metrics`` the round's metrics dict.  ``alive_now``: the
    round's ``world.alive_at``, from the composed runner's shared
    context (None recomputes it).  The reference's ``any_status_change``
    gate is not taken: the suspicion block runs every round (module
    docstring)."""
    from scalecube_cluster_tpu_torch.models import fd as fd_model

    updates = {}
    for name, value in fd_model.probe_outcome_updates(tick_metrics).items():
        if name in spec.counters:
            updates[name] = value
    for name, key in (("gossip_messages", "messages_gossip"),
                      ("refutations", "refutations"),
                      ("false_suspicion_onsets", "false_suspicion_onsets"),
                      ("false_positive_rounds", "false_positives")):
        if name in spec.counters and key in tick_metrics:
            updates[name] = _total(tick_metrics[key])
    if "live_observer_rounds" in spec.counters:
        alive = world.alive_at(round_idx) if alive_now is None else alive_now
        updates["live_observer_rounds"] = alive.sum(dtype=torch.int32)
    if params.open_world and "joins_admitted" in spec.counters:
        updates["joins_admitted"] = (world.join_at == round_idx).sum(
            dtype=torch.int32)

    track = tuple(n for n in ("suspicions_started", "suspicions_refuted",
                              "suspicions_fired") if n in spec.counters)
    has_hist = any(n == "suspicion_lifetime_rounds"
                   for n, _ in spec.histograms)
    resolved = None
    if track or has_hist:
        was_suspect = prev_status == records.SUSPECT
        is_suspect = new_status == records.SUSPECT
        resolved = was_suspect & ~is_suspect
        if "suspicions_started" in track:
            updates["suspicions_started"] = _total(is_suspect & ~was_suspect)
        if "suspicions_refuted" in track:
            updates["suspicions_refuted"] = _total(
                resolved & (new_status == records.ALIVE))
        if "suspicions_fired" in track:
            updates["suspicions_fired"] = _total(
                resolved & (new_status == records.DEAD))
    ms = inc_many(ms, spec, updates)
    if has_hist:
        # The timer was armed at onset as onset + suspicion_rounds, so the
        # deadline gives the onset round; lifetime = resolution - onset.
        # A cell without a timer adds nothing.  Lifeguard stretches armed
        # deadlines past the base schedule: the lifetime is then measured
        # against the base schedule and clamped at 0.
        had_timer = resolved & (prev_deadline != INT32_MAX)
        lifetime = round_idx - (prev_deadline - kn.suspicion_rounds)
        if params.lhm_max > 0:
            lifetime = torch.clamp(lifetime, min=0)
        ms = observe(ms, spec, "suspicion_lifetime_rounds", lifetime,
                     had_timer)
    return ms


def sample_gauges(ms: MetricsState, spec: MetricsSpec, params, kn,
                  status, spread_until_wide, alive_here, round_idx: int,
                  world, last_tick_metrics=None,
                  lhm=None) -> MetricsState:
    """Sample every gauge from the final carry of a run or window.

    ``status``/``spread_until_wide`` are the carry fields, the window in
    absolute rounds at cursor ``round_idx`` (the round the state would run
    next); ``alive_here`` the rows' ground-truth liveness.  ``lhm``: the
    Lifeguard lane when the plane is on; the ``lhm`` gauge then samples
    the mean multiplier over live members, else it keeps its 0.  One
    device: the reference's ``axis_name`` is not taken."""
    from scalecube_cluster_tpu_torch.models import gossip as gossip_model
    from scalecube_cluster_tpu_torch.ops import delivery as delivery_ops

    obs_alive = alive_here[:, None]
    live = world.alive_at(round_idx).sum(dtype=torch.int32)
    hot = _hot_records(status, spread_until_wide, round_idx) & obs_alive
    values = {
        "live_members": live,
        "suspect_entries": ((status == records.SUSPECT) & obs_alive).sum(
            dtype=torch.int32),
        "dead_entries": ((status == records.DEAD) & obs_alive).sum(
            dtype=torch.int32),
        "free_slots": params.n_members - live,
        "gossip_piggyback_occupancy": gossip_model.piggyback_occupancy(
            hot.sum(dtype=torch.int32), live * params.n_subjects),
    }
    if last_tick_metrics is not None \
            and "messages_gossip" in last_tick_metrics:
        values["wire_saturation"] = delivery_ops.wire_saturation(
            _total(last_tick_metrics["messages_gossip"]), live, kn.fanout)
    if lhm is not None and lhm.shape[0]:
        lhm_sum = torch.where(alive_here, lhm, 0).sum(dtype=torch.int32)
        values["lhm"] = (lhm_sum.to(torch.float32)
                         / torch.clamp(live, min=1).to(torch.float32))
    names = [name for name in spec.gauges if name in values]
    if not names:
        return ms
    index = torch.tensor([spec.gauge_index(name) for name in names],
                         dtype=torch.int64, device=ms.gauges.device)
    gauges = ms.gauges.clone()
    gauges[index] = torch.stack([values[name].to(torch.float32).reshape(())
                                 for name in names])
    return dataclasses.replace(ms, gauges=gauges)


def _hot_records(status, spread_until_wide, round_idx: int):
    """The gossip piggyback mask: records still inside their
    retransmission window, at the next round the state would run."""
    return (status != records.ABSENT) & (round_idx < spread_until_wide)


def aggregate_across_devices(ms: MetricsState,
                             axis_name: Optional[str]) -> MetricsState:
    """The identity on one device; any ``axis_name`` raises
    ``NotImplementedError`` (the multi-device registry is not ported)."""
    if axis_name is not None:
        raise NotImplementedError(
            "the multi-device registry (axis_name) is not ported: the "
            "port's metrics plane runs on one device (ROADMAP A11)")
    return ms


# --------------------------------------------------------------------------
# The compose() plane
# --------------------------------------------------------------------------


class MetricsPlane:
    """The health-metrics registry as a plane of ``models/compose``: its
    slice is a :class:`MetricsState`, its round hook :func:`observe_tick`
    over the shared round context, its finalizer :func:`sample_gauges`.

    ``chaos_from`` names an earlier plane of the stack (the invariant
    monitor) whose per-round ``code_counts`` delta feeds the
    ``chaos_violations`` counter; None leaves the counter alone.
    ``metrics_state`` resumes a registry (not modified)."""

    name = "metrics"

    def __init__(self, spec: MetricsSpec, metrics_state=None,
                 chaos_from: Optional[str] = None):
        self.spec = spec
        self.metrics_state = metrics_state
        self.chaos_from = chaos_from

    def init(self, params, world):
        if self.metrics_state is not None:
            return self.metrics_state.to(world.device)
        return MetricsState.init(self.spec, world.device)

    def on_round(self, rc, ms):
        with record_function("metrics.observe"):
            ms = observe_tick(
                ms, self.spec, rc.params, rc.kn, rc.round_idx,
                rc.prev.status, rc.prev_deadline_wide, rc.new.status,
                rc.metrics, rc.world, alive_now=rc.alive_now)
            if (self.chaos_from is not None
                    and "chaos_violations" in self.spec.counters):
                before = rc.plane_before(self.chaos_from)
                after = rc.plane_after(self.chaos_from)
                ms = inc(ms, self.spec, "chaos_violations",
                         (after.code_counts - before.code_counts).sum(
                             dtype=torch.int32))
        return ms

    def finalize(self, fc, ms):
        with record_function("metrics.observe"):
            return sample_gauges(
                ms, self.spec, fc.params, fc.kn, fc.final_state.status,
                fc.spread_until_wide, fc.alive_here, fc.end_round, fc.world,
                last_tick_metrics=fc.last_tick_metrics,
                lhm=fc.final_state.lhm if fc.params.lhm_max > 0 else None)


# --------------------------------------------------------------------------
# Host-side decode and the windowed flush loop
# --------------------------------------------------------------------------


def to_json(ms: MetricsState, spec: MetricsSpec) -> dict:
    """Registry -> the ``metrics_window`` payload (the reference's JSON).
    A negative counter means the window outgrew int32 and wrapped: warn
    (the fix is a shorter flush window)."""
    counters = ms.counters.cpu().numpy()
    gauges = ms.gauges.cpu().numpy()
    if (counters < 0).any():
        import warnings

        wrapped = [n for i, n in enumerate(spec.counters) if counters[i] < 0]
        warnings.warn(
            f"metrics window counters wrapped int32 (negative totals): "
            f"{wrapped} — shorten the flush window (stream_metered_run "
            f"window_rounds) to keep per-window totals under 2**31",
            stacklevel=2,
        )
    return {
        "counters": {n: int(counters[i])
                     for i, n in enumerate(spec.counters)},
        "gauges": {n: round(float(gauges[i]), 6)
                   for i, n in enumerate(spec.gauges)},
        "histograms": {
            name: {"edges": list(edges),
                   "counts": np.asarray(ms.hists[name].cpu()).tolist()}
            for name, edges in spec.histograms
        },
    }


def stream_metered_run(seed: int, params, world, n_rounds: int, *,
                       sink=None, window_rounds: int = 64,
                       spec: Optional[MetricsSpec] = None, state=None,
                       knobs=None, start_round: int = 0,
                       skip_covered: bool = True, alarm_specs=None,
                       draws=None, shift_key=None, device="cuda"):
    """Drive ``models/swim.run_metered`` in flush windows.

    After each ``window_rounds``-round window the registry is read to the
    host, written as one ``metrics_window`` record (when ``sink`` is
    given) and reset (gauges carry).  Records carry ``round_start`` /
    ``round_end``: with an append-mode journal sink, windows whose
    ``round_end`` the journal already covers are run (the carry must
    advance) but not written again (``skip_covered``), so a resumed run
    leaves no duplicate rows.  ``shift_key`` seeds the port's own draws'
    channel shifts (``swim.run``).

    ``alarm_specs`` (a sequence of ``telemetry.alarms.AlarmSpec``; needs
    ``sink``) evaluates each flush window through a live
    ``alarms.AlarmEngine`` and journals every state change as an
    ``alarm_transition`` record.  The one startup scan that finds the
    metrics cursor also replays the journal's rows through the engine
    and skips the transitions already journaled, so a resumed run writes
    each transition once; windows the cursor skips were replayed and are
    not observed again.

    Returns ``(final_state, window_rows)``: every window's payload
    (written or not), each ``{"round_start", "round_end", "counters",
    "gauges", "histograms"}``."""
    from scalecube_cluster_tpu_torch.models import compose, swim
    from scalecube_cluster_tpu_torch.telemetry import sink as tsink

    device = swim.resolve_device(device)
    spec = spec or MetricsSpec.default()
    window_rounds = max(1, int(window_rounds))
    engine = existing = None
    if alarm_specs:
        from scalecube_cluster_tpu_torch.telemetry import alarms as talarms

        if sink is None:
            raise ValueError(
                "alarm_specs needs a sink: transitions are journal "
                "records (telemetry/alarms.py)")
        engine = talarms.AlarmEngine(alarm_specs,
                                     kinds=("metrics_window",))
    covered = 0
    if sink is not None and (skip_covered or engine is not None):
        # One scan serves both cursors: the metrics-window dedup and the
        # alarm replay.
        follower = tsink.follow_records(sink.path)
        records = follower.poll()
        if skip_covered:
            covered = follower.covered_upto(kind="metrics_window")
        if engine is not None:
            replayed, existing = talarms.replay_journal(engine, records)
            talarms.write_transitions(sink, replayed, existing)
    draws = compose._draws_for(seed, params, world, draws, shift_key,
                               device)
    ms = MetricsState.init(spec, device)
    rows: List[dict] = []
    r = 0
    while r < n_rounds:
        step = min(window_rounds, n_rounds - r)
        state, ms, _ = swim.run_metered(
            seed, params, world, step, spec=spec, state=state,
            start_round=start_round + r, knobs=knobs, metrics_state=ms,
            draws=draws, device=device)
        w_start, w_end = start_round + r, start_round + r + step
        row = {"round_start": w_start, "round_end": w_end,
               **to_json(ms, spec)}
        rows.append(row)
        if sink is not None and w_end > covered:
            sink.write_metrics_window(row)
            if engine is not None:
                talarms.write_transitions(
                    sink, engine.observe({"kind": "metrics_window", **row}),
                    existing)
        ms = reset_window(ms)
        r += step
    return state, rows
