"""The composed plane runner: one round loop, shared round reductions,
any stack of observer planes.

Counterpart of ``scalecube_cluster_tpu/models/compose.py``, its
single-device part.  A **plane** is a small object with three hooks
over the round loop:

  ``init(params, world)``   -> its slice of the carry (resume state
                               threads through here), on
                               ``world.device``
  ``on_round(rc, slice)``   -> the round's observation fold, reading
                               the shared :class:`RoundCtx`
  ``finalize(fc, slice)``   -> the end-of-run sample over the shared
                               :class:`FinalCtx`

:func:`composed_scan` runs the protocol round once a round and hands
every plane the same :class:`RoundCtx`, whose derivations (live masks,
the status-change matrix and its emptiness predicate, the wide decodes)
are computed once a round, the first time a plane asks.  Entry points
on it:

  ``models/swim.run``                      -> no planes
  ``models/swim.run_traced``               -> + ``TracePlane``
  ``models/swim.run_metered``              -> + ``MetricsPlane``
  ``chaos/monitor.run_monitored``          -> + ``MonitorPlane``
  ``chaos/monitor.run_monitored_metered``  -> + both
  :func:`run_composed`                     -> the stack
                                              :func:`build_stack` makes

(``TracePlane`` in ``telemetry/trace.py``, ``ProvenancePlane`` in
``models/provenance.py``, ``MetricsPlane`` in ``telemetry/metrics.py``,
``MonitorPlane`` in ``chaos/monitor.py``.)

The reference's fused steps (``rounds_per_step``) give the same outputs
as single rounds, and the port runs single rounds whatever
``rounds_per_step`` says, so no plane needs the fused hooks.  With
``SwimParams.provenance`` on, the round's per-channel evidence is popped
out of its metrics (:func:`_pop_provenance`) into
:attr:`RoundCtx.provenance` before the metrics are stacked, whether or
not the provenance plane rides.  The batch and row-sharded runners
(``composed_batch_scan``, ``composed_shard_scan``,
``_pipelined_rounds``) are not ported either.

The in-tick planes (SYNC anti-entropy, Lifeguard, the open-world epoch
lane, metadata, delay rings, user gossip) are compiled into the round by
their ``SwimParams`` knobs and carried in ``SwimState`` lanes;
:func:`plane_registry` lists them beside the observer planes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from scalecube_cluster_tpu_torch.models import swim
from scalecube_cluster_tpu_torch.ops import prng


def wide_view(params: "swim.SwimParams", st: "swim.SwimState", cursor: int):
    """Any carry layout -> the wide form observer planes read (lossless
    below the caps the layouts already check).  Under ``compact_carry``
    this is one ``carry_decode`` launch."""
    if params.compact_carry:
        return swim._carry_decode(st, cursor)
    if params.int16_wire:
        return dataclasses.replace(st, inc=st.inc.to(torch.int32))
    return st


class RoundCtx:
    """Shared per-round context: what more than one plane might derive
    from one round's (prev, new) pair, computed once and memoised.

    ``prev``/``new`` are the carry before and after the round in their
    stored layout; ``metrics`` the round's metrics dict; ``provenance``
    the round's per-channel evidence (``dict(fd=, gossip=, sync=,
    ping_req=)``, ``SwimParams.provenance``), None with the knob off.
    Planes read the raw fields for stored-layout math and the properties
    for the shared derivations."""

    __slots__ = ("params", "world", "kn", "round_idx", "prev", "new",
                 "metrics", "offset", "provenance", "_cache", "_plane_prev",
                 "_plane_new")

    def __init__(self, params, world, kn, round_idx, prev, new, metrics,
                 offset=0, provenance=None):
        self.params = params
        self.world = world
        self.kn = kn
        self.round_idx = round_idx
        self.prev = prev
        self.new = new
        self.metrics = metrics
        self.offset = offset
        self.provenance = provenance
        self._cache = {}
        self._plane_prev = {}
        self._plane_new = {}

    def _memo(self, key, fn):
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]

    @property
    def alive_now(self):
        """[N] ground-truth liveness at this round (``world.alive_at``)."""
        return self._memo("alive_now",
                          lambda: self.world.alive_at(self.round_idx))

    @property
    def status_changed(self):
        """[N, K] bool: the cells whose status changed this round."""
        return self._memo("status_changed",
                          lambda: self.prev.status != self.new.status)

    @property
    def any_status_change(self):
        """0-dim bool tensor on the device: any cell changed (no host
        read)."""
        return self._memo("any_status_change",
                          lambda: self.status_changed.any())

    @property
    def prev_wide(self):
        """``prev`` decoded wide at this round's cursor."""
        return self._memo(
            "prev_wide",
            lambda: wide_view(self.params, self.prev, self.round_idx))

    @property
    def new_wide(self):
        """``new`` decoded wide at the next round's cursor."""
        return self._memo(
            "new_wide",
            lambda: wide_view(self.params, self.new, self.round_idx + 1))

    @property
    def prev_deadline_wide(self):
        """``prev.suspect_deadline`` in absolute rounds: from
        :attr:`prev_wide` when a plane already paid the full decode,
        else from ``swim._wide_timer_fields``."""
        def derive():
            if "prev_wide" in self._cache:
                return self._cache["prev_wide"].suspect_deadline
            return swim._wide_timer_fields(self.prev, self.params,
                                           self.round_idx)[0]
        return self._memo("prev_deadline_wide", derive)

    def plane_before(self, name: str):
        """Another plane's slice before its ``on_round`` this round
        (planes run in stack order)."""
        return self._plane_prev[name]

    def plane_after(self, name: str):
        """Another plane's slice after its ``on_round`` this round."""
        return self._plane_new[name]


class FinalCtx:
    """Shared end-of-run context for plane finalizers: the final carry
    at cursor ``end_round`` and the stacked per-round metrics."""

    __slots__ = ("params", "world", "kn", "end_round", "final_state",
                 "metrics", "offset", "n_local", "_cache")

    def __init__(self, params, world, kn, end_round, final_state, metrics,
                 offset=0, n_local=None):
        self.params = params
        self.world = world
        self.kn = kn
        self.end_round = end_round
        self.final_state = final_state
        self.metrics = metrics
        self.offset = offset
        self.n_local = n_local
        self._cache = {}

    def _memo(self, key, fn):
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]

    @property
    def spread_until_wide(self):
        """Final ``spread_until`` in absolute rounds at the end cursor."""
        return self._memo(
            "spread_until_wide",
            lambda: swim._wide_timer_fields(self.final_state, self.params,
                                            self.end_round)[1])

    @property
    def alive_here(self):
        """Ground-truth liveness of the final carry's rows at the end."""
        def derive():
            alive = self.world.alive_at(self.end_round)
            if self.n_local is not None \
                    and self.n_local != self.params.n_members:
                return alive[self.offset:self.offset + self.n_local]
            return alive
        return self._memo("alive_here", derive)

    @property
    def last_tick_metrics(self):
        """The final round's row of the wire-gauge inputs."""
        return self._memo(
            "last_tick_metrics",
            lambda: {k: self.metrics[k][-1]
                     for k in ("messages_gossip",) if k in self.metrics})


def _pop_provenance(m: dict):
    """The round's per-channel evidence taken out of its metrics dict
    (``swim._round_metrics`` passes it through), so that it never reaches
    the stacked metrics; None with the knob off."""
    return m.pop("_provenance", None)


def _apply_planes(planes, rc: RoundCtx, slices) -> Tuple:
    """One round's plane folds, in stack order, publishing each plane's
    before/after slice into the context for cross-plane reads."""
    out = []
    for plane, sl in zip(planes, slices):
        rc._plane_prev[plane.name] = sl
        new_sl = plane.on_round(rc, sl)
        rc._plane_new[plane.name] = new_sl
        out.append(new_sl)
    return tuple(out)


def _finalize_planes(planes, fc: FinalCtx, slices) -> dict:
    return {plane.name: plane.finalize(fc, sl)
            for plane, sl in zip(planes, slices)}


def _stack_metrics(rows, params: "swim.SwimParams", device) -> dict:
    """The per-round metric rows stacked ``[n_rounds, ...]``; with no
    rows, every metric of the params with a leading 0
    (``swim.metric_shapes``)."""
    if rows:
        return {name: torch.stack([m[name] for m in rows])
                for name in rows[0]}
    return {name: torch.zeros((0,) + shape, dtype=torch.int32, device=device)
            for name, shape in swim.metric_shapes(params).items()}


def composed_scan(seed: int, params: "swim.SwimParams",
                  world: "swim.SwimWorld", n_rounds: int, planes=(),
                  state: Optional["swim.SwimState"] = None,
                  start_round: int = 0,
                  draws: Optional[Callable[[int], object]] = None,
                  knobs: Optional["swim.Knobs"] = None, device="cuda"):
    """Run the round ``n_rounds`` times from ``start_round`` with
    ``planes`` riding the carry: the one round loop behind ``run``,
    ``run_traced`` and :func:`run_composed`.

    ``draws`` (default ``TorchDraws(seed, device, params, world)``) is
    any callable ``round_idx -> draws``; ``knobs`` default to
    ``Knobs.from_params(params)``.  ``state`` is not modified (its rings
    are copied once, then updated in place).  Each carry is released as
    soon as the next one exists; while a plane stack rides, the stored
    carry before the round is held through it as ``RoundCtx.prev``.
    Nothing syncs with the host per round.

    Returns ``(final_state, {plane name: finalized slice}, metrics)``,
    the metrics stacked ``[n_rounds, ...]`` on the device."""
    device = swim.resolve_device(device)
    swim._check_world_device(world, device)
    if state is None:
        state = swim.initial_state(params, world, device=device)
    else:
        swim.check_lanes(state, params)
        state = swim._own_rings(state)
    if draws is None:
        draws = prng.TorchDraws(seed, device, params, world)
    kn = knobs if knobs is not None else swim.Knobs.from_params(params)
    joins, pushes = swim._schedules(params, world)
    slices = tuple(p.init(params, world) for p in planes)
    rows = []
    for round_idx in range(start_round, start_round + n_rounds):
        prev = state if planes else None
        # swim_tick's steps, with each carry released as soon as the next
        # exists: under the compact carry the narrow input is not held
        # through the round (unless a plane reads it), nor the decoded
        # planes through the encode.
        state = swim._decoded(state, round_idx, params)
        state, m = swim._wide_tick(state, round_idx, params, world,
                                   draws(round_idx), kn,
                                   joins.get(round_idx),
                                   pushes.get(round_idx, ()))
        state = swim._encoded(state, round_idx, params)
        prov = _pop_provenance(m)
        if planes:
            rc = RoundCtx(params, world, kn, round_idx, prev, state, m,
                          provenance=prov)
            slices = _apply_planes(planes, rc, slices)
            del rc, prev
        del prov
        rows.append(m)
    metrics = _stack_metrics(rows, params, device)
    fc = FinalCtx(params, world, kn, start_round + n_rounds, state, metrics)
    return state, _finalize_planes(planes, fc, slices), metrics


# --------------------------------------------------------------------------
# The observer stack
# --------------------------------------------------------------------------

def build_stack(with_trace: bool, with_metrics: bool, with_monitor: bool,
                monitor_spec=None, trace_capacity=None, metrics_spec=None,
                monitor_capacity=None, telemetry=None, metrics_state=None,
                monitor=None, with_provenance: bool = False,
                provenance_capacity=None, provenance=None):
    """The observer-plane stack of :func:`run_composed`, in the
    reference's order: trace, provenance, monitor, then metrics (whose
    ``chaos_violations`` counter reads the monitor's per-round count
    delta when both ride).  The monitor needs ``monitor_spec``
    (``ValueError`` otherwise); the provenance plane's ``init`` raises
    the reference's ``ValueError`` when ``SwimParams.provenance`` is off.
    ``provenance`` resumes a ``ProvenanceState``."""
    planes = []
    if with_trace:
        from scalecube_cluster_tpu_torch.telemetry import trace as ttrace

        planes.append(ttrace.TracePlane(
            capacity=(ttrace.DEFAULT_CAPACITY if trace_capacity is None
                      else trace_capacity),
            telemetry=telemetry))
    if with_provenance:
        from scalecube_cluster_tpu_torch.models import provenance as mprov

        planes.append(mprov.ProvenancePlane(
            capacity=(mprov.DEFAULT_CAPACITY if provenance_capacity is None
                      else provenance_capacity),
            state=provenance))
    if with_monitor:
        from scalecube_cluster_tpu_torch.chaos import monitor as cmonitor

        if monitor_spec is None:
            raise ValueError(
                "run_composed(with_monitor=True) needs monitor_spec (use "
                "chaos.monitor.MonitorSpec.passive(params) for the "
                "safety-only checks)")
        planes.append(cmonitor.MonitorPlane(
            monitor_spec,
            capacity=(cmonitor.DEFAULT_CAPACITY if monitor_capacity is None
                      else monitor_capacity),
            monitor=monitor))
    if with_metrics:
        from scalecube_cluster_tpu_torch.telemetry import metrics as tmetrics

        planes.append(tmetrics.MetricsPlane(
            (tmetrics.MetricsSpec.default() if metrics_spec is None
             else metrics_spec),
            metrics_state=metrics_state,
            chaos_from="monitor" if with_monitor else None))
    return tuple(planes)


def run_composed(seed: int, params: "swim.SwimParams",
                 world: "swim.SwimWorld", n_rounds: int, monitor_spec=None,
                 with_trace: bool = True, with_metrics: bool = True,
                 with_monitor: bool = True,
                 trace_capacity: Optional[int] = None, metrics_spec=None,
                 monitor_capacity: Optional[int] = None,
                 state: Optional["swim.SwimState"] = None,
                 start_round: int = 0, knobs: Optional["swim.Knobs"] = None,
                 telemetry=None, metrics_state=None, monitor=None,
                 with_provenance: bool = False,
                 provenance_capacity: Optional[int] = None,
                 draws: Optional[Callable[[int], object]] = None,
                 provenance=None, device="cuda"):
    """The full instrumented stack (event trace, invariant monitor,
    health-metrics registry, and with ``with_provenance`` the channel
    attribution) in one pass over the rounds, sharing one
    :class:`RoundCtx` a round; each plane's output and the state equal
    the single-plane aliases' (``run_traced``, ``run_monitored``,
    ``run_metered``).  The reference's arguments and defaults;
    ``with_*`` toggle planes, and resume slices thread through
    ``telemetry``, ``metrics_state``, ``monitor`` and ``provenance``
    (none is modified).  Returns ``(final_state, results, metrics)`` with
    ``results`` mapping each plane's name to its finalized slice."""
    stack = build_stack(
        with_trace, with_metrics, with_monitor, monitor_spec=monitor_spec,
        trace_capacity=trace_capacity, metrics_spec=metrics_spec,
        monitor_capacity=monitor_capacity, telemetry=telemetry,
        metrics_state=metrics_state, monitor=monitor,
        with_provenance=with_provenance,
        provenance_capacity=provenance_capacity, provenance=provenance)
    return composed_scan(seed, params, world, n_rounds, planes=stack,
                         state=state, start_round=start_round, draws=draws,
                         knobs=knobs, device=device)


# --------------------------------------------------------------------------
# The plane inventory (observer planes + the in-tick planes)
# --------------------------------------------------------------------------

# The protocol core and the knob-gated in-tick planes; models/sync.py,
# models/lifeguard.py and models/metadata.py declare their own rows as
# PLANE dicts, collected below.
_CORE_PLANES = (
    dict(name="protocol", kind="core", knobs=(), lanes=(
        "status", "inc", "spread_until", "suspect_deadline", "self_inc"),
        doc="the SWIM round itself (models/swim.swim_tick)"),
    dict(name="delay", kind="in-tick", knobs=("max_delay_rounds",),
         lanes=("inbox_ring", "flag_ring"),
         doc="delayed-delivery rings (0 = same-round-or-lost)"),
    dict(name="user_gossip", kind="in-tick", knobs=("n_user_gossips",),
         lanes=("g_infected", "g_spread_until", "g_ring"),
         doc="user-payload gossip riding the membership channels"),
    dict(name="open_world", kind="in-tick",
         knobs=("open_world", "epoch_guard"), lanes=("epoch",),
         doc="JOIN admission into recycled slots, identity-epoch lane"),
)

_OBSERVER_PLANES = (
    dict(name="trace", kind="observer", knobs=(), lanes=(),
         doc="membership event trace (telemetry/trace.TracePlane)"),
    dict(name="provenance", kind="observer", knobs=("provenance",),
         lanes=(),
         doc="per-belief channel attribution "
             "(models/provenance.ProvenancePlane)"),
    dict(name="monitor", kind="observer", knobs=(), lanes=(),
         doc="invariant monitor (chaos/monitor.MonitorPlane)"),
    dict(name="metrics", kind="observer", knobs=(), lanes=(),
         doc="health-metrics registry (telemetry/metrics.MetricsPlane)"),
)


def plane_registry() -> Tuple[dict, ...]:
    """Every plane the composed runner knows: the protocol core, the
    knob-gated in-tick planes (with the rows ``models/sync.py``,
    ``models/lifeguard.py`` and ``models/metadata.py`` declare) and the
    observer planes: name, kind, gating knobs, ``SwimState`` lanes."""
    from scalecube_cluster_tpu_torch.models import lifeguard, metadata, sync

    return _CORE_PLANES[:1] + (dict(sync.PLANE), dict(lifeguard.PLANE),
                               dict(metadata.PLANE)) \
        + _CORE_PLANES[1:] + _OBSERVER_PLANES
