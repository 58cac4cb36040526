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
not the provenance plane rides.

:func:`composed_batch_scan` is the batched runner: B independent runs
of one params advancing round by round together, each row running its
own round, the planes folding the stacked batch through one
:class:`BatchRoundCtx` (a plane's ``init_batch``/``on_round_batch``
where it has them, its serial hooks row by row otherwise).  The
row-sharded runners (``composed_shard_scan``, ``_pipelined_rounds``) are
not ported (ROADMAP A11).

The in-tick planes (SYNC anti-entropy, Lifeguard, the open-world epoch
lane, metadata, delay rings, user gossip) are compiled into the round by
their ``SwimParams`` knobs and carried in ``SwimState`` lanes;
:func:`plane_registry` lists them beside the observer planes.
"""

from __future__ import annotations

import copy
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


def _draws_for(seed: int, params, world, draws, shift_key, device):
    """The run's draw source: ``draws`` as given, else the port's own
    ``TorchDraws`` with ``shift_key`` as its shift seed."""
    if draws is None:
        return prng.TorchDraws(seed, device, params, world,
                               shift_seed=shift_key)
    if shift_key is not None:
        raise ValueError("shift_key seeds the port's own draws; the draws "
                         "given carry their own shifts")
    return draws


def composed_scan(seed: int, params: "swim.SwimParams",
                  world: "swim.SwimWorld", n_rounds: int, planes=(),
                  state: Optional["swim.SwimState"] = None,
                  start_round: int = 0,
                  draws: Optional[Callable[[int], object]] = None,
                  knobs: Optional["swim.Knobs"] = None, shift_key=None,
                  device="cuda"):
    """Run the round ``n_rounds`` times from ``start_round`` with
    ``planes`` riding the carry: the one round loop behind ``run``,
    ``run_traced`` and :func:`run_composed`.

    ``draws`` (default ``TorchDraws(seed, device, params, world,
    shift_seed=shift_key)``) is any callable ``round_idx -> draws``;
    ``shift_key`` (an int, default ``seed``) seeds only the channel
    shifts (and the anti-entropy offset) of the port's own draws, the
    shared-shift hook of the batched sweeps; with ``draws`` given it
    raises ``ValueError`` (the caller's draws carry their shifts).
    ``knobs`` default to ``Knobs.from_params(params)``.  ``state`` is not
    modified (its rings are copied once, then updated in place).  Each
    carry is released as soon as the next one exists; while a plane stack
    rides, the stored carry before the round is held through it as
    ``RoundCtx.prev``.
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
    draws = _draws_for(seed, params, world, draws, shift_key, device)
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
# The batched runner: B independent runs advancing round by round together
# --------------------------------------------------------------------------


#: RoundCtx memo keys whose batched values slice row by row into a per-row
#: fold's cache.  ``any_status_change`` is left out on purpose: the
#: batched value is the batch-level predicate (any row changed), not a
#: row's own, so a per-row fold recomputes its own from the seeded
#: ``status_changed``.
_ROW_CACHE_KEYS = ("alive_now", "status_changed", "prev_wide", "new_wide",
                   "prev_deadline_wide")


class _Rows(list):
    """A per-row plane's slice in a batched run: one slice a row."""


def row_of(x, b: int):
    """Row ``b`` of a batch-leading value: a tensor's ``x[b]`` (a view), a
    per-row plane's row slice, and the same taken through dataclasses,
    dicts, tuples and lists; any other value is shared by every row."""
    if isinstance(x, (torch.Tensor, _Rows)):
        return x[b]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: row_of(getattr(x, f.name), b)
                          for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: row_of(v, b) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(row_of(v, b) for v in x)
    return x


def stack_rows(rows):
    """The inverse of :func:`row_of`: row values of one structure stacked
    batch-leading (tensors by ``torch.stack``; one row as a view with a
    leading 1, no copy); any other value is the first row's."""
    first = rows[0]
    if isinstance(first, torch.Tensor):
        return first.unsqueeze(0) if len(rows) == 1 else torch.stack(rows)
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return type(first)(**{
            f.name: stack_rows([getattr(r, f.name) for r in rows])
            for f in dataclasses.fields(first)})
    if isinstance(first, dict):
        return {k: stack_rows([r[k] for r in rows]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(stack_rows(list(col)) for col in zip(*rows))
    return first


class StackedWorld:
    """B worlds of one shape (``rows``) with the fields the batched planes
    read stacked [B, ...]: ``down_from``, ``down_until``, ``leave_at``,
    ``join_at`` [B, N] and ``subject_ids`` [B, K] int32.  ``alive_at`` and
    ``epoch_at`` give [B, N], as ``SwimWorld``'s do a row."""

    FIELDS = ("down_from", "down_until", "leave_at", "join_at",
              "subject_ids")

    def __init__(self, worlds):
        self.rows = list(worlds)
        for name in self.FIELDS:
            setattr(self, name,
                    torch.stack([getattr(w, name) for w in self.rows]))

    @property
    def device(self) -> torch.device:
        return self.down_from.device

    def alive_at(self, round_idx: int) -> torch.Tensor:
        return swim.SwimWorld.alive_at(self, round_idx)

    def epoch_at(self, round_idx: int) -> torch.Tensor:
        return swim.SwimWorld.epoch_at(self, round_idx)


class BatchRoundCtx(RoundCtx):
    """The batched :class:`RoundCtx`: ``prev``/``new`` are the batch's
    carries stacked [B, ...], ``world`` a :class:`StackedWorld`, ``kn``
    the B rows' knobs, ``metrics`` and ``provenance`` the B rows' own.
    The derivations are computed once over the whole batch and memoised,
    so every plane reads the same [B, ...] values.

    :attr:`any_status_change` (inherited) is the batch-level emptiness
    predicate: any row changed.  The reference gates its batched folds on
    it with ``lax.cond``; the port computes through it (no host read a
    round), and the record kernels' silent cells are the identity, so
    every row stays bit-identical to its serial run."""

    __slots__ = ()

    def _rows_wide(self, st, cursor):
        """``st`` decoded wide: elementwise on the batch, but the compact
        carry's decode (a kernel over [N, K]) row by row."""
        if not self.params.compact_carry:
            return wide_view(self.params, st, cursor)
        return stack_rows([wide_view(self.params, row_of(st, b), cursor)
                           for b in range(len(self.kn))])

    @property
    def prev_wide(self):
        return self._memo("prev_wide",
                          lambda: self._rows_wide(self.prev, self.round_idx))

    @property
    def new_wide(self):
        return self._memo(
            "new_wide", lambda: self._rows_wide(self.new, self.round_idx + 1))

    def per_row_fold(self, plane, rows):
        """A plane's serial ``on_round`` run row by row, the fallback for
        a plane without ``on_round_batch``: ``plane`` holds one plane copy
        a row and ``rows`` one slice a row.  Each row gets a plain
        :class:`RoundCtx` seeded with its row of every batch-level memo
        already paid (:data:`_ROW_CACHE_KEYS`) and of every plane slice
        already published, so cross-plane reads and the computed-once
        contract hold across the row boundary."""
        cached = [k for k in _ROW_CACHE_KEYS if k in self._cache]
        out = _Rows()
        for b, (copy, sl) in enumerate(zip(plane, rows)):
            rc = RoundCtx(self.params, self.world.rows[b], self.kn[b],
                          self.round_idx, row_of(self.prev, b),
                          row_of(self.new, b), self.metrics[b],
                          offset=self.offset, provenance=self.provenance[b])
            rc._cache.update((k, row_of(self._cache[k], b)) for k in cached)
            rc._plane_prev.update((n, row_of(v, b))
                                  for n, v in self._plane_prev.items())
            rc._plane_new.update((n, row_of(v, b))
                                 for n, v in self._plane_new.items())
            out.append(copy.on_round(rc, sl))
        return out


def _apply_planes_batch(planes, rc: BatchRoundCtx, slices) -> Tuple:
    """One round's plane folds over the batched context, in stack order: a
    plane with ``on_round_batch`` folds the whole batch at once; any other
    folds row by row (:meth:`BatchRoundCtx.per_row_fold`)."""
    out = []
    for plane, sl in zip(planes, slices):
        rc._plane_prev[plane.name] = sl
        if isinstance(sl, _Rows):
            new_sl = rc.per_row_fold(plane.rows, sl)
        else:
            new_sl = plane.on_round_batch(rc, sl)
        rc._plane_new[plane.name] = new_sl
        out.append(new_sl)
    return tuple(out)


class _RowPlanes:
    """A plane without a batched fold, in a batched run: one copy of it a
    row (a plane may keep per-world facts from its ``init``)."""

    def __init__(self, plane, params, worlds):
        self.name = plane.name
        self.rows = [copy.copy(plane) for _ in worlds]
        self.slices = _Rows(p.init(params, w)
                            for p, w in zip(self.rows, worlds))


def composed_batch_scan(seeds, params: "swim.SwimParams", worlds,
                        n_rounds: int, planes=(), states=None,
                        start_round: int = 0, draws=None, knobs=None,
                        shift_key=None, device="cuda"):
    """The batched :func:`composed_scan`: B independent runs (B scenarios,
    one scenario under B knob settings, or any mix) advancing round by
    round together, with the planes folding the whole batch.

    ``seeds``, ``worlds`` and ``knobs`` (default ``Knobs.from_params``
    for every row) are sequences of length B; ``draws`` an optional
    sequence of B callables ``round_idx -> draws`` (default each row's
    ``TorchDraws(seed, device, params, world, shift_seed=shift_key)``:
    one ``shift_key`` shares the channel shifts across the batch);
    ``states`` an optional batch-leading ``SwimState`` to resume (as
    returned; not modified).

    Each round every row runs the round (its own merge launch), the B new
    carries are stacked once, and one :class:`BatchRoundCtx` feeds every
    plane: ``on_round_batch`` where a plane has it (the trace and the
    monitor: one record launch a round or a code for the whole batch),
    the serial ``on_round`` row by row otherwise (the metrics and
    provenance planes, one plane copy a row).  A batched plane's resume
    slice is batch-leading; a per-row plane's is given to every row.

    Contract (the reference's): B = 1 equals :func:`composed_scan` bit
    for bit, and row i of any batch equals the serial run of row i's
    (seed, world, knobs) alone.

    Returns ``(final_states, {plane name: finalized slice}, metrics)``,
    each batch-leading (metrics ``[B, n_rounds, ...]``)."""
    device = swim.resolve_device(device)
    worlds, seeds = list(worlds), list(seeds)
    batch = len(worlds)
    kns = ([swim.Knobs.from_params(params)] * batch if knobs is None
           else list(knobs))
    if draws is None:
        sources = [_draws_for(s, params, w, None, shift_key, device)
                   for s, w in zip(seeds, worlds)]
    else:
        sources = [_draws_for(s, params, w, d, shift_key, device)
                   for s, w, d in zip(seeds, worlds, draws)]
    if not batch or {len(seeds), len(kns), len(sources)} != {batch}:
        raise ValueError(f"composed_batch_scan: {len(seeds)} seeds, {batch} "
                         f"worlds, {len(kns)} knobs and {len(sources)} draw "
                         f"sources (need the same B >= 1 of each)")
    for w in worlds:
        swim._check_world_device(w, device)
    if states is None:
        rows = [swim.initial_state(params, w, device=device) for w in worlds]
    else:
        rows = [row_of(states, b) for b in range(batch)]
        for st in rows:
            swim.check_lanes(st, params)
        rows = [swim._own_rings(st) for st in rows]
    schedules = [swim._schedules(params, w) for w in worlds]
    stacked_world = StackedWorld(worlds) if planes else None
    row_planes = {}
    slices = []
    for p in planes:
        if hasattr(p, "on_round_batch"):
            slices.append(p.init_batch(params, worlds))
        else:
            row_planes[p.name] = _RowPlanes(p, params, worlds)
            slices.append(row_planes[p.name].slices)
    fold_planes = tuple(row_planes.get(p.name, p) for p in planes)
    slices = tuple(slices)
    stacked = stack_rows(rows) if planes else None
    metric_rows = [[] for _ in range(batch)]
    for round_idx in range(start_round, start_round + n_rounds):
        provs = []
        for b in range(batch):
            joins, pushes = schedules[b]
            st = swim._decoded(rows[b], round_idx, params)
            st, m = swim._wide_tick(st, round_idx, params, worlds[b],
                                    sources[b](round_idx), kns[b],
                                    joins.get(round_idx),
                                    pushes.get(round_idx, ()))
            rows[b] = swim._encoded(st, round_idx, params)
            provs.append(_pop_provenance(m))
            metric_rows[b].append(m)
        if planes:
            new_stacked = stack_rows(rows)
            rc = BatchRoundCtx(params, stacked_world, kns, round_idx, stacked,
                               new_stacked, [m[-1] for m in metric_rows],
                               provenance=provs)
            slices = _apply_planes_batch(fold_planes, rc, slices)
            stacked = new_stacked
            del rc
        del provs
    per_row = [_stack_metrics(m, params, device) for m in metric_rows]
    metrics = {name: torch.stack([m[name] for m in per_row])
               for name in per_row[0]}
    end_round = start_round + n_rounds
    results = {}
    for p, fold, sl in zip(planes, fold_planes, slices):
        copies = fold.rows if isinstance(fold, _RowPlanes) else [p] * batch
        results[p.name] = stack_rows([
            copies[b].finalize(
                FinalCtx(params, worlds[b], kns[b], end_round, rows[b],
                         per_row[b]), row_of(sl, b))
            for b in range(batch)])
    return stack_rows(rows), results, metrics


def batch_shard_unsupported_reason(params: "swim.SwimParams") -> str:
    """Why :func:`composed_batch_scan` does not compose with a member-row
    mesh: a declared reason, never a silent wrong answer.  The batch runs
    independent worlds on one device; the sharded runner's collectives
    reduce over member rows of one world split across devices.  Shard
    the members or batch the scenarios, not both in one program; for
    batch throughput on several cards, run one batch a card over
    disjoint scenario sub-batches."""
    return ("batch axis is single-device: composed_shard_scan's "
            "shard_map collectives reduce over member rows of one "
            "world and cannot be vmapped over independent batched "
            "worlds")


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
                 provenance=None, shift_key=None, device="cuda"):
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
                         knobs=knobs, shift_key=shift_key, device=device)


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
