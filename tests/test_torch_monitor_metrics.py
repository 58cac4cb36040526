"""The port's health-metrics plane (``telemetry/metrics.py``, ``run_metered``)
and invariant monitor (``chaos/monitor.py``, ``run_monitored``), the full
instrumented stack (``models/compose.run_composed``) and the host-side
journals (``telemetry/sink.py``) against the JAX package.

- the registry ops on seeded inputs (an empty ``observe`` too);
- ``run_metered`` in two chunks of 20 rounds (the second resumes the
  first's ``metrics_state``) on the reference's draws: shift wide with
  the SYNC plane, and scatter compact + ``wire24`` with Lifeguard and the
  open world (``lhm``, ``joins_admitted``); state, metrics, counters,
  gauges and histograms exact;
- ``run_monitored`` in two chunks (the second resumes the first's
  monitor), each code tripped as in the reference's
  ``tests/test_chaos_monitor.py``: a pristine spec with loss, a timeout
  above the bound, corrupt timers, the persistent overflow, the SYNC
  plane's post-heal divergence; ``check_round`` directly on a direct
  regression, a DEAD winner, saturated cells and both self lanes, a code
  no longer fresh, and overflow one row below, at, and past capacity;
  lanes, count, dropped, counts, first rounds and ``verdict()`` exact.
  The two join codes, in the guard and naive arms, are held in
  ``tests/test_torch_open_world.py``;
- ``run_composed`` (trace, monitor, default metrics) and
  ``run_monitored_metered`` against the reference's stack, whose
  program (two resumed chunks) also runs every monitored case;
  ``build_stack`` raising only for provenance;
- journals both ways: a port journal through the reference's
  ``read_records`` and ``query.load_report``, a reference journal
  through the port's, and ``stream_metered_run``'s resume dedup against
  the reference's window rows.

Cost: four reference programs at N = 16, lowered one after another and
compiled in the background at XLA's backend optimizations off (no delay
sums, so no FMA to keep).

``run_metered`` and ``check_round`` are held in
``tests/test_torch_monitor_metrics_runs.py``, on the settings and
programs defined here.

The registry ops, ``build_stack`` and the journals are held in
``tests/test_torch_monitor_metrics_journals.py``.
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scalecube_cluster_tpu.chaos import monitor as jmonitor  # noqa: E402
from scalecube_cluster_tpu.models import compose as jcompose  # noqa: E402
from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu.telemetry import metrics as jmetrics  # noqa: E402
from scalecube_cluster_tpu.telemetry import trace as jtrace  # noqa: E402
from scalecube_cluster_tpu_torch import interop  # noqa: E402
from scalecube_cluster_tpu_torch.chaos import monitor  # noqa: E402
from scalecube_cluster_tpu_torch.models import compose, swim  # noqa: E402
from scalecube_cluster_tpu_torch.telemetry import metrics  # noqa: E402
from tests.test_swim_model import fast_config  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    assert_metrics_equal, assert_monitor_equal, assert_registry_equal,
    assert_state_equal, jax_draws, one_torch_thread, port_monitor_spec,
    port_params, port_world)

pytestmark = pytest.mark.torchport

QUICK = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}
INT32_MAX = 2**31 - 1
N, CHUNK, ROUNDS = 16, 20, 40
CRASH, CRASH_AT = 3, 5
CAPACITY = 16
SPEC = jmetrics.MetricsSpec.default()
# The metered runs: name -> params overrides.
METERED = {
    "shift-wide-sync": dict(delivery="shift", sync_interval=8),
    "scatter-compact_wire24-lifeguard-join": dict(
        delivery="scatter", compact_carry=True, wire24=True, lhm_max=4,
        open_world=True),
}
JOIN_AT = 14


def _params(**overrides):
    return jswim.SwimParams.from_config(fast_config(), n_members=N,
                                        **overrides)


def _world(params):
    """Node 3 crashed at round 5 (joined by a new identity at round 14
    under the open world), two partition phases of 10 rounds, the first
    a single partition: the program's worlds share one shape."""
    world = jswim.SwimWorld.healthy(params).with_crash(CRASH, CRASH_AT)
    world = world.with_partition_schedule(np.zeros((2, N), np.int8), 10)
    if params.open_world:
        world = world.with_join(CRASH, JOIN_AT)
    return world


def _heal_world(params):
    """The crash world split in halves in rounds 0-9 and 20-29."""
    split = np.stack([np.arange(N) >= N // 2, np.zeros(N, bool)])
    return _world(params).with_partition_schedule(split.astype(np.int8), 10)


MONITORED = _params(delivery="shift", sync_interval=8)


def _knobs(params, **overrides):
    kn = jswim.Knobs.from_params(params)
    return dataclasses.replace(kn, **{k: jnp.asarray(v, getattr(kn, k).dtype)
                                      for k, v in overrides.items()})


def _monitor_spec(params, complete_by=None, agree_from=INT32_MAX):
    """The monitored program's spec: false suspicion and agreement
    checked, deadlines as data (``complete_by`` node 3's, or every
    subject's given as ``("all", round)``)."""
    cb = np.full((N,), INT32_MAX, np.int32)
    if isinstance(complete_by, tuple):
        cb[:] = complete_by[1]
    elif complete_by is not None:
        cb[CRASH] = complete_by
    return jmonitor.MonitorSpec(
        complete_by=jnp.asarray(cb), agree_from=jnp.int32(agree_from),
        check_agreement=True, check_false_suspicion=True)


def _copy(tree):
    return jax.tree.map(jnp.copy, tree)


def _stack_slices():
    """Fresh resume slices of the reference's full stack: the stack
    program takes them as data, so its two chunks share one program."""
    return dict(telemetry=jtrace.TelemetryState.init(N, N),
                monitor=jmonitor.MonitorState.init(CAPACITY),
                metrics_state=jmetrics.MetricsState.init(SPEC))


def _reference_stack(jworld, jspec, kn, jstate):
    """The reference's full stack (trace, monitor, metrics) in two
    chunks of ``CHUNK`` rounds, the second resuming the first's state
    and slices: ``[(state, results, metrics) after each chunk]``."""
    slices, out = _stack_slices(), []
    for start in (0, CHUNK):
        jstate, res, jm = _program("stack")(
            jax.random.key(0), jworld, monitor_spec=jspec,
            state=_copy(jstate), start_round=start, knobs=kn, **slices)
        out.append((jstate, res, jm))
        slices = dict(telemetry=res["trace"], monitor=res["monitor"],
                      metrics_state=res["metrics"])
    return out


@functools.lru_cache(maxsize=None)
def _draws(name):
    params = MONITORED if name == "monitored" else _params(**METERED[name])
    return jax_draws(jax.random.key(0), params, _world(params))


@functools.lru_cache(maxsize=None)
def _program(name):
    """One reference program (a metered setting's ``run_metered``, the
    full ``stack`` or ``check_round``), compiled with its draws' program
    beside it; states, worlds, knobs, specs and resume slices are its
    data."""
    key = jax.random.key(0)
    params, world = MONITORED, _world(MONITORED)
    state, kn = jswim.initial_state(params, world), _knobs(params)
    if name in METERED:
        params = _params(**METERED[name])
        world = _world(params)
        lowered = jswim.run_metered.lower(
            key, params, world, CHUNK, spec=SPEC,
            state=jswim.initial_state(params, world), start_round=0,
            knobs=jswim.Knobs.from_params(params),
            metrics_state=jmetrics.MetricsState.init(SPEC))
    elif name == "stack":
        lowered = jcompose.run_composed.lower(
            key, params, world, CHUNK, monitor_spec=_monitor_spec(params),
            state=state, start_round=0, knobs=kn, **_stack_slices())
    else:
        lowered = jax.jit(jmonitor.check_round, static_argnums=(2,)).lower(
            jmonitor.MonitorState.init(CAPACITY), _monitor_spec(params),
            params, kn, jnp.int32(0), state, state, world)
    with ThreadPoolExecutor(1) as pool:
        warm = pool.submit(lambda: _draws(
            name if name in METERED else "monitored")(0))
        program = lowered.compile(compiler_options=QUICK)
        warm.result()
    return program


# --------------------------------------------------------------------------
# The registry ops
# --------------------------------------------------------------------------


def ms_spec():
    return metrics.MetricsSpec.default()


# --------------------------------------------------------------------------
# run_metered
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _metered_both(name):
    """Two resumed chunks of ``run_metered`` on both sides, compared
    chunk by chunk; returns the reference's rows (``metrics_window``
    payloads, reset between chunks as ``stream_metered_run`` does) and
    the port's final state."""
    jparams = _params(**METERED[name])
    jworld = _world(jparams)
    params, world = port_params(jparams), port_world(jworld)
    draws = _draws(name)
    jstate = jswim.initial_state(jparams, jworld)
    jms = jmetrics.MetricsState.init(SPEC)
    state, ms, rows = None, None, []
    for start in (0, CHUNK):
        jstate, jms, jm = _program(name)(
            jax.random.key(0), jworld, state=_copy(jstate),
            start_round=start, knobs=jswim.Knobs.from_params(jparams),
            metrics_state=_copy(jms))
        state, ms, m = swim.run_metered(
            0, params, world, CHUNK, state=state, start_round=start,
            draws=draws, metrics_state=ms, device="cpu")
        assert_state_equal(jstate, state)
        assert_metrics_equal(jm, m)
        assert_registry_equal(jms, ms)
        rows.append({"round_start": start, "round_end": start + CHUNK,
                     **jmetrics.to_json(jms, SPEC)})
        jms, ms = jmetrics.reset_window(jms), metrics.reset_window(ms)
    return rows, state


# --------------------------------------------------------------------------
# run_monitored
# --------------------------------------------------------------------------

# name -> (knob overrides, complete_by of node 3, agree_from, state edit,
#          the codes that must trip)
MONITOR_CASES = {
    "false_suspicion": (dict(loss_probability=0.25), None, INT32_MAX, None,
                        {"FALSE_SUSPICION"}),
    "timeout_above_bound": (dict(suspicion_rounds=60), 24, INT32_MAX, None,
                            {"COMPLETENESS"}),
    "corrupt_timer": ({}, None, INT32_MAX, "timers", {"TIMER_BOUND"}),
    "persistent_overflow": ({}, ("all", 7), INT32_MAX, None,
                            {"COMPLETENESS"}),
    "post_heal_divergence": ({}, None, 14, "heal",
                             {"POST_HEAL_DIVERGENCE"}),
    "saturated_inc": ({}, None, INT32_MAX, "saturated",
                      {"WIRE_SATURATION"}),
}


def _corrupt_timers(state):
    """A pending timer on an ALIVE entry and a SUSPECT entry without one
    (the reference's ``test_corrupt_timer_state_trips_timer_bound``)."""
    return dataclasses.replace(
        state, suspect_deadline=state.suspect_deadline.at[2, 7].set(50),
        status=state.status.at[4, 9].set(1))


@functools.lru_cache(maxsize=None)
def _monitored_both(name):
    """``name``'s monitored run in two chunks on both sides, compared
    after each; returns the reference's final monitor and the port's
    params, world, spec, knobs and final monitor."""
    overrides, complete_by, agree_from, edit, _ = MONITOR_CASES[name]
    jparams = MONITORED
    jworld = _heal_world(jparams) if edit == "heal" else _world(jparams)
    jspec = _monitor_spec(jparams, complete_by, agree_from)
    kn = _knobs(jparams, **overrides)
    jstate = jswim.initial_state(jparams, jworld)
    if edit == "timers":
        jstate = _corrupt_timers(jstate)
    elif edit == "saturated":
        # An incarnation past the wire's cap (the reference's
        # ``test_saturated_incarnation_trips_wire_saturation``).
        jstate = dataclasses.replace(jstate, inc=jstate.inc.at[1, 6].set(
            jswim._wire_inc_sat(jparams) + 100))
    params, world = port_params(jparams), port_world(jworld)
    spec = port_monitor_spec(jspec)
    pkn = swim.Knobs.for_params(params, **overrides)
    state = interop.state_from_arrays(
        {f.name: np.asarray(getattr(jstate, f.name))
         for f in dataclasses.fields(jstate)}, device="cpu")
    state0 = state
    mon = None
    for start, (jstate, res, jm) in zip(
            (0, CHUNK), _reference_stack(jworld, jspec, kn, jstate)):
        jmon = res["monitor"]
        state, mon, m = monitor.run_monitored(
            0, params, world, spec, CHUNK, capacity=CAPACITY, state=state,
            start_round=start, draws=_draws("monitored"), knobs=pkn,
            monitor=mon, device="cpu")
        assert_state_equal(jstate, state)
        assert_metrics_equal(jm, m)
        assert_monitor_equal(jmon, mon)
    return jmon, (params, world, spec, pkn, state0, mon)


@pytest.mark.parametrize("name", sorted(MONITOR_CASES))
def test_run_monitored_matches_reference(name):
    """Every lane, count, dropped, the code counts, first rounds and the
    verdict equal the reference's after each chunk, and the scenario
    trips the code it was built for."""
    _, (*_, mon) = _monitored_both(name)
    v = monitor.verdict(mon)
    tripped = {c for c, d in v["codes"].items() if d["violations"]}
    assert MONITOR_CASES[name][4] <= tripped
    if name == "persistent_overflow":
        assert int(mon.count) == CAPACITY and int(mon.dropped) > 0
        code = monitor.InvariantCode.COMPLETENESS
        assert {e.round for e in monitor.decode_violations(mon)
                if e.code == code} == {7}
        assert int(mon.code_counts[code]) > CAPACITY


def test_run_monitored_one_pass_equals_chunks():
    """One 40-round monitored run equals the two resumed chunks (the
    resumed monitor and state are not modified)."""
    _, (params, world, spec, kn, state0, mon) = _monitored_both(
        "persistent_overflow")
    before = {f: getattr(mon, f).clone() for f in ("lanes", "count")}
    _, once, _ = monitor.run_monitored(
        0, params, world, spec, ROUNDS, capacity=CAPACITY, state=state0,
        draws=_draws("monitored"), knobs=kn, device="cpu")
    for field in dataclasses.fields(monitor.MonitorState):
        assert torch.equal(getattr(once, field.name),
                           getattr(mon, field.name)), field.name
    _, again, _ = monitor.run_monitored(
        0, params, world, spec, 4, capacity=CAPACITY, start_round=ROUNDS,
        draws=_draws("monitored"), knobs=kn, monitor=mon, device="cpu")
    assert all(torch.equal(before[f], getattr(mon, f)) for f in before)
    assert int(again.code_counts.sum()) > int(mon.code_counts.sum())


def _check_inputs(case):
    """``(prev, new, monitor before)`` of a direct ``check_round`` case
    (reference arrays) on the monitored program's initial state."""
    prev = jswim.initial_state(MONITORED, _world(MONITORED))
    mon = jmonitor.MonitorState.init(CAPACITY)
    inc, status = np.array(prev.inc), np.array(prev.status)
    self_inc = np.array(prev.self_inc)
    new_inc, new_status, new_self = inc.copy(), status.copy(), self_inc.copy()
    sat = jswim._wire_inc_sat(MONITORED)
    if case in ("regression", "dead_winner", "not_fresh"):
        inc[2, 5], new_inc[2, 5] = 4, 1
        if case == "dead_winner":
            new_status[2, 5] = 2
        if case == "not_fresh":
            mon = dataclasses.replace(
                mon, code_counts=mon.code_counts.at[1].set(3),
                code_first_round=mon.code_first_round.at[1].set(2))
    elif case == "saturated":
        new_inc[1, 6] = sat + 100
        new_inc[9, 2] = -3
        self_inc[5], new_self[5] = 6, 2
        new_self[11] = sat + 1
    else:
        # Dense regressions: ``case`` = rows past the capacity, so the
        # record overflows below, at or past it.
        cells = CAPACITY + int(case.split(":")[1])
        inc.reshape(-1)[:cells] = 9
        new_inc.reshape(-1)[:cells] = 8
    prev = dataclasses.replace(prev, inc=jnp.asarray(inc),
                               status=jnp.asarray(status),
                               self_inc=jnp.asarray(self_inc))
    new = dataclasses.replace(prev, inc=jnp.asarray(new_inc),
                              status=jnp.asarray(new_status),
                              self_inc=jnp.asarray(new_self))
    return prev, new, mon


def _port_state(jstate):
    return interop.state_from_arrays(
        {f.name: np.asarray(getattr(jstate, f.name))
         for f in dataclasses.fields(jstate)}, device="cpu")


CHECK_CASES = ["regression", "dead_winner", "not_fresh", "saturated",
               "overflow:-1", "overflow:0", "overflow:5"]


# --------------------------------------------------------------------------
# The full stack
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _composed_both():
    """The full stack over ``ROUNDS`` rounds, the reference's in two
    resumed chunks, the port's in one pass; the monitored program's spec
    with no deadline (the passive checks and the two promises, which a
    lossless crash run keeps)."""
    jparams, jworld = MONITORED, _world(MONITORED)
    jspec = _monitor_spec(jparams)
    jstate = jswim.initial_state(jparams, jworld)
    (_, _, jm0), (jstate, jres, jm1) = _reference_stack(
        jworld, jspec, _knobs(jparams), jstate)
    jm = {k: np.concatenate([np.asarray(jm0[k]), np.asarray(v)])
          for k, v in jm1.items()}
    params, world = port_params(jparams), port_world(jworld)
    spec = port_monitor_spec(jspec)
    state, res, m = compose.run_composed(
        0, params, world, ROUNDS, monitor_spec=spec,
        monitor_capacity=CAPACITY, draws=_draws("monitored"), device="cpu")
    return (jstate, jres, jm), (params, world, spec, state, res, m)


def test_run_composed_matches_reference():
    """The full stack (trace, monitor, default metrics) in one pass
    equals the reference's in two resumed chunks: state, metrics, every
    trace lane and first-round matrix, the monitor and the registry."""
    (jstate, jres, jm), (_, _, _, state, res, m) = _composed_both()
    assert list(res) == ["trace", "monitor", "metrics"]
    assert_state_equal(jstate, state)
    assert_metrics_equal(jm, m)
    got = interop.telemetry_to_arrays(res["trace"])
    for name, want in (("lanes", jres["trace"].trace.lanes),
                       ("count", jres["trace"].trace.count),
                       ("dropped", jres["trace"].trace.dropped),
                       ("first_suspect", jres["trace"].first_suspect),
                       ("first_removed", jres["trace"].first_removed)):
        np.testing.assert_array_equal(got[name], np.asarray(want),
                                      err_msg=name)
    assert_monitor_equal(jres["monitor"], res["monitor"])
    assert_registry_equal(jres["metrics"], res["metrics"])
    assert int(res["trace"].trace.count) > 0


def test_run_monitored_metered_matches_reference_stack():
    """``run_monitored_metered`` is the reference stack's monitor and
    registry (``chaos_violations`` included) and its state and
    metrics."""
    (jstate, jres, jm), (params, world, spec, *_) = _composed_both()
    draws = _draws("monitored")
    state, mon, ms, m = monitor.run_monitored_metered(
        0, params, world, spec, ROUNDS, capacity=CAPACITY, draws=draws,
        device="cpu")
    assert_state_equal(jstate, state)
    assert_metrics_equal(jm, m)
    assert_monitor_equal(jres["monitor"], mon)
    assert_registry_equal(jres["metrics"], ms)


# --------------------------------------------------------------------------
# Journals
# --------------------------------------------------------------------------


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in ("run_id",)}


def jtrace_event(e):
    from scalecube_cluster_tpu.telemetry.events import MembershipTraceEvent

    return MembershipTraceEvent.from_json(e.to_json())
