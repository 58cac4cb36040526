"""The port's composed runner and membership event trace
(``models/compose.py``, ``telemetry/{events,trace,sink}.py``,
``kernels/trace.py``, ``Knobs.for_params``, ``models/fd.py``) against the
JAX package.

- ``run_traced`` against the reference's on its own draws (N = 12, full
  view, 36 rounds: a crash, a graceful leave, a short crash with
  refutations): shift wide, scatter ``int16_wire`` with delays and
  Lifeguard, shift compact with
  the open-world plane and a join into the crashed slot (JOINED, and the
  joiner's ADDED), scatter compact + ``wire24`` at a capacity that
  overflows; every trace lane, count, dropped, both first-round
  matrices, every state lane and metric exact;
- resumes: two chunks through ``telemetry=``, a fresh buffer through
  ``TelemetryState.resume``, a reference trace carried in through
  ``interop.telemetry_from_arrays``;
- ``latency_histograms`` and ``decode_events`` against the reference's
  (the empty window and the open last bucket too);
- ``stream_traced_run`` against the monolithic run, and its exact
  per-segment drops;
- ``run_composed``, the provenance plane's ``NotImplementedError``,
  ``RoundCtx`` memoisation and ``plane_registry``;
- ``Knobs.for_params``'s raises and coercion, and ``knobs=`` runs exact
  against the reference's: float32-inexact overrides through a delayed
  run with Lifeguard, a ``suspicion_rounds`` past the compact carry's
  horizon;
- ``fd.run`` on ``tests/test_fd_model.py``'s scenarios, shortened;
- ``derive_event_codes``, the record kernel's plain version and the
  fused observe's (``trace_observe_reference``: the derivation, the
  first-round stamps and the record of a round) against the reference's
  on seeded planes.

Cost: five reference programs, lowered one after another and compiled
in the background with the draw programs, at XLA's backend optimizations
off except the delayed one (its delay sums need XLA's default FMA
fusion).
"""

import dataclasses
import functools
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scalecube_cluster_tpu.models import compose as jcompose  # noqa: E402
from scalecube_cluster_tpu.models import fd as jfd  # noqa: E402
from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu.telemetry import trace as jtrace  # noqa: E402
from scalecube_cluster_tpu_torch import interop  # noqa: E402
from scalecube_cluster_tpu_torch.kernels import trace as trace_kernel  # noqa: E402,E501
from scalecube_cluster_tpu_torch.models import compose, fd, swim  # noqa: E402
from scalecube_cluster_tpu_torch.telemetry import events, sink  # noqa: E402
from scalecube_cluster_tpu_torch.telemetry import trace  # noqa: E402
from tests.test_swim_model import fast_config  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    assert_metrics_equal, assert_state_equal, jax_draws, one_torch_thread,
    port_params, port_world)

pytestmark = pytest.mark.torchport

QUICK = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}
N, ROUNDS, SPLIT = 12, 36, 20
CRASH, LEAVER, BLINK, JOIN_AT = 3, 5, 7, 14
SMALL_CAPACITY = 24
# The traced runs: (params overrides, capacity).
TRACED = {
    "shift-wide": (dict(delivery="shift"), jtrace.DEFAULT_CAPACITY),
    "scatter-int16_wire-delayed": (
        dict(delivery="scatter", int16_wire=True, mean_delay_ms=60.0,
             max_delay_rounds=2, lhm_max=4), jtrace.DEFAULT_CAPACITY),
    "shift-compact-join": (dict(delivery="shift", compact_carry=True,
                                open_world=True), jtrace.DEFAULT_CAPACITY),
    "scatter-compact_wire24-overflow": (
        dict(delivery="scatter", compact_carry=True, wire24=True),
        SMALL_CAPACITY),
}
FD_N, FD_ROUNDS = 32, 30


def _params(**overrides):
    return jswim.SwimParams.from_config(fast_config(), n_members=N,
                                        loss_probability=0.05, **overrides)


def _world(params):
    world = (jswim.SwimWorld.healthy(params).with_crash(CRASH, 2)
             .with_leave(LEAVER, 8).with_crash(BLINK, 3, until_round=12))
    if params.open_world:
        world = world.with_join(CRASH, JOIN_AT)
    return world


def _fd_params():
    return jswim.SwimParams.from_config(fast_config(), n_members=FD_N,
                                        delivery="scatter")


def _fd_crash():
    params = _fd_params()
    return params, jswim.SwimWorld.healthy(params).with_crash(0, 0)


def _fd_planted():
    """tests/test_fd_model.py's planted suspicion: observer 1 holds live
    node 0 SUSPECT, hot, with probing off and timers past the horizon.
    The fd program's params (worlds, states and knobs are its data)."""
    params = _fd_params()
    world = jswim.SwimWorld.healthy(params)
    state = jswim.initial_state(params, world)
    status = np.asarray(state.status).copy()
    status[1, 0] = 1
    state = dataclasses.replace(
        state, status=jnp.asarray(status),
        spread_until=state.spread_until.at[1, 0].set(10_000))
    knobs = dataclasses.replace(jfd.fd_only_knobs(params),
                                ping_every=jnp.int32(0),
                                suspicion_rounds=jnp.int32(2**30))
    return params, world, state, knobs


def _setup(name):
    """``(program kind, params, world, rounds, capacity, state, knobs)``
    of a reference program."""
    kind, _, rest = name.partition(":")
    if kind == "traced":
        overrides, cap = TRACED[rest]
        params = _params(**overrides)
        return "traced", params, _world(params), ROUNDS, cap, None, None
    if kind == "fd":
        params, world = _fd_crash()
        return "run", params, world, FD_ROUNDS, None, None, None
    raise KeyError(name)


NAMES = [f"traced:{name}" for name in TRACED] + ["fd:"]


def _args(name):
    kind, params, world, rounds, cap, state, knobs = _setup(name)
    if state is None:
        state = jswim.initial_state(params, world)
    if knobs is None:
        knobs = jswim.Knobs.from_params(params)
    return kind, params, world, rounds, cap, state, knobs


@functools.lru_cache(maxsize=None)
def _draws(name):
    """The reference's draws of ``name``'s runs (one jitted draw program
    a params)."""
    _, params, world, _, _, _, _ = _setup(name)
    return jax_draws(jax.random.key(0), params, world)


@functools.lru_cache(maxsize=None)
def _programs():
    """Every reference program, lowered one after another (tracing holds
    the GIL) and compiled in the background.  Each takes ``knobs`` as
    data, so one program serves every knob setting of its params."""
    compiling = {}
    with ThreadPoolExecutor(4) as pool:
        for name in NAMES:
            kind, params, world, rounds, cap, state, knobs = _args(name)
            if kind == "traced":
                lowered = jswim.run_traced.lower(
                    jax.random.key(0), params, world, rounds,
                    trace_capacity=cap, state=state, start_round=0,
                    knobs=knobs)
            else:
                lowered = jswim.run.lower(jax.random.key(0), params, world,
                                          rounds, state=state, start_round=0,
                                          knobs=knobs)
            delayed = params.mean_delay_ms != 0
            compiling[name] = pool.submit(
                lowered.compile, compiler_options=None if delayed else QUICK)
        # The draw programs compile beside them (a first call compiles).
        warm = [pool.submit(lambda n=name: _draws(n)(0)) for name in NAMES]
        for job in warm:
            job.result()
        return {name: job.result() for name, job in compiling.items()}


def _reference(name, knobs=None, world=None, state=None):
    """The reference's run of ``name`` (with ``knobs``, default
    ``Knobs.from_params``; ``world`` and ``state`` default to its
    own)."""
    kind, params, own_world, rounds, cap, own_state, default = _args(name)
    return _programs()[name](
        jax.random.key(0), own_world if world is None else world,
        state=own_state if state is None else state, start_round=0,
        knobs=default if knobs is None else knobs)




def _tel_arrays(jtel):
    return dict(lanes=np.asarray(jtel.trace.lanes),
                count=np.asarray(jtel.trace.count),
                dropped=np.asarray(jtel.trace.dropped),
                first_suspect=np.asarray(jtel.first_suspect),
                first_removed=np.asarray(jtel.first_removed))


def assert_telemetry_equal(jtel, tel):
    for name, want in _tel_arrays(jtel).items():
        got = interop.telemetry_to_arrays(tel)[name]
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@functools.lru_cache(maxsize=None)
def _traced_both(name):
    """One traced run on both sides, compared; returns the reference's
    ``(params, world, state, telemetry)`` and the port's."""
    _, jparams, jworld, rounds, cap, _, _ = _args(name)
    jstate, jtel, jmetrics = _reference(name)
    params, world = port_params(jparams), port_world(jworld)
    state, tel, metrics = swim.run_traced(
        0, params, world, rounds, trace_capacity=cap, draws=_draws(name),
        device="cpu")
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, metrics)
    assert_telemetry_equal(jtel, tel)
    return (jparams, jworld, jstate, jtel), (params, world, state, tel)


def _types(tel):
    return {e.event_type for e in trace.decode_events(tel)}


# --------------------------------------------------------------------------
# run_traced against the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(TRACED))
def test_run_traced_matches_reference(name):
    """Every lane of the trace, count, dropped, both first-round
    matrices, the state and the metrics equal the reference's; the run
    reaches the events its scenario was built for."""
    _, (params, _, _, tel) = _traced_both(f"traced:{name}")
    types = _types(tel)
    E = events.TraceEventType
    assert E.SUSPECTED in types
    if "overflow" in name:
        assert int(tel.trace.count) == SMALL_CAPACITY
        assert int(tel.trace.dropped) > 0
        return
    assert int(tel.trace.dropped) == 0
    assert {E.REMOVED, E.ALIVE_REFUTED, E.LEAVING} <= types
    leaving = [e for e in trace.decode_events(tel)
               if e.event_type == E.LEAVING]
    assert [(e.observer, e.subject, e.incarnation) for e in leaving] == [
        (LEAVER, LEAVER, 1)]
    if params.open_world:
        joined = {(e.observer, e.subject) for e in trace.decode_events(tel)
                  if e.event_type == E.JOINED}
        assert joined and all(s == CRASH for _, s in joined)
        assert any(e.event_type == E.ADDED and e.observer == CRASH
                   for e in trace.decode_events(tel))


def test_resume_across_chunks_and_from_a_reference_trace():
    """Two chunks through ``telemetry=`` equal the whole run; a fresh
    buffer through ``TelemetryState.resume`` holds exactly the second
    chunk's events; a reference trace carried in through
    ``interop.telemetry_from_arrays`` resumes like the port's own, and
    the caller's telemetry is not modified."""
    name = "traced:shift-wide"
    (jparams, jworld, jstate, jtel), (params, world, state, tel) = \
        _traced_both(name)
    draws = _draws(name)
    st1, tel1, _ = swim.run_traced(0, params, world, SPLIT, draws=draws,
                                   device="cpu")
    before = interop.telemetry_to_arrays(tel1)
    st2, tel2, _ = swim.run_traced(0, params, world, ROUNDS - SPLIT,
                                   state=st1, start_round=SPLIT, draws=draws,
                                   telemetry=tel1, device="cpu")
    assert_state_equal(jstate, st2)
    assert_telemetry_equal(jtel, tel2)
    for key, value in interop.telemetry_to_arrays(tel1).items():
        np.testing.assert_array_equal(value, before[key], err_msg=key)
    fresh = trace.TelemetryState.resume(tel1.first_suspect,
                                        tel1.first_removed)
    _, tel3, _ = swim.run_traced(0, params, world, ROUNDS - SPLIT,
                                 state=st1, start_round=SPLIT, draws=draws,
                                 telemetry=fresh, device="cpu")
    want = [e for e in trace.decode_events(tel) if e.round >= SPLIT]
    assert want and trace.decode_events(tel3) == want
    assert torch.equal(tel3.first_suspect, tel.first_suspect)
    # A reference trace and state resumed by the port equal the port's
    # own resume from its (equal) run.
    ref_tel = interop.telemetry_from_arrays(_tel_arrays(jtel), device="cpu")
    ref_state = interop.state_from_arrays(
        {f.name: np.asarray(getattr(jstate, f.name))
         for f in dataclasses.fields(jstate)}, device="cpu", params=params)
    more = 8
    a = swim.run_traced(0, params, world, more, state=ref_state,
                        start_round=ROUNDS, draws=draws, telemetry=ref_tel,
                        device="cpu")
    b = swim.run_traced(0, params, world, more, state=state,
                        start_round=ROUNDS, draws=draws, telemetry=tel,
                        device="cpu")
    for f in dataclasses.fields(swim.SwimState):
        assert torch.equal(getattr(a[0], f.name), getattr(b[0], f.name))
    for key, value in interop.telemetry_to_arrays(a[1]).items():
        np.testing.assert_array_equal(
            value, interop.telemetry_to_arrays(b[1])[key], err_msg=key)
    assert int(a[1].trace.count) >= int(tel.trace.count)


def test_histograms_and_decoded_events_match_reference():
    """``latency_histograms`` (per subject, both kinds, undetected) and
    ``decode_events`` equal the reference's on the traced runs, and
    ``histograms_to_json`` gives its plain lists."""
    for name in ("traced:shift-wide", "traced:shift-compact-join"):
        (_, jworld, _, jtel), (_, world, _, tel) = _traced_both(name)
        want = jtrace.latency_histograms(jtel, jworld)
        got = trace.latency_histograms(tel, world)
        assert set(got) == set(want)
        for key, value in want.items():
            assert got[key].dtype == torch.int32, key
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(value), err_msg=key)
        assert trace.histograms_to_json(got) == \
            jtrace.histograms_to_json(want)
        assert trace.decode_events(tel) == [
            events.MembershipTraceEvent(
                e.round, e.observer, e.subject,
                events.TraceEventType(int(e.event_type)), e.incarnation)
            for e in jtrace.decode_events(jtel)]
        assert int(got["detection"][CRASH].sum()) > 0


def test_histograms_empty_window_and_open_last_bucket():
    """The reference's edge cases (tests/test_telemetry_trace.py:369-410):
    a state that observed nothing counts every live observer undetected;
    latencies past the last edge land in the open last bucket."""
    jparams = _params(delivery="shift")
    jworld = jswim.SwimWorld.healthy(jparams).with_crash(CRASH, 10)
    world = port_world(jworld)
    jtel = jtrace.TelemetryState.init(N, N)
    tel = trace.TelemetryState.init(N, N, device="cpu")
    beyond = 10 + jtrace.DEFAULT_LATENCY_EDGES[-1] + 123
    late = np.full((N, N), jtrace.INT32_MAX, np.int32)
    late[:, CRASH] = beyond
    cases = [(jtel, tel),
             (jtrace.TelemetryState(trace=jtel.trace,
                                    first_suspect=jnp.asarray(late),
                                    first_removed=jtel.first_removed),
              trace.TelemetryState(trace=tel.trace,
                                   first_suspect=torch.from_numpy(late),
                                   first_removed=tel.first_removed))]
    for j, p in cases:
        want = jtrace.latency_histograms(j, jworld)
        got = trace.latency_histograms(p, world)
        for key, value in want.items():
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(value), err_msg=key)
    det = got["detection"][CRASH]
    assert int(det[-1]) == N - 1 and int(det[:-1].sum()) == 0


# --------------------------------------------------------------------------
# The segmented runner and the composed runner
# --------------------------------------------------------------------------


@pytest.mark.parametrize("capacity", [jtrace.DEFAULT_CAPACITY, 6])
def test_stream_traced_run_matches_monolithic(capacity):
    """Segments of 10 rounds give the monolithic run's final state,
    metrics and first-round matrices; with room, its exact event stream;
    with 6 rows a segment, each segment's recorded + dropped equals its
    events in the whole run."""
    _, (params, world, state, tel) = _traced_both("traced:shift-wide")
    draws = _draws("traced:shift-wide")
    final, res = sink.stream_traced_run(
        0, params, world, ROUNDS, segment_rounds=10, trace_capacity=capacity,
        draws=draws, device="cpu")
    for f in dataclasses.fields(swim.SwimState):
        assert torch.equal(getattr(final, f.name), getattr(state, f.name))
    _, _, metrics = swim.run_traced(0, params, world, ROUNDS, draws=draws,
                                    device="cpu")
    assert set(res.metrics) == set(metrics)
    for key, value in metrics.items():
        np.testing.assert_array_equal(res.metrics[key], value.numpy())
    assert torch.equal(res.telemetry.first_suspect, tel.first_suspect)
    assert torch.equal(res.telemetry.first_removed, tel.first_removed)
    assert (res.n_segments, res.segment_rounds, res.capacity) == (
        4, 10, capacity)
    whole = trace.decode_events(tel)
    if capacity == jtrace.DEFAULT_CAPACITY:
        assert res.events == whole
        assert (res.recorded, res.dropped) == (len(whole), 0)
    else:
        assert res.dropped > 0 and res.recorded + res.dropped == len(whole)
        per_segment = [sum(1 for e in whole if s <= e.round < s + 10)
                       for s in range(0, ROUNDS, 10)]
        assert res.recorded == sum(min(c, 6) for c in per_segment)
    _, quiet = sink.stream_traced_run(
        0, params, world, 4, segment_rounds=4, draws=draws, decode=False,
        device="cpu")
    assert quiet.events == [] and quiet.n_segments == 1


def test_run_composed_trace_only_equals_run_traced():
    """``run_composed`` with the trace alone is ``run_traced``; the
    reference's default stack without a monitor spec raises its
    ``ValueError``, and so does the provenance plane without its knob;
    with the knob on it runs beside the trace, which stays
    ``run_traced``'s."""
    _, (params, world, state, tel) = _traced_both("traced:shift-wide")
    draws = _draws("traced:shift-wide")
    final, results, _ = compose.run_composed(
        0, params, world, ROUNDS, with_metrics=False, with_monitor=False,
        draws=draws, device="cpu")
    assert set(results) == {"trace"}
    assert torch.equal(final.status, state.status)
    assert trace.decode_events(results["trace"]) == trace.decode_events(tel)
    with pytest.raises(ValueError, match="monitor_spec"):
        compose.run_composed(0, params, world, 2, device="cpu")
    with pytest.raises(ValueError, match="provenance=True"):
        compose.run_composed(0, params, world, 2, with_metrics=False,
                             with_monitor=False, with_provenance=True,
                             device="cpu")
    armed, results, _ = compose.run_composed(
        0, dataclasses.replace(params, provenance=True), world, ROUNDS,
        with_metrics=False, with_monitor=False, with_provenance=True,
        draws=draws, device="cpu")
    assert list(results) == ["trace", "provenance"]
    assert torch.equal(armed.status, state.status)
    assert trace.decode_events(results["trace"]) == trace.decode_events(tel)
    assert int(results["provenance"].count) > 0
    none = compose.build_stack(False, False, False)
    assert none == ()


def test_round_ctx_memoises_shared_derivations():
    """Repeated reads of a ``RoundCtx`` property return the same tensor,
    and the wide deadline comes from the paid decode (after
    tests/test_compose.py:250), here under the compact carry."""
    params = port_params(_params(delivery="shift", compact_carry=True))
    world = swim.SwimWorld.healthy(params, device="cpu").with_crash(CRASH, 0)
    state = swim.initial_state(params, world, device="cpu")
    new, m = swim.swim_tick(state, 0, params, world,
                            swim.prng.TorchDraws(0, "cpu", params, world)(0))
    rc = compose.RoundCtx(params, world, swim.Knobs.from_params(params), 0,
                          state, new, m)
    for prop in ("alive_now", "status_changed", "any_status_change",
                 "prev_wide", "new_wide", "prev_deadline_wide"):
        assert getattr(rc, prop) is getattr(rc, prop), prop
    assert rc.prev_wide.inc.dtype == torch.int32
    assert torch.equal(rc.prev_deadline_wide, rc.prev_wide.suspect_deadline)
    fc = compose.FinalCtx(params, world, rc.kn, 1, new,
                          {k: v[None] for k, v in m.items()})
    assert fc.alive_here is fc.alive_here
    assert torch.equal(fc.spread_until_wide,
                       swim._wide_timer_fields(new, params, 1)[1])


def test_plane_registry_names_real_knobs_and_lanes():
    """Every plane's knobs are ``SwimParams`` fields and its lanes
    ``SwimState`` fields (after tests/test_compose.py:232), and the
    registry lists the reference's planes in its order."""
    fields = {f.name for f in dataclasses.fields(swim.SwimParams)}
    lanes = {f.name for f in dataclasses.fields(swim.SwimState)}
    reg = compose.plane_registry()
    for plane in reg:
        assert plane["kind"] in ("core", "in-tick", "observer")
        assert set(plane["knobs"]) <= fields, plane["name"]
        assert set(plane["lanes"]) <= lanes, plane["name"]
    assert [(p["name"], p["kind"], tuple(p["knobs"]), tuple(p["lanes"]))
            for p in reg] == [
        (p["name"], p["kind"], tuple(p["knobs"]), tuple(p["lanes"]))
        for p in jcompose.plane_registry()]


def test_new_entry_points_default_to_cuda():
    import inspect

    for fn in (swim.run_traced, compose.composed_scan, compose.run_composed,
               sink.stream_traced_run, fd.run, trace.TelemetryState.init,
               trace.EventTrace.empty, interop.telemetry_from_arrays):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trace.TelemetryState.init(4, 4)


# --------------------------------------------------------------------------
# Knobs
# --------------------------------------------------------------------------

BAD_KNOBS = [dict(fanout=99), dict(loss_probability=1.5),
             dict(ping_every=-1), dict(sync_every=-2),
             dict(dead_suppress_rounds=9), dict(lhm_max=0),
             dict(lhm_max=9), dict(ping_timeout_ms=200.5),
             dict(ping_timeout_ms=-0.1), dict(fanoot=2)]


def test_knobs_for_params_raises_and_coerces_as_reference():
    """Unknown names and values past a ceiling raise the reference's
    ``ValueError`` messages (after tests/test_tune.py:212); accepted
    overrides take its float32 / int32 values; an override equal to the
    params value is no override; the three newer knobs default to None
    and then read the params."""
    jparams = _params(delivery="shift", dead_suppress_rounds=8, lhm_max=4)
    params = port_params(jparams)
    for bad in BAD_KNOBS:
        with pytest.raises(ValueError) as want:
            jswim.Knobs.for_params(jparams, **bad)
        with pytest.raises(ValueError) as got:
            swim.Knobs.for_params(params, **bad)
        assert str(got.value) == str(want.value)
    over = dict(loss_probability=0.1, ping_timeout_ms=33.3,
                suspicion_rounds=40_000, fanout=2, lhm_max=2,
                dead_suppress_rounds=3, ping_every=5, sync_every=0)
    want = jswim.Knobs.for_params(jparams, **over)
    got = swim.Knobs.for_params(params, **over)
    for f in dataclasses.fields(want):
        w = np.asarray(getattr(want, f.name))
        assert getattr(got, f.name) == w.item(), f.name
        assert isinstance(getattr(got, f.name),
                          float if w.dtype == np.float32 else int)
    assert got.loss_probability != 0.1          # float32(0.1)
    same = {name: getattr(jparams, name)
            for name in ("loss_probability", "ping_timeout_ms", "fanout")}
    assert swim.Knobs.for_params(params, **same) == \
        swim.Knobs.from_params(params)
    five = swim.Knobs(0.05, 30, 2, 10, 3)
    assert five.lhm_max is None
    assert swim.knob_lhm_cap(five, params) == 4
    assert swim.knob_dead_suppress(five, params) == 8
    assert swim.knob_probe_budgets(five, params) == (100.0, 100.0)


def test_knob_runs_match_reference():
    """``run(knobs=...)`` equals the reference's with the same knobs:
    float32-inexact ``loss_probability`` and ``ping_timeout_ms`` through
    a delayed run with Lifeguard on (the chain budgets compare summed
    delays), and a ``suspicion_rounds`` past 32,765 under the compact
    carry (stored as no timer, so nothing turns DEAD)."""
    cases = (("traced:scatter-int16_wire-delayed",
              dict(loss_probability=0.1, ping_timeout_ms=133.3)),
             ("traced:shift-compact-join", dict(suspicion_rounds=40_000)))
    for name, over in cases:
        _, jparams, jworld, rounds, _, _, _ = _args(name)
        jstate, _, jmetrics = _reference(
            name, jswim.Knobs.for_params(jparams, **over))
        params = port_params(jparams)
        state, metrics = swim.run(
            0, params, port_world(jworld), rounds, draws=_draws(name),
            knobs=swim.Knobs.for_params(params, **over), device="cpu")
        assert_state_equal(jstate, state)
        assert_metrics_equal(jmetrics, metrics)
        if "suspicion_rounds" in over:
            assert int(metrics["suspect"].sum()) > 0
            assert int(metrics["dead"][:, CRASH].sum()) == 0


def test_fd_run_matches_reference():
    """``fd.run`` (gossip and SYNC silenced) equals the reference's on
    tests/test_fd_model.py's crash scenario (scatter, shortened) and its
    planted suspicion (no leak to another observer)."""
    jparams, jworld = _fd_crash()
    jstate, jmetrics = _reference("fd:", jfd.fd_only_knobs(jparams))
    state, metrics = fd.run(0, port_params(jparams), port_world(jworld),
                            FD_ROUNDS, draws=_draws("fd:"), device="cpu")
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, metrics)
    assert int(metrics["suspect"][:, 0].max()) > 0
    assert int(metrics["messages_gossip"].sum()) == 0
    assert fd.fd_only_knobs(port_params(jparams)) == dataclasses.replace(
        swim.Knobs.from_params(port_params(jparams)), sync_every=0,
        fanout=0)

    jparams, jworld, jplanted, jknobs = _fd_planted()
    planted = interop.state_from_arrays(
        {f.name: np.asarray(getattr(jplanted, f.name))
         for f in dataclasses.fields(jplanted)}, device="cpu")
    jstate, jmetrics = _reference("fd:", jknobs, world=jworld,
                                  state=jplanted)
    params = port_params(jparams)
    knobs = dataclasses.replace(fd.fd_only_knobs(params), ping_every=0,
                                suspicion_rounds=2**30)
    state, metrics = swim.run(0, params, port_world(jworld), FD_ROUNDS,
                              state=planted, draws=_draws("fd:"),
                              knobs=knobs, device="cpu")
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, metrics)
    assert int(metrics["suspect"][:, 0].max()) == 1


# --------------------------------------------------------------------------
# Function to function
# --------------------------------------------------------------------------


def test_derive_event_codes_matches_reference():
    """Seeded (prev, new) status, incarnation and epoch planes, self
    cells and leaves: the codes and incarnations equal the reference's,
    with and without the epoch lane."""
    rng = np.random.default_rng(11)
    n, k = 40, 24
    prev = rng.integers(0, 4, (n, k)).astype(np.int8)
    new = rng.integers(0, 4, (n, k)).astype(np.int8)
    new_inc = rng.integers(0, 9, (n, k)).astype(np.int32)
    prev_ep = rng.integers(0, 3, (n, k)).astype(np.int16)
    new_ep = (prev_ep + rng.integers(0, 2, (n, k))).astype(np.int16)
    is_self = np.zeros((n, k), bool)
    is_self[np.arange(k), np.arange(k)] = True
    leaving = is_self & (rng.random((n, 1)) < 0.3)
    self_inc = rng.integers(0, 5, n).astype(np.int32)
    for epochs in (False, True):
        ep = (prev_ep, new_ep) if epochs else (None, None)
        want = jtrace.derive_event_codes(
            prev, None, new, new_inc, is_self, leaving, self_inc,
            *(None if e is None else jnp.asarray(e) for e in ep))
        got = trace.derive_event_codes(
            torch.from_numpy(prev), None, torch.from_numpy(new),
            torch.from_numpy(new_inc), torch.from_numpy(is_self),
            torch.from_numpy(leaving), torch.from_numpy(self_inc),
            *(None if e is None else torch.from_numpy(e) for e in ep))
        for g, w in zip(got, want):
            assert g.dtype == getattr(torch, str(np.asarray(w).dtype))
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert set(np.unique(got[0].numpy())) == (
            set(range(7)) if epochs else set(range(6)))


def _code_planes(rng, r, n, k, density):
    codes = np.where(rng.random((r, n, k)) < density,
                     rng.integers(1, 7, (r, n, k)), 0).astype(np.int8)
    incs = rng.integers(0, 1000, (r, n, k)).astype(np.int32)
    return codes, incs


RECORD_CASES = ("dense", "sparse", "overflow_partway", "one_below_capacity",
                "at_capacity", "silent")


@pytest.mark.parametrize("case", RECORD_CASES)
def test_record_plain_version_matches_reference_batch(case):
    """``kernels/trace.trace_record``'s plain version, round by round,
    against the reference's ``record_events_batch`` over three rounds of
    seeded code planes: lanes, count and dropped exact, the observer
    offset applied."""
    rng = np.random.default_rng(RECORD_CASES.index(case))
    n, k, cap = 30, 7, 64
    density, start = dict(dense=(0.9, 0), sparse=(0.02, 0),
                          overflow_partway=(0.15, 20),
                          one_below_capacity=(0.05, cap - 1),
                          at_capacity=(0.05, cap), silent=(0.0, 5))[case]
    codes, incs = _code_planes(rng, 3, n, k, density)
    subjects = rng.permutation(200)[:k].astype(np.int32)
    rounds = np.array([7, 8, 11], np.int32)
    lanes0 = np.full((cap, 5), -1, np.int32)
    lanes0[:start] = rng.integers(0, 50, (start, 5))
    jt = jtrace.EventTrace(lanes=jnp.asarray(lanes0), count=jnp.int32(start),
                           dropped=jnp.int32(2))
    want = jtrace.record_events_batch(jt, jnp.asarray(rounds),
                                      jnp.asarray(codes), jnp.asarray(incs),
                                      jnp.asarray(subjects),
                                      observer_offset=100)
    pt = trace.EventTrace(lanes=torch.from_numpy(lanes0.copy()),
                          count=torch.tensor(start, dtype=torch.int32),
                          dropped=torch.tensor(2, dtype=torch.int32))
    got = trace.record_events_batch(pt, rounds, torch.from_numpy(codes),
                                    torch.from_numpy(incs),
                                    torch.from_numpy(subjects),
                                    observer_offset=100)
    np.testing.assert_array_equal(got.lanes.numpy(), np.asarray(want.lanes))
    assert int(got.count) == int(want.count)
    assert int(got.dropped) == int(want.dropped)
    total = int((codes > 0).sum())
    assert int(got.count) == min(start + total, cap)
    assert int(got.dropped) == 2 + start + total - int(got.count)
    with pytest.raises(TypeError, match="codes"):
        trace_kernel.trace_record(
            got.lanes, got.count, got.dropped,
            torch.from_numpy(codes[0]).to(torch.int32),
            torch.from_numpy(incs[0]), torch.from_numpy(subjects), 0)


# The observe cases: (inc dtype, epoch dtype or None, observer offset,
# density of changed cells, rows already recorded).
OBS_N, OBS_K, OBS_CAP, OBS_ROUNDS = 30, 7, 128, (7, 8, 11)
OBS_MAX_OFFSET = 100
OBSERVE_CASES = {
    "wide": (np.int32, None, 0, 0.1, 0),
    "wide_int32_epoch": (np.int32, np.int32, 0, 0.1, 0),
    "compact_int16_inc_int16_epoch": (np.int16, np.int16, 0, 0.1, 0),
    "leave_rows_observer_offset": (np.int32, None, OBS_MAX_OFFSET, 0.1, 0),
    "overflow_partway": (np.int32, None, 0, 0.5, 100),
    "at_capacity": (np.int32, np.int32, 0, 0.1, OBS_CAP),
    "silent": (np.int32, None, 0, 0.0, 5),
}


@functools.lru_cache(maxsize=None)
def _observe_program(inc_dtype, epoch_dtype):
    """The reference's traced round, three rounds of it: per round
    ``round_transition_codes`` then ``update_first_rounds``, then one
    ``record_events_batch`` of the three, as one program a dtype pair
    (compiled once at XLA's reduced optimizations, shared by the cases)."""
    epochs = epoch_dtype is not None

    def run(lanes, count, dropped, first_suspect, first_removed, status,
            inc, epoch, self_inc, leave_at, subject_ids, offset):
        tel = jtrace.TelemetryState(
            trace=jtrace.EventTrace(lanes=lanes, count=count,
                                    dropped=dropped),
            first_suspect=first_suspect, first_removed=first_removed)
        world = types.SimpleNamespace(leave_at=leave_at,
                                      subject_ids=subject_ids)
        codes, incs = [], []
        for r, round_idx in enumerate(OBS_ROUNDS):
            new = types.SimpleNamespace(
                status=status[r + 1], inc=inc[r], self_inc=self_inc[r],
                epoch=epoch[r + 1] if epochs else None)
            c, i = jtrace.round_transition_codes(
                round_idx, status[r], None, new, world, offset,
                prev_epoch=epoch[r] if epochs else None)
            tel = jtrace.update_first_rounds(tel, c, round_idx)
            codes.append(c)
            incs.append(i)
        trace_out = jtrace.record_events_batch(
            tel.trace, jnp.asarray(OBS_ROUNDS, jnp.int32), jnp.stack(codes),
            jnp.stack(incs), subject_ids, offset)
        return (trace_out.lanes, trace_out.count, trace_out.dropped,
                tel.first_suspect, tel.first_removed)

    sample = _observe_inputs("wide", inc_dtype, epoch_dtype, 0)
    return jax.jit(run).lower(*sample, jnp.int32(0)).compile(
        compiler_options=QUICK)


def _observe_inputs(case, inc_dtype, epoch_dtype, offset):
    """Seeded planes of three traced rounds at N = 30, K = 7: statuses
    [4, N, K] int8 (each round changes a ``density`` share of cells, self
    cells included), new incarnations [3, N, K], epochs [4, N, K] (each
    round advances one in twenty), self incarnations [3, N] (one at
    INT32_MAX, which wraps), leave_at over the world's first 100 + N
    rows (two subjects' self rows leave in rounds 8 and 11, one other
    row in round 7), subjects at distinct rows of the observer range,
    and a buffer with ``start`` rows recorded and 2 drops."""
    _, _, _, density, start = OBSERVE_CASES[case]
    rng = np.random.default_rng(sorted(OBSERVE_CASES).index(case))
    n, k, r = OBS_N, OBS_K, len(OBS_ROUNDS)
    status = [rng.integers(0, 4, (n, k))]
    for _ in range(r):
        change = rng.random((n, k)) < density
        status.append(np.where(change, rng.integers(0, 4, (n, k)),
                               status[-1]))
    status = np.stack(status).astype(np.int8)
    hi = 2**15 if inc_dtype == np.int16 else 2**30
    inc = rng.integers(-hi, hi, (r, n, k)).astype(inc_dtype)
    epoch = [rng.integers(0, 50, (n, k))]
    for _ in range(r):
        epoch.append(epoch[-1] + (rng.random((n, k)) < 0.05))
    epoch = np.stack(epoch).astype(epoch_dtype or np.int32)
    self_inc = rng.integers(0, 1000, (r, n)).astype(np.int32)
    rows = rng.permutation(n)[:k]
    self_inc[:, rows[0]] = 2**31 - 1
    subject_ids = (rows + offset).astype(np.int32)
    leave_at = np.full(OBS_MAX_OFFSET + n, 2**31 - 1, np.int32)
    if density:
        leave_at[offset + rows[0]] = OBS_ROUNDS[1]
        leave_at[offset + rows[1]] = OBS_ROUNDS[2]
        leave_at[offset + np.setdiff1d(np.arange(n), rows)[0]] = OBS_ROUNDS[0]
    lanes = np.full((OBS_CAP, 5), -1, np.int32)
    lanes[:start] = rng.integers(0, 50, (start, 5))
    first = [np.where(rng.random((n, k)) < 0.5, 2**31 - 1,
                      rng.integers(0, 7, (n, k))).astype(np.int32)
             for _ in range(2)]
    return (lanes, np.int32(start), np.int32(2), first[0], first[1], status,
            inc, epoch, self_inc, leave_at, subject_ids)


@pytest.mark.parametrize("case", sorted(OBSERVE_CASES))
def test_observe_plain_version_matches_reference(case):
    """``kernels/trace.trace_observe_reference`` round by round (the
    fused observe's plain version: the derivation, the first-round
    stamps, the record) against the reference's
    ``round_transition_codes`` -> ``update_first_rounds`` ->
    ``record_events_batch`` over three rounds: lanes, count, dropped and
    both first-round matrices exact, each case reaching its edge."""
    inc_dtype, epoch_dtype, offset, density, start = OBSERVE_CASES[case]
    args = _observe_inputs(case, inc_dtype, epoch_dtype, offset)
    want = _observe_program(inc_dtype, epoch_dtype)(
        *map(jnp.asarray, args), jnp.int32(offset))
    (lanes, count, dropped, fs, fr, status, inc, epoch, self_inc, leave_at,
     subject_ids) = (torch.from_numpy(np.array(a)) for a in args)
    got = dict(lanes=lanes, count=count, dropped=dropped, first_suspect=fs,
               first_removed=fr)
    for r, round_idx in enumerate(OBS_ROUNDS):
        trace_kernel.trace_observe_reference(
            **got, prev_status=status[r], new_status=status[r + 1],
            new_inc=inc[r], self_inc=self_inc[r],
            leave_at=leave_at[offset:offset + OBS_N], subject_ids=subject_ids,
            round_idx=round_idx, observer_offset=offset,
            prev_epoch=epoch[r] if epoch_dtype else None,
            new_epoch=epoch[r + 1] if epoch_dtype else None)
    for name, w in zip(("lanes", "count", "dropped", "first_suspect",
                        "first_removed"), want):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(w),
                                      err_msg=name)
    rows = got["lanes"][start:int(got["count"])].numpy()
    kinds = set(rows[:, 3].tolist())
    E = events.TraceEventType
    recorded = int(got["count"]) + int(got["dropped"]) - start - 2
    if case == "silent":
        assert recorded == 0
        np.testing.assert_array_equal(got["first_suspect"].numpy(), args[3])
    elif case == "at_capacity":
        assert int(got["count"]) == OBS_CAP and recorded > 0
    elif case == "overflow_partway":
        assert int(got["count"]) == OBS_CAP and start + recorded > OBS_CAP
    else:
        assert int(got["dropped"]) == 2 and {E.SUSPECTED, E.LEAVING} <= kinds
        leaving = rows[rows[:, 3] == E.LEAVING]
        assert (leaving[:, 1] == leaving[:, 2]).all()
        assert -2**31 in leaving[:, 4].tolist()
        assert (rows[:, 1] != rows[:, 2]).sum() == len(rows) - len(leaving)
        if epoch_dtype is not None:
            assert E.JOINED in kinds
    if case == "wide":
        # The wrapper takes the plain version on CPU tensors.
        _, _, _, fs0, fr0, *_ = args
        via = dict(lanes=torch.from_numpy(args[0].copy()),
                   count=torch.tensor(start, dtype=torch.int32),
                   dropped=torch.tensor(2, dtype=torch.int32),
                   first_suspect=torch.from_numpy(fs0.copy()),
                   first_removed=torch.from_numpy(fr0.copy()))
        for r, round_idx in enumerate(OBS_ROUNDS):
            trace_kernel.trace_observe(
                **via, prev_status=status[r], new_status=status[r + 1],
                new_inc=inc[r], self_inc=self_inc[r],
                leave_at=leave_at[:OBS_N], subject_ids=subject_ids,
                round_idx=round_idx)
        for name, value in via.items():
            assert torch.equal(value, got[name]), name
