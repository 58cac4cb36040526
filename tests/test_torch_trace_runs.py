"""The port's membership event trace against the JAX package, whole traced
runs: ``run_traced`` in the four layouts across both delivery modes (one
with delays and Lifeguard, one overflowing, one with a join), resumed
across chunks and from a reference trace, the latency histograms and
decoded events, and ``stream_traced_run`` against the monolithic run.
The runs and the reference's programs are ``tests/test_torch_trace.py``'s.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scalecube_cluster_tpu.telemetry import trace as jtrace  # noqa: E402
from scalecube_cluster_tpu_torch import interop  # noqa: E402
from scalecube_cluster_tpu_torch.models import swim  # noqa: E402
from scalecube_cluster_tpu_torch.telemetry import events, sink  # noqa: E402
from scalecube_cluster_tpu_torch.telemetry import trace  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    assert_state_equal, one_torch_thread)
from tests.test_torch_trace import (  # noqa: E402,F401
    CRASH, LEAVER, ROUNDS, SMALL_CAPACITY, SPLIT, TRACED, _draws, _tel_arrays,
    _traced_both, _types, assert_telemetry_equal)

pytestmark = pytest.mark.torchport


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
