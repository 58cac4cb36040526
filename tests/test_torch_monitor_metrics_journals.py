"""The port's health-metrics registry ops and journals against the JAX
package: the registry ops on seeded inputs, ``build_stack`` raising only
for provenance, a port journal read by the reference's ``read_records``
and ``query.load_report``, a reference journal read by the port's, and
``stream_metered_run``'s resume dedup against the reference's window
rows.  The settings and the reference's programs are
``tests/test_torch_monitor_metrics.py``'s.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from scalecube_cluster_tpu.chaos import monitor as jmonitor  # noqa: E402
from scalecube_cluster_tpu.models import compose as jcompose  # noqa: E402
from scalecube_cluster_tpu.telemetry import alarms as jalarms  # noqa: E402
from scalecube_cluster_tpu.telemetry import metrics as jmetrics  # noqa: E402
from scalecube_cluster_tpu.telemetry import query as jquery  # noqa: E402
from scalecube_cluster_tpu.telemetry import sink as jsink  # noqa: E402
from scalecube_cluster_tpu_torch.chaos import monitor  # noqa: E402
from scalecube_cluster_tpu_torch.models import compose  # noqa: E402
from scalecube_cluster_tpu_torch.telemetry import alarms  # noqa: E402
from scalecube_cluster_tpu_torch.telemetry import metrics, sink  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    assert_registry_equal, one_torch_thread, port_params, port_world)
from tests.test_torch_monitor_metrics import (  # noqa: E402,F401
    CHUNK, CRASH, METERED, MONITORED, ROUNDS, SPEC, _composed_both, _draws,
    _metered_both, _params, _strip, _world, jtrace_event, ms_spec)

pytestmark = pytest.mark.torchport


def test_registry_ops_match_reference():
    """``inc``, ``inc_many``, ``set_gauge``, ``observe`` (seeded values,
    a broadcast mask, values below the first edge and past the last, an
    empty mask) and ``reset_window`` give the reference's registry."""
    rng = np.random.default_rng(7)
    values = rng.integers(-5, 300, (6, 5)).astype(np.int32)
    mask = rng.random((6, 5)) < 0.5
    jms = jmetrics.MetricsState.init(SPEC)
    ms = metrics.MetricsState.init(metrics.MetricsSpec.default(), "cpu")
    steps = [
        ("inc", "refutations", 7), ("inc", "gossip_messages", 2**31 - 3),
        ("inc", "gossip_messages", 9),
        ("inc_many", {"fd_probes_sent": 3, "suspicions_fired": 11}),
        ("gauge", "lhm", 1.2345678), ("gauge", "live_members", 15),
        ("observe", values, mask), ("observe", values[:, :1], mask[0]),
        ("observe", values, np.zeros_like(mask)),
    ]
    for step in steps:
        if step[0] == "inc":
            jms = jmetrics.inc(jms, SPEC, step[1], step[2])
            ms = metrics.inc(ms, ms_spec(), step[1],
                             torch.tensor(step[2], dtype=torch.int64))
        elif step[0] == "inc_many":
            jms = jmetrics.inc_many(jms, SPEC, step[1])
            ms = metrics.inc_many(ms, ms_spec(), step[1])
        elif step[0] == "gauge":
            jms = jmetrics.set_gauge(jms, SPEC, step[1], step[2])
            ms = metrics.set_gauge(ms, ms_spec(), step[1], step[2])
        else:
            jms = jmetrics.observe(jms, SPEC, "suspicion_lifetime_rounds",
                                   step[1], step[2])
            ms = metrics.observe(ms, ms_spec(), "suspicion_lifetime_rounds",
                                 torch.from_numpy(step[1]),
                                 torch.from_numpy(step[2]))
        assert_registry_equal(jms, ms)
    assert int(ms.counters[SPEC.counter_index("gossip_messages")]) < 0
    with pytest.warns(UserWarning, match="wrapped int32"):
        got = metrics.to_json(ms, ms_spec())
    with pytest.warns(UserWarning, match="wrapped int32"):
        assert got == jmetrics.to_json(jms, SPEC)
    assert_registry_equal(jmetrics.reset_window(jms),
                          metrics.reset_window(ms))
    with pytest.raises(NotImplementedError, match="multi-device"):
        metrics.aggregate_across_devices(ms, "rows")
    assert metrics.aggregate_across_devices(ms, None) is ms


def test_build_stack_raises_only_for_provenance():
    """Every plane builds, provenance too (the last to be ported), in the
    reference's order: trace, provenance, monitor, metrics; the monitor
    without a spec is the reference's ``ValueError``."""
    params = port_params(MONITORED)
    spec = monitor.MonitorSpec.passive(params, device="cpu")
    stack = compose.build_stack(True, True, True, monitor_spec=spec)
    assert [p.name for p in stack] == ["trace", "monitor", "metrics"]
    assert stack[2].chaos_from == "monitor"
    assert compose.build_stack(False, True, False)[0].chaos_from is None
    with pytest.raises(ValueError, match="monitor_spec"):
        compose.build_stack(False, False, True)
    (plane,) = compose.build_stack(False, False, False, with_provenance=True,
                                   provenance_capacity=64)
    assert (plane.name, plane.capacity) == ("provenance", 64)
    full = compose.build_stack(True, True, True, monitor_spec=spec,
                               with_provenance=True)
    jfull = jcompose.build_stack(
        True, True, True, monitor_spec=jmonitor.MonitorSpec.passive(MONITORED),
        with_provenance=True)
    assert [p.name for p in full] == [p.name for p in jfull] == [
        "trace", "provenance", "monitor", "metrics"]
    jstack = jcompose.build_stack(
        True, True, True, monitor_spec=jmonitor.MonitorSpec.passive(MONITORED))
    assert [p.name for p in jstack] == [p.name for p in stack]


def test_port_journal_reads_in_the_reference(tmp_path):
    """A journal the port writes (manifest, metrics windows, counters,
    histogram, curve, events, a record, summary) reads back through the
    reference's ``read_records`` and ``query.load_report`` as it reads
    through the port's, its window totals the registry's."""
    rows, state = _metered_both("shift-wide-sync")
    (_, jres, jm), (params, _, _, _, res, m) = _composed_both()
    path = tmp_path / "port.jsonl"
    with sink.TelemetrySink(path=str(path)) as s:
        s.write_manifest(params, label="port")
        for row in rows:
            s.write_metrics_window(row)
        s.write_counters(m, label="composed")
        s.write_histogram("lifetime", metrics.DEFAULT_SUSPICION_EDGES,
                          res["metrics"].hists["suspicion_lifetime_rounds"])
        s.write_curve("dead", m["dead"][:, CRASH])
        from scalecube_cluster_tpu_torch.telemetry import trace

        s.write_events(trace.decode_events(res["trace"]))
        s.write_record("chaos_scenario",
                       monitor.verdict(res["monitor"]))
        s.write_summary(rounds=ROUNDS)
    theirs = jsink.read_records(str(path))
    ours = sink.read_records(str(path))
    assert theirs == ours
    assert [r["kind"] for r in ours][:3] == ["manifest", "metrics_window",
                                            "metrics_window"]
    assert ours[1] == {"kind": "metrics_window", "run_id": "port", **rows[0]}
    assert sink.covered_upto(str(path), "metrics_window") == ROUNDS
    report = jquery.load_report(str(path))
    for name in SPEC.counters:
        assert report.counters[name] == sum(r["counters"][name]
                                            for r in rows)
    assert jsink.read_events(str(path)) == [
        jtrace_event(e) for e in sink.read_events(str(path))]
    jcounters = jsink.counters_row(jax.tree.map(np.asarray, jm),
                                   label="composed")
    assert ours[3] == {"kind": "counters", "run_id": "port", **jcounters}


def test_reference_journal_reads_in_the_port(tmp_path):
    """A journal the reference writes reads back through the port's
    readers record for record, a torn tail skipped by both, and the
    port's append-mode sink heals the tail as the reference's does."""
    rows, _ = _metered_both("shift-wide-sync")
    path = tmp_path / "ref.jsonl"
    with jsink.TelemetrySink(path=str(path)) as s:
        s.write_manifest(MONITORED)
        for row in rows:
            s.write_metrics_window(row)
        s.write_provenance({"rows": [{"a": 1}], "recorded": 1,
                            "dropped": 0, "capacity": 4})
    want = jsink.read_records(str(path))
    assert sink.read_records(str(path)) == want
    assert sink.read_provenance(str(path)) == jsink.read_provenance(
        str(path))
    with open(path, "a") as f:
        f.write('{"kind": "metrics_window", "round_')
    with pytest.warns(UserWarning, match="torn"):
        assert sink.read_records(str(path)) == want
    follower = sink.follow_records(str(path))
    assert follower.poll() == want
    assert follower.covered_upto("metrics_window") == ROUNDS
    with pytest.warns(UserWarning, match="torn"):
        sink.TelemetrySink(path=str(path), append=True).close()
    assert open(path).read().endswith("\n")
    assert sink.read_records(str(path)) == want


def test_stream_metered_run_dedups_a_resumed_journal(tmp_path):
    """``stream_metered_run``'s window rows are the reference's (two
    20-round windows, the registry reset between them); a longer
    relaunch into the same append-mode journal writes no covered window
    again and appends only the new one.  ``alarm_specs`` without a sink
    raises as in the reference; with one, the journaled transitions are
    the reference engine's over the reference's rows."""
    rows, state = _metered_both("shift-wide-sync")
    jparams = _params(**METERED["shift-wide-sync"])
    params, world = port_params(jparams), port_world(_world(jparams))
    path = str(tmp_path / "metered.jsonl")
    draws = _draws("shift-wide-sync")

    def stream(n_rounds):
        with sink.TelemetrySink(path=path, append=True) as s:
            return metrics.stream_metered_run(
                0, params, world, n_rounds, sink=s, window_rounds=CHUNK,
                draws=draws, device="cpu")

    final, got = stream(ROUNDS)
    assert got == rows
    assert json.loads(json.dumps(got)) == got
    assert torch.equal(final.status, state.status)
    _, longer = stream(ROUNDS + 4)
    assert longer[:2] == rows
    written = [_strip(r) for r in sink.read_records(path, "metrics_window")]
    assert written == [{"kind": "metrics_window", **r} for r in longer]
    with pytest.raises(ValueError, match="alarm_specs needs a sink"):
        jmetrics.stream_metered_run(jax.random.key(0), _params(
            **METERED["shift-wide-sync"]), None, 1, alarm_specs=[1])
    with pytest.raises(ValueError, match="alarm_specs needs a sink"):
        metrics.stream_metered_run(0, params, world, 1, alarm_specs=[1],
                                   device="cpu")
    # With a sink, the live alarms journal what the reference's engine
    # makes of the reference's window rows (a threshold every window with
    # a false onset crosses, cleared by the next quiet one).
    specs = [jalarms.AlarmSpec(name="onsets", numerator="suspicions_started",
                               comparator=">", threshold=0.0)]
    want, _ = jalarms.replay_journal(
        jalarms.AlarmEngine(specs, kinds=("metrics_window",)),
        [{"kind": "metrics_window", **r} for r in rows])
    apath = str(tmp_path / "alarms.jsonl")
    with sink.TelemetrySink(path=apath) as s:
        metrics.stream_metered_run(
            0, params, world, ROUNDS, sink=s, window_rounds=CHUNK,
            draws=draws, alarm_specs=[alarms.AlarmSpec(**vars(specs[0]))],
            device="cpu")
    assert [{k: v for k, v in r.items() if k not in ("kind", "run_id")}
            for r in sink.read_records(apath, "alarm_transition")] == want
    assert want
