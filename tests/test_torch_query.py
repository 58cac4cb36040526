"""The port's health queries (``telemetry/query.py``: ``load_report``,
``merge_reports``, ``compute_slos``, ``percentile_from_histogram``,
``dissemination_rounds_from_curve``, ``diff_reports``, ``format_table``)
against the JAX package's, on the committed ``artifacts/*.jsonl``
journals and on a journal the port writes from its own run (metrics
windows, latency histograms, the fraction-informed curve, the event
trace and a summary).  Every result equals the reference's exactly.
"""

import dataclasses
import functools
import glob
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scalecube_cluster_tpu.telemetry import query as jquery  # noqa: E402
from scalecube_cluster_tpu_torch.config import ClusterConfig  # noqa: E402
from scalecube_cluster_tpu_torch.models import swim  # noqa: E402
from scalecube_cluster_tpu_torch.telemetry import metrics, query  # noqa: E402
from scalecube_cluster_tpu_torch.telemetry import sink  # noqa: E402
from scalecube_cluster_tpu_torch.telemetry import trace as ttrace  # noqa: E402
from tests.torch_port_helpers import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torchport

JOURNALS = sorted(glob.glob("artifacts/*.jsonl"))
N, ROUNDS, CRASHED = 16, 60, 3


def _fields(report):
    return dataclasses.asdict(report)


@functools.lru_cache(maxsize=None)
def _port_journal(directory):
    """A journal the port writes: ``stream_metered_run`` in three 20-round
    windows, the traced run's latency histograms for node 3, its
    fraction-informed curve, its events and a summary."""
    cfg = ClusterConfig.default().replace(
        gossip_interval=100, ping_interval=200, ping_timeout=100,
        sync_interval=1_000, suspicion_mult=3)
    params = swim.SwimParams.from_config(cfg, N, delivery="shift",
                                         loss_probability=0.05)
    world = swim.SwimWorld.healthy(params, device="cpu").with_crash(
        CRASHED, at_round=5)
    path = f"{directory}/port.jsonl"
    with sink.TelemetrySink(path=path) as s:
        s.write_manifest(params, label="query parity")
        metrics.stream_metered_run(0, params, world, ROUNDS, sink=s,
                                   window_rounds=20, device="cpu")
        _, tel, m = swim.run_traced(0, params, world, ROUNDS,
                                    trace_capacity=4096, device="cpu")
        hist = ttrace.latency_histograms(tel, world)
        for name in ("detection", "removal"):
            s.write_histogram(f"{name}_latency_rounds", hist["edges"],
                              hist[name][CRASHED], subject=CRASHED)
        s.write_curve("fraction_informed", sink.fraction_informed_curve(
            m["dead"][:, CRASHED], N - 1), subject=CRASHED)
        s.write_events(ttrace.decode_events(tel.trace),
                       dropped=int(tel.trace.dropped))
        s.write_summary(events_recorded=int(tel.trace.count),
                        sync_rounds_to_converge=12)
    return path


@pytest.fixture(scope="module")
def port_journal(tmp_path_factory):
    return _port_journal(str(tmp_path_factory.mktemp("query")))


def test_reports_and_slos_of_committed_journals_match_reference():
    """``load_report`` and ``compute_slos`` of every committed journal,
    and ``merge_reports`` of all of them (and of each pair of drill
    arms), equal the reference's."""
    assert len(JOURNALS) >= 4
    got_reports = [query.load_report(p) for p in JOURNALS]
    want_reports = [jquery.load_report(p) for p in JOURNALS]
    for path, got, want in zip(JOURNALS, got_reports, want_reports):
        assert _fields(got) == _fields(want), path
        assert query.compute_slos(got) == jquery.compute_slos(want), path
        assert got.rounds_covered == want.rounds_covered
    merged = query.merge_reports(got_reports)
    assert _fields(merged) == _fields(jquery.merge_reports(want_reports))
    assert query.compute_slos(merged) == jquery.compute_slos(
        jquery.merge_reports(want_reports))


def test_port_journal_report_matches_reference(port_journal):
    """The port's journal: the reference's ``load_report`` and the port's
    give the same report and SLOs, with the latency percentiles, the
    dissemination rounds and the trace drop counter all present."""
    got, want = query.load_report(port_journal), jquery.load_report(
        port_journal)
    assert _fields(got) == _fields(want)
    slos = query.compute_slos(got)
    assert slos == jquery.compute_slos(want)
    for key in ("false_positive_observer_rate", "detection_latency_p50",
                "removal_latency_p99", "dissemination_rounds",
                "trace_dropped_total", "sync_rounds_to_converge"):
        assert slos[key] is not None, key
    assert got.rounds_covered == ROUNDS


def test_diff_and_format_table_match_reference(port_journal):
    """``diff_reports`` of the port's journal against each committed
    journal (and itself), and ``format_table`` of every result, equal
    the reference's text and rows."""
    mine = (query.load_report(port_journal), jquery.load_report(port_journal))
    for path in JOURNALS + [port_journal]:
        other = (query.load_report(path), jquery.load_report(path))
        for a, b in ((0, 1), (1, 0)):
            got = query.diff_reports((mine, other)[a][0], (mine, other)[b][0])
            want = jquery.diff_reports((mine, other)[a][1],
                                       (mine, other)[b][1])
            assert got == want, path
            headers = ["metric", "a", "b", "delta", "rel"]
            assert query.format_table(got, headers) == jquery.format_table(
                want, headers)
    rows = [{"metric": k, "value": v}
            for k, v in query.compute_slos(mine[0]).items()]
    assert query.format_table(rows, ["metric", "value"]) == \
        jquery.format_table(rows, ["metric", "value"])
    assert query.format_table([], ["a"]) == jquery.format_table([], ["a"])


def test_percentiles_and_dissemination_match_reference():
    """``percentile_from_histogram`` on seeded histograms (empty, one
    bucket, mass in the open tail, every quantile edge) and
    ``dissemination_rounds_from_curve`` on seeded curves (strided,
    offset, never reaching 1.0, empty) equal the reference's."""
    rng = np.random.default_rng(17)
    edges = [0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64]
    cases = [[0] * len(edges), [5] + [0] * (len(edges) - 1),
             [0] * (len(edges) - 1) + [9]]
    cases += [rng.integers(0, 20, len(edges)).tolist() for _ in range(20)]
    for counts in cases:
        for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
            got = query.percentile_from_histogram(edges, counts, q)
            want = jquery.percentile_from_histogram(edges, counts, q)
            assert got == want or (math.isnan(got) and math.isnan(want))
    for _ in range(20):
        values = np.minimum(np.cumsum(rng.random(40) * 0.08), 1.0).tolist()
        curve = {"values": values, "stride": int(rng.integers(1, 4)),
                 "round_offset": int(rng.integers(0, 100))}
        assert query.dissemination_rounds_from_curve(curve) == \
            jquery.dissemination_rounds_from_curve(curve)
    for curve in ({}, {"values": []}, {"values": [0.2, 0.5]}):
        assert query.dissemination_rounds_from_curve(curve) == \
            jquery.dissemination_rounds_from_curve(curve)
    for name in ("THROUGHPUT_METRIC", "DEFAULT_NOISE_BAND",
                 "DISSEMINATION_SLACK_ROUNDS", "PROVENANCE_OVERHEAD_LIMIT"):
        assert getattr(query, name) == getattr(jquery, name), name
