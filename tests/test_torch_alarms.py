"""The port's live alarm engine (``telemetry/alarms.py``) against the JAX
package's: seeded window-record streams through both engines, the
committed drill journals replayed, and the exactly-once journal dedup.
Everything here is exact: transitions, states and written records are
equal, with no tolerance.
"""

import collections

import numpy as np
import pytest

from scalecube_cluster_tpu.telemetry import alarms as jalarms
from scalecube_cluster_tpu.telemetry import sink as jsink
from scalecube_cluster_tpu_torch.telemetry import alarms, sink

pytestmark = pytest.mark.torchport

DRILL = {"breach": "artifacts/alarm_drill_breach.jsonl",
         "healthy": "artifacts/alarm_drill_healthy.jsonl"}


def _stream(seed, n_windows=60):
    """Seeded ``metrics_window`` / ``segment`` rows with bursts of false
    onsets, zero-denominator windows, absent lanes and foreign kinds."""
    rng = np.random.default_rng(seed)
    rows, r = [], 0
    for _ in range(n_windows):
        span = int(rng.integers(8, 40))
        kind = str(rng.choice(["metrics_window", "metrics_window",
                               "segment", "summary"]))
        live = int(rng.choice([0, span * 48, span * 48, span * 48]))
        burst = rng.random() < 0.35
        onsets = int(rng.integers(0, 3 * live + 1 if burst else 40))
        counters = {"false_suspicion_onsets": onsets,
                    "live_observer_rounds": live,
                    "refutations": int(rng.integers(0, 50))}
        if rng.random() < 0.1:
            del counters["false_suspicion_onsets"]
        rows.append({"kind": kind, "round_start": r, "round_end": r + span,
                     "counters": counters})
        r += span
    return rows


def _specs(pkg, for_windows, clear_windows):
    return (
        *pkg.default_specs(threshold=1.2, for_windows=for_windows,
                           clear_windows=clear_windows),
        pkg.AlarmSpec(name="refutation_rate", numerator="refutations",
                      denominator="rounds", comparator=">=", threshold=1.0,
                      window=3, for_windows=for_windows,
                      clear_windows=clear_windows),
        pkg.AlarmSpec(name="onsets_total", numerator="false_suspicion_onsets",
                      comparator=">", threshold=400.0, window=2,
                      for_windows=for_windows, clear_windows=clear_windows),
        pkg.AlarmSpec(name="quiet", numerator="false_suspicion_onsets",
                      denominator="live_observer_rounds", comparator="<",
                      threshold=0.05, for_windows=for_windows,
                      clear_windows=clear_windows),
    )


@pytest.mark.parametrize("for_windows,clear_windows", [(1, 1), (2, 2),
                                                       (1, 2), (2, 1)])
def test_engine_matches_reference_on_seeded_streams(for_windows,
                                                    clear_windows):
    """Seeded record streams through both engines, with the firing
    debounce and the resolve hysteresis at 1 and 2 windows: every
    transition, the state table and the windows seen are equal, and the
    stream reaches every transition kind."""
    seen = collections.Counter()
    for seed in range(6):
        rows = _stream(seed)
        want_engine = jalarms.AlarmEngine(_specs(jalarms, for_windows,
                                                 clear_windows))
        got_engine = alarms.AlarmEngine(_specs(alarms, for_windows,
                                               clear_windows))
        for rec in rows:
            want = want_engine.observe(rec)
            assert got_engine.observe(rec) == want
            seen.update(t["to"] for t in want)
        assert got_engine.state_rows() == want_engine.state_rows()
        assert got_engine.windows_seen == want_engine.windows_seen
    assert {"firing", "resolved"} <= set(seen)
    if for_windows > 1:
        assert {"pending", "ok"} <= set(seen)


def test_spec_validation_and_constants_match_reference():
    """The constants, the default registry and the validation errors are
    the reference's."""
    for name in ("WINDOW_KINDS", "TRANSITION_KIND", "OK", "PENDING",
                 "FIRING", "RESOLVED", "DEFAULT_FP_THRESHOLD"):
        assert getattr(alarms, name) == getattr(jalarms, name), name
    assert [vars(s) for s in alarms.default_specs()] == [
        vars(s) for s in jalarms.default_specs()]
    for kwargs in (dict(comparator="!="), dict(window=0),
                   dict(for_windows=0), dict(clear_windows=-1)):
        with pytest.raises(ValueError) as want:
            jalarms.AlarmSpec(name="a", numerator="x", **kwargs)
        with pytest.raises(ValueError) as got:
            alarms.AlarmSpec(name="a", numerator="x", **kwargs)
        assert str(got.value) == str(want.value)
    specs = alarms.default_specs() * 2
    with pytest.raises(ValueError, match="duplicate alarm names"):
        alarms.AlarmEngine(specs)


@pytest.mark.parametrize("arm", sorted(DRILL))
def test_committed_drill_journal_replays_to_its_transitions(arm):
    """The reference's committed ``bench.py --alarms`` journals, read by
    the port's ``read_records`` and replayed through the port's
    ``replay_journal`` at the drill's threshold: the reference replay's
    transitions and durable counts, and exactly the transitions the
    reference journaled (none in the healthy arm)."""
    records = sink.read_records(DRILL[arm])
    assert records == jsink.read_records(DRILL[arm])
    got, existing = alarms.replay_journal(
        alarms.AlarmEngine(alarms.default_specs(threshold=1.5),
                           kinds=("metrics_window",)), records)
    want, want_existing = jalarms.replay_journal(
        jalarms.AlarmEngine(jalarms.default_specs(threshold=1.5),
                            kinds=("metrics_window",)), records)
    assert (got, existing) == (want, want_existing)
    journaled = [{k: v for k, v in r.items() if k not in ("kind", "run_id")}
                 for r in records if r["kind"] == alarms.TRANSITION_KIND]
    assert got == journaled
    assert bool(journaled) == (arm == "breach")


def test_write_transitions_writes_no_duplicate_on_append(tmp_path):
    """A journal cut after any of its durable transitions and resumed by
    replay + ``write_transitions`` in append mode ends with every
    transition exactly once: the port's journal equals the reference's
    resumed the same way, record for record."""
    rows = [r for r in _stream(3) if r["kind"] == "metrics_window"]

    def resume(pkg, spkg, path, cut):
        specs = _specs(pkg, 1, 2)
        with spkg.TelemetrySink(path=path) as s:
            engine = pkg.AlarmEngine(specs)
            done = 0
            for rec in rows:
                s.write_metrics_window({k: v for k, v in rec.items()
                                        if k != "kind"})
                for t in engine.observe(rec):
                    if done == cut:
                        break
                    s.write_record(pkg.TRANSITION_KIND, dict(t))
                    done += 1
                if done == cut:
                    break
        with spkg.TelemetrySink(path=path, append=True) as s:
            engine = pkg.AlarmEngine(specs)
            replayed, existing = pkg.replay_journal(
                engine, spkg.read_records(path))
            written = pkg.write_transitions(s, replayed, existing)
            covered = spkg.covered_upto(path, kind="metrics_window")
            for rec in rows:
                if rec["round_end"] > covered:
                    s.write_metrics_window({k: v for k, v in rec.items()
                                            if k != "kind"})
                    written += pkg.write_transitions(s, engine.observe(rec),
                                                     existing)
        return written, [{k: v for k, v in r.items() if k != "run_id"}
                         for r in spkg.read_records(path)]

    full = alarms.AlarmEngine(_specs(alarms, 1, 2))
    total = [t for rec in rows for t in full.observe(rec)]
    assert len(total) >= 4
    for cut in (0, 1, len(total) // 2, len(total) - 1):
        got = resume(alarms, sink, str(tmp_path / f"p{cut}.jsonl"), cut)
        want = resume(jalarms, jsink, str(tmp_path / f"j{cut}.jsonl"), cut)
        assert got == want
        journaled = [{k: v for k, v in r.items() if k != "kind"}
                     for r in got[1] if r["kind"] == alarms.TRANSITION_KIND]
        assert journaled == total
