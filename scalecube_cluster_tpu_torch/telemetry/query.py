"""Cross-run health queries: load and merge journals, SLOs, diff,
regress, and the blame engine over provenance rows.

Counterpart of ``scalecube_cluster_tpu/telemetry/query.py``, pure host
Python over JSONL journals and JSON artifacts, so a run on the card can
be judged without JAX.  Journals accumulate ``metrics_window`` rows
(windowed registry flushes), ``histogram`` rows (detection and removal
latency buckets), counter, curve, summary and ``provenance`` rows; this
module folds them into one :class:`HealthReport` per run and computes
the protocol's SLOs:

  - ``false_positive_observer_rate``: false-suspicion onsets per live
    observer-round (the bounded-false-positive guarantee),
  - ``detection_latency_p50/p99`` and ``removal_latency_p50/p99``
    rounds (from the latency histograms),
  - ``suspicion_lifetime_p50/p99`` rounds (from the registry's
    histogram),
  - ``dissemination_rounds`` (from the fraction-informed curve when
    present),

and compares runs: :func:`diff_reports` for two journals, :func:`regress`
for the ``BENCH_*.json`` + ``MULTICHIP_*.json`` trajectories and the
``artifacts/*.json`` drills with a noise band (``python -m
scalecube_cluster_tpu_torch.telemetry regress``).  The blame engine
(:func:`blame_report`, :func:`channel_mix`, :func:`provenance_slos`,
:func:`infection_paths`, :func:`explain_belief`) mines the provenance
plane's attribution rows (``models/provenance.decode_attributions``, or
a journal's ``provenance`` records).

Percentiles from buckets: counts in bucket i cover
``[edges[i], edges[i+1])`` (last bucket open); the percentile
interpolates linearly inside its bucket and clamps to the last edge for
the open tail, a lower bound there (real latencies in the open bucket
are >= the reported value).
"""

from __future__ import annotations

import dataclasses
import glob as globlib
import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

from scalecube_cluster_tpu_torch.telemetry import sink as tsink

THROUGHPUT_METRIC = "swim_member_rounds_per_sec_per_chip"
DEFAULT_NOISE_BAND = 0.10
# Dissemination is integer-quantized (rounds); allow the quantization
# step on top of the relative band before calling it a regression.
DISSEMINATION_SLACK_ROUNDS = 1
# The provenance plane's overhead ceiling in the reference's bench
# (armed stack over the same stack without the plane, interleaved on one
# host).
PROVENANCE_OVERHEAD_LIMIT = 1.10


# --------------------------------------------------------------------------
# Loading + merging one run's manifest
# --------------------------------------------------------------------------


@dataclasses.dataclass
class HealthReport:
    """One run's folded health state.

    ``counters``/``gauges``: merged over every ``metrics_window`` row
    (counters sum — they are window totals; gauges take the LAST
    window's sample).  ``histograms``: bucket counts summed per name,
    both the registry's windows and standalone ``histogram`` records
    (detection/removal latency).  ``windows`` keeps the raw per-window
    rows for time-resolved rendering.
    """

    path: str
    run_id: Optional[str]
    counters: Dict[str, int]
    gauges: Dict[str, float]
    histograms: Dict[str, Tuple[List[int], List[int]]]  # name -> (edges, counts)
    windows: List[dict]
    curves: Dict[str, dict]
    summary: dict
    # Channel-attribution rows (``provenance`` records) — empty
    # for journals written before the plane existed (old journals stay
    # valid; the blame engine just has nothing to mine).
    provenance: List[dict] = dataclasses.field(default_factory=list)

    @property
    def rounds_covered(self) -> int:
        return max((int(w["round_end"]) for w in self.windows), default=0)


def _merge_hist(store: Dict[str, Tuple[List[int], List[int]]], name: str,
                edges: Sequence[int], counts: Sequence[int]) -> None:
    edges, counts = list(edges), [int(c) for c in counts]
    if name not in store:
        store[name] = (edges, counts)
        return
    old_edges, old_counts = store[name]
    if old_edges != edges:
        raise ValueError(
            f"histogram {name!r}: incompatible edges across records "
            f"({old_edges} vs {edges})")
    store[name] = (old_edges,
                   [a + b for a, b in zip(old_counts, counts)])


def load_report(path: str) -> HealthReport:
    """Fold one JSONL manifest into a :class:`HealthReport`."""
    counters: Dict[str, int] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, Tuple[List[int], List[int]]] = {}
    windows: List[dict] = []
    curves: Dict[str, dict] = {}
    summary: dict = {}
    provenance: List[dict] = []
    run_id = None
    for rec in tsink.iter_records(path):
        run_id = run_id or rec.get("run_id")
        kind = rec.get("kind")
        if kind == "metrics_window":
            windows.append(rec)
            for k, v in rec.get("counters", {}).items():
                counters[k] = counters.get(k, 0) + int(v)
            for k, v in rec.get("gauges", {}).items():
                gauges[k] = float(v)          # last window wins
            for name, h in rec.get("histograms", {}).items():
                _merge_hist(hists, name, h["edges"], h["counts"])
        elif kind == "histogram":
            _merge_hist(hists, rec["name"], rec["edges"], rec["counts"])
        elif kind == "curve":
            curves[rec["name"]] = rec
        elif kind == "summary":
            summary.update({k: v for k, v in rec.items()
                            if k not in ("kind", "run_id")})
        elif kind == "events_footer":
            # The trace buffer's overflow accounting (sink.write_events'
            # footer): fold it into a counter lane so a truncated event
            # stream surfaces in every report/regress path instead of
            # living only in the raw journal (drops are additive across
            # segments — each footer closes one segment's buffer).
            counters["trace_dropped_total"] = (
                counters.get("trace_dropped_total", 0)
                + int(rec.get("dropped", 0)))
        elif kind == "provenance":
            provenance.append(rec)
            # Accounting totals are idempotent across chunks
            # (sink.write_provenance) — last one wins.
            if "dropped" in rec:
                counters["provenance_dropped_total"] = int(rec["dropped"])
    provenance.sort(key=lambda r: int(r.get("offset", 0)))
    rows = [row for rec in provenance for row in rec.get("rows", [])]
    return HealthReport(path=path, run_id=run_id, counters=counters,
                        gauges=gauges, histograms=hists, windows=windows,
                        curves=curves, summary=summary, provenance=rows)


def merge_reports(reports: Sequence[HealthReport]) -> HealthReport:
    """Fold several runs' reports into one (counters/histograms sum,
    gauges take the last run's samples) — the cross-run aggregate the
    CLI ``report`` command prints for multiple manifests."""
    out = HealthReport(path=",".join(r.path for r in reports),
                       run_id=None, counters={}, gauges={}, histograms={},
                       windows=[], curves={}, summary={})
    for r in reports:
        for k, v in r.counters.items():
            out.counters[k] = out.counters.get(k, 0) + v
        out.gauges.update(r.gauges)
        for name, (edges, counts) in r.histograms.items():
            _merge_hist(out.histograms, name, edges, counts)
        out.windows.extend(r.windows)
        out.curves.update(r.curves)
        out.summary.update(r.summary)
        out.provenance.extend(r.provenance)
    return out


# --------------------------------------------------------------------------
# SLOs
# --------------------------------------------------------------------------


def percentile_from_histogram(edges: Sequence[int], counts: Sequence[int],
                              q: float) -> Optional[float]:
    """q-th percentile (q in [0, 1]) from bucketed counts.

    Linear interpolation within the bucket; the open last bucket clamps
    to its lower edge (conservative: real latencies there are >= it).
    None when the histogram is empty.
    """
    total = sum(counts)
    if total == 0:
        return None
    target = q * total
    if target == 0:  # p0 = the smallest observed bucket's lower edge
        return float(edges[next(i for i, c in enumerate(counts) if c)])
    cum = 0.0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= target:
            lo = edges[i]
            hi = edges[i + 1] if i + 1 < len(edges) else edges[i]
            frac = (target - cum) / c
            return float(lo + (hi - lo) * frac)
        cum += c
    return float(edges[-1])


def dissemination_rounds_from_curve(curve: dict) -> Optional[int]:
    """First round the fraction-informed curve reaches 1.0 (upper bound
    under downsampling: the stride makes this at most one stride late,
    never early), relative to the curve's round offset."""
    values = curve.get("values") or []
    stride = int(curve.get("stride", 1))
    for i, v in enumerate(values):
        if v >= 1.0:
            return i * stride
    return None


def compute_slos(report: HealthReport) -> dict:
    """The protocol health SLOs of one (merged) report — module
    docstring.  Missing inputs yield None, never a crash: a partial
    manifest still reports what it can."""
    c, g = report.counters, report.gauges
    slos: dict = {}

    onsets = c.get("false_suspicion_onsets")
    obs_rounds = c.get("live_observer_rounds")
    slos["false_positive_observer_rate"] = (
        (onsets / obs_rounds) if onsets is not None and obs_rounds
        else None)

    for name, key in (("detection_latency", "detection_latency_rounds"),
                      ("removal_latency", "removal_latency_rounds"),
                      ("suspicion_lifetime", "suspicion_lifetime_rounds")):
        h = report.histograms.get(key)
        for q, tag in ((0.5, "p50"), (0.99, "p99")):
            slos[f"{name}_{tag}"] = (
                percentile_from_histogram(h[0], h[1], q) if h else None)

    curve = report.curves.get("fraction_informed")
    slos["dissemination_rounds"] = (
        dissemination_rounds_from_curve(curve) if curve else None)

    # SYNC anti-entropy plane: rounds from the partition heal to the
    # first divergence-free membership table (bench.py --sync writes
    # this into the run's summary row; models/sync.py defines the
    # divergence observable).
    slos["sync_rounds_to_converge"] = report.summary.get(
        "sync_rounds_to_converge")

    # Metadata KV plane: p99 of per-push convergence latency (rounds
    # from a config push — or the end of the disruption that covered it
    # — to every live table holding the word; bench.py --rollout writes
    # this into the run's summary row, models/metadata.py defines the
    # divergence observable).
    slos["metadata_convergence_p99"] = report.summary.get(
        "metadata_convergence_p99")

    slos["chaos_violations"] = c.get("chaos_violations")
    slos["suspect_entries"] = g.get("suspect_entries")
    slos["wire_saturation"] = g.get("wire_saturation")
    slos["gossip_piggyback_occupancy"] = g.get("gossip_piggyback_occupancy")
    slos["rounds_covered"] = report.rounds_covered or None

    # Trace-buffer overflow, surfaced as a first-class lane (an
    # events_footer journals it; a report that never shows it invites
    # mistaking a truncated trace for a complete one).  None when the
    # journal carries no event stream at all.
    slos["trace_dropped_total"] = c.get("trace_dropped_total")

    # Provenance plane: channel-mix SLOs over the journaled
    # attribution rows — absent (not None-padded) for journals without
    # the plane, so pre-plane reports render unchanged.
    if report.provenance:
        slos.update(provenance_slos(report.provenance))
        slos["provenance_dropped_total"] = c.get(
            "provenance_dropped_total", 0)
    return slos


# --------------------------------------------------------------------------
# The blame engine: infection paths, channel-mix SLOs, explain
# --------------------------------------------------------------------------

# Channels that are first-hand evidence (the observer's own failure
# detector, direct or through its ping-req proxies); every other channel
# relays somebody else's verdict (models/provenance.CHANNEL_NAMES).
FIRST_HAND_CHANNELS = ("fd_direct", "pingreq_proxy")

# The transitions that make up "believing the subject is failing".
SUSPICION_TRANSITIONS = ("SUSPECTED", "REMOVED")


def _percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile of a raw sample list (None when empty)."""
    if not values:
        return None
    v = sorted(values)
    idx = min(len(v) - 1, max(0, math.ceil(q * len(v)) - 1))
    return float(v[idx])


def infection_paths(rows: Sequence[dict], subject: int,
                    transitions: Sequence[str] = SUSPICION_TRANSITIONS
                    ) -> Dict[int, dict]:
    """Per-observer infection path for one subject: observer ->
    ``{"first_round", "first_channel", "first_transition", "channels":
    {channel: first round seen via it}}``, over the rows whose transition
    is in ``transitions`` (default: SUSPECTED and REMOVED)."""
    paths: Dict[int, dict] = {}
    for r in rows:
        if int(r.get("subject", -1)) != subject:
            continue
        if r.get("transition") not in transitions:
            continue
        obs, ch, rnd = int(r["observer"]), r["channel"], int(r["round"])
        entry = paths.setdefault(obs, {
            "first_round": None, "first_channel": None,
            "first_transition": None, "channels": {},
        })
        if ch not in entry["channels"] or rnd < entry["channels"][ch]:
            entry["channels"][ch] = rnd
        if entry["first_round"] is None or rnd < entry["first_round"]:
            entry["first_round"] = rnd
            entry["first_channel"] = ch
            entry["first_transition"] = r["transition"]
    return paths


def channel_mix(rows: Sequence[dict]) -> Dict[str, float]:
    """Fraction of attributed transitions per channel ({} when empty);
    the cascade is total, so the fractions sum to 1.0."""
    counts: Dict[str, int] = {}
    for r in rows:
        counts[r["channel"]] = counts.get(r["channel"], 0) + 1
    total = sum(counts.values())
    if not total:
        return {}
    return {ch: c / total for ch, c in sorted(counts.items())}


def provenance_slos(rows: Sequence[dict]) -> dict:
    """Channel-mix SLOs over the attribution rows: ``channel_mix``;
    ``removal_via_sync_fraction``, of the REMOVED transitions the share
    won by the SYNC family; ``dissemination_hops_p99``, the p99 over all
    rows of (its round - the earliest round of its (subject,
    transition) group)."""
    out: dict = {"channel_mix": channel_mix(rows)}
    removed = [r for r in rows if r.get("transition") == "REMOVED"]
    out["removal_via_sync_fraction"] = (
        sum(1 for r in removed if r["channel"] == "sync") / len(removed)
        if removed else None)
    first: Dict[tuple, int] = {}
    for r in rows:
        k = (int(r["subject"]), r["transition"])
        rnd = int(r["round"])
        if k not in first or rnd < first[k]:
            first[k] = rnd
    lags = [int(r["round"]) - first[(int(r["subject"]), r["transition"])]
            for r in rows]
    out["dissemination_hops_p99"] = _percentile(lags, 0.99)
    return out


def blame_report(rows: Sequence[dict], subject: int) -> dict:
    """Who planted the belief that ``subject`` failed, and how it spread:
    ``origin_observer`` / ``origin_round`` / ``origin_channel`` the
    earliest first-hand sighting (else the onset), ``first_carrier_
    channel`` the earliest sighting at any other observer, ``refuted``
    whether an ALIVE_REFUTED or ADDED row of the subject follows the
    onset (the false-positive signature), and the spread's extent;
    ``verdict`` "no_suspicion_recorded" without suspicion rows."""
    sight = sorted(
        (r for r in rows
         if int(r.get("subject", -1)) == subject
         and r.get("transition") in SUSPICION_TRANSITIONS),
        key=lambda r: int(r["round"]))
    if not sight:
        return {"subject": subject, "verdict": "no_suspicion_recorded"}
    onset = sight[0]
    first_hand = [r for r in sight
                  if r["channel"] in FIRST_HAND_CHANNELS]
    origin = first_hand[0] if first_hand else onset
    carriers = [r for r in sight
                if int(r["observer"]) != int(origin["observer"])]
    refuted = any(
        int(r.get("subject", -1)) == subject
        and r.get("transition") in ("ALIVE_REFUTED", "ADDED")
        and int(r["round"]) >= int(onset["round"])
        for r in rows)
    return {
        "subject": subject,
        "verdict": "refuted_false_positive" if refuted else "suspected",
        "onset_round": int(onset["round"]),
        "origin_observer": int(origin["observer"]),
        "origin_round": int(origin["round"]),
        "origin_channel": origin["channel"],
        "origin_first_hand": bool(first_hand),
        "first_carrier_channel": (carriers[0]["channel"] if carriers
                                  else None),
        "observers_informed": len({int(r["observer"]) for r in sight}),
        "last_round": int(sight[-1]["round"]),
        "refuted": refuted,
    }


def explain_belief(rows: Sequence[dict], observer: int, subject: int,
                   round_idx: Optional[int] = None) -> dict:
    """Why ``observer`` believed what it did about ``subject``: every
    row of the pair in round order, ``answer`` the row in force at
    ``round_idx`` (the last at or before it; the latest when None), and
    as ``context`` the subject's :func:`blame_report` and this observer's
    :func:`infection_paths` entry."""
    events = sorted(
        (r for r in rows
         if int(r.get("observer", -1)) == observer
         and int(r.get("subject", -1)) == subject),
        key=lambda r: int(r["round"]))
    answer = None
    if round_idx is None:
        answer = events[-1] if events else None
    else:
        at_or_before = [r for r in events
                        if int(r["round"]) <= round_idx]
        answer = at_or_before[-1] if at_or_before else None
    return {
        "observer": observer,
        "subject": subject,
        "round": round_idx,
        "events": events,
        "answer": answer,
        "context": {
            "blame": blame_report(rows, subject),
            "infection_path": infection_paths(rows, subject).get(observer),
        },
    }


# --------------------------------------------------------------------------
# diff
# --------------------------------------------------------------------------


def diff_reports(a: HealthReport, b: HealthReport) -> List[dict]:
    """Per-SLO and per-counter comparison rows for two runs.

    Each row: {"metric", "a", "b", "delta", "rel"} (rel None when a is
    0/None).  Ordering: SLOs first, then counters, then gauges — the
    stable rendering contract the CLI table prints.
    """
    rows: List[dict] = []

    def add(name, va, vb):
        delta = (vb - va) if (va is not None and vb is not None) else None
        rel = (delta / va) if (delta is not None and va) else None
        rows.append({"metric": name, "a": va, "b": vb, "delta": delta,
                     "rel": rel})

    sa, sb = compute_slos(a), compute_slos(b)
    for name in sa:
        add(f"slo/{name}", sa[name], sb.get(name))
    for name in sorted(set(a.counters) | set(b.counters)):
        add(f"counter/{name}", a.counters.get(name), b.counters.get(name))
    for name in sorted(set(a.gauges) | set(b.gauges)):
        add(f"gauge/{name}", a.gauges.get(name), b.gauges.get(name))
    return rows


def format_table(rows: List[dict], headers: Sequence[str]) -> str:
    """Fixed-width text table (no dependencies; right-aligned numbers)."""
    def fmt(v):
        if v is None:
            return "-"
        if isinstance(v, float):
            return f"{v:.6g}"
        return str(v)

    table = [[fmt(r.get(h)) for h in headers] for r in rows]
    widths = [max(len(h), *(len(row[i]) for row in table)) if table
              else len(h) for i, h in enumerate(headers)]
    out = ["  ".join(h.ljust(widths[i]) for i, h in enumerate(headers))]
    out.append("  ".join("-" * w for w in widths))
    for row in table:
        out.append("  ".join(row[i].rjust(widths[i]) if i else
                             row[i].ljust(widths[i])
                             for i in range(len(headers))))
    return "\n".join(out)


# --------------------------------------------------------------------------
# regress: the BENCH_*.json trajectory gate
# --------------------------------------------------------------------------


def load_bench_payload(path: str) -> Tuple[Optional[dict], Optional[str]]:
    """One BENCH/MULTICHIP artifact's measurement payload as
    ``(payload, skip_note)``.

    ``payload`` is None — with the reason in ``skip_note`` — when the
    round recorded a failure (rc != 0 / parsed null) or is a legacy
    stub with no measurement fields (the MULTICHIP_r01..r05
    ``{"rc":0,"ok":true}`` era): both are kept in the committed
    trajectory as provenance and skipped, never failed."""
    with open(path) as f:
        doc = json.load(f)
    if "parsed" in doc or "rc" in doc:
        if doc.get("rc") not in (0, None):
            return None, "failed run (skipped)"
        payload = doc.get("parsed")
        stub_note = "legacy stub round — no measurement payload (skipped)"
    else:
        payload = doc
        stub_note = "no measurement fields (skipped)"
    if not isinstance(payload, dict) or payload.get("value") is None:
        if not (isinstance(payload, dict)
                and ("traced_overhead_ratio" in payload
                     or "metrics_overhead_ratio" in payload
                     or "pipelined_speedup_ratio" in payload
                     or "sync_rounds_to_converge" in payload
                     or "metadata_convergence_p99" in payload
                     or "fp_ratio" in payload
                     or "no_resurrection_violations" in payload
                     or "vmap_speedup_ratio" in payload
                     or "fused_serial_speedup_ratio" in payload
                     or "compose_speedup_ratio" in payload
                     or "findings_total" in payload
                     or "alarm_detection_lag_windows" in payload
                     or "batch_speedup_ratio" in payload
                     or "rounds_survived" in payload
                     or "blame_origin_correct" in payload)):
            return None, stub_note
    return payload, None


def regress(paths: Sequence[str],
            band: float = DEFAULT_NOISE_BAND) -> Tuple[bool, List[dict]]:
    """Walk a BENCH_*.json / MULTICHIP_*.json trajectory (sorted by
    filename = round order); the LATEST measurement of each tracked
    metric must not regress beyond the noise band against the best
    prior value.  Artifacts group into series by their ``metric``
    field, so the single-chip and multichip per-chip trajectories gate
    independently in one walk.

    Checks:
      - throughput (``value`` of each headline metric — including the
        multichip per-chip rate): latest must be >= best_prior *
        (1 - band).  Rounds marked ``"smoke": true`` are excluded from
        this comparison (recorded as skipped rows): a smoke window's
        absolute rate depends on whatever host/load ran it, so only
        real bench rounds form the throughput trajectory — smoke
        rounds still contribute their machine-independent ratio
        checks below;
      - ``dissemination_rounds``: latest must be <= best_prior *
        (1 + band) + 1 quantization round;
      - overhead ratios (``traced_overhead_ratio``,
        ``metrics_overhead_ratio``): latest must be <= 1 + band
        (absolute — 1.0 means the observability plane is free);
      - ``pipelined_speedup_ratio`` (multichip pipelined/serial rate):
        latest must be >= 1 - band — the delivery pipeline must never
        cost throughput;
      - SYNC heal artifacts (``sync_rounds_to_converge`` present):
        the latest must have ``converged`` true with
        ``post_heal_divergence`` 0 (and the gossip-only control still
        diverging, when recorded) — absolute gates — and the
        convergence-time series stays <= best_prior * (1 + band) + 1
        quantization round;
      - Config-rollout artifacts (``rollout_converged`` present,
        bench.py --rollout): absolute gates — the staged rollout
        converged every stage within its deadline with no rollback,
        the gossip-only control (metadata on, SYNC off) still
        divergent, ``metadata_convergence_p99`` within the scenario's
        convergence bound, and zero monitor violations — plus the
        banded non-smoke p99 series (smoke rows under the sync-heal
        fallback rule);
      - Lifeguard A/B artifacts (``fp_ratio`` +
        ``detection_p99_delta_rounds`` present, bench.py --lifeguard):
        absolute gates — ``fp_ratio`` (plane-on FP observer rate over
        its own control) <= 0.5 and the crash-detection latency P99
        delta <= +1 round;
      - Fuzz-campaign artifacts (``vmap_speedup_ratio`` + ``coverage``
        present, bench.py --fuzz): absolute gates — the healthy
        mega-campaign green, the weakened coverage arm found > 0
        planted violations with the healthy arm at 0 on the same
        slice, and (full rounds only) ``vmap_speedup_ratio`` >= 1 —
        plus the banded non-smoke ``scenario_throughput`` series;
      - Composed-runner artifacts (``compose_speedup_ratio`` present,
        bench.py --compose): absolute gates — the full instrumented
        stack's one-scan route at least matches the alias-by-alias
        route (ratio >= 1.0), its overhead vs bare stays within the
        band of head-style's, the compile-count arm is strictly
        reduced, and the alias parity probe was green;
      - swimlint artifacts (``findings_total`` present,
        ``python -m scalecube_cluster_tpu.analysis check``): absolute
        gates — ``findings_total`` == 0 (unsuppressed static-analysis
        findings are never noise) and the artifact self-reports ok;
      - Alarm-drill artifacts (``alarm_detection_lag_windows`` present,
        bench.py --alarms): absolute gates — the breach arm's planted
        SLO breach fired (>= 1 firing transition) within one metrics
        window of onset, resolved after the heal, and the healthy arm
        fired ZERO alarms;
      - Autotuner artifacts (``batch_speedup_ratio`` + ``profiles``
        present, bench.py --tune): absolute gates — the traced-knob
        grid sweep (one compile per shape bucket) at least matches the
        static recompile-per-config sweep (ratio >= 1.0), >= 2
        named tuned profiles shipped, each Pareto-non-dominated by the
        reference default over the recorded objectives (dominance
        recomputed from the payload) and fuzz-oracle green on
        held-out seeds;
      - Soak artifacts (``rounds_survived`` + ``drift`` present,
        bench.py --soak): absolute gates — zero monitor violations
        across the whole lifetime, the compose program's compile cache
        FLAT after segment 1 (runtime recompile drift), host RSS
        bounded, the seeded mid-soak SIGKILL/relaunch drill
        byte-identical to the uninterrupted run (journal AND state
        digest), and the live alarm engine quiet.  Smoke soaks are
        provenance unless the walk holds only smoke rounds (the
        sync-heal fallback rule);
      - Blame-drill artifacts (``blame_origin_correct`` present,
        bench.py --blame): ABSOLUTE gates — the blame report named the
        planted faulty-link origin, every recorded transition carried
        exactly one channel (attribution fractions sum to 1.0 with
        zero provenance-buffer drops AND zero trace drops — the
        committed full-provenance artifact must be complete), the
        off-switch stayed bit-identical (states + metrics),
        ``provenance_overhead_ratio`` <= 1.10 (absolute — the plane
        must stay near-free next to the same composed stack without
        it), and the ``telemetry explain`` probe resolved its seeded
        (observer, subject) query with the correct channel and round.
        Smoke drills are provenance unless the walk holds only smoke
        rounds (the sync-heal fallback rule: `--blame --smoke`'s
        in-bench check of its own fresh artifact still bites).

    Returns (ok, check rows); each row {"check", "latest", "reference",
    "threshold", "ok", "source"}.  Unreadable/failed artifacts — and
    the legacy MULTICHIP stub rounds that carry no throughput fields —
    are reported as skipped rows (ok=None): provenance, not a
    regression.
    """
    rows: List[dict] = []
    series: Dict[str, List[Tuple[str, dict]]] = {}
    # Round order is carried by the FILENAME (BENCH_r01 < BENCH_r02...):
    # sort on basenames so an artifact passed by absolute path (the
    # bench gates the one it just wrote, often under a tmp dir) still
    # lands at its round position instead of wherever its directory
    # happens to sort — '/tmp/...' < 'MULTICHIP_r06.json' would have
    # made the stale committed round the "latest" one.
    for path in sorted(paths, key=lambda p: (os.path.basename(p), p)):
        try:
            payload, skip_note = load_bench_payload(path)
        except (OSError, json.JSONDecodeError) as e:
            rows.append({"check": "load", "source": os.path.basename(path),
                         "ok": None,
                         "note": f"unreadable: {type(e).__name__}: {e}"})
            continue
        if payload is None:
            rows.append({"check": "load", "source": os.path.basename(path),
                         "ok": None, "note": skip_note})
            continue
        metric = payload.get("metric", "unknown")
        series.setdefault(metric, []).append((path, payload))

    ok = True

    def check(name, source, latest, reference, threshold, passed):
        nonlocal ok
        ok = ok and passed
        rows.append({"check": name, "source": os.path.basename(source),
                     "latest": latest, "reference": reference,
                     "threshold": threshold, "ok": passed})

    for metric, entries in sorted(series.items()):
        values = [(p, pl["value"]) for p, pl in entries
                  if isinstance(pl.get("value"), (int, float))
                  and not pl.get("smoke")]
        for p, pl in entries:
            if isinstance(pl.get("value"), (int, float)) and pl.get("smoke"):
                rows.append({
                    "check": f"throughput/{metric}",
                    "source": os.path.basename(p), "ok": None,
                    "note": "smoke round — host-dependent rate, not a "
                            "trajectory datum (ratio checks still apply)",
                })
        if len(values) >= 2:
            *prior, (last_path, last) = values
            best = max(v for _, v in prior)
            check(f"throughput/{metric}", last_path, last,
                  best, best * (1.0 - band), last >= best * (1.0 - band))
        dis = [(p, pl["dissemination_rounds"]) for p, pl in entries
               if isinstance(pl.get("dissemination_rounds"), (int, float))
               and pl["dissemination_rounds"] > 0]
        if len(dis) >= 2:
            *prior, (last_path, last) = dis
            best = min(v for _, v in prior)
            limit = best * (1.0 + band) + DISSEMINATION_SLACK_ROUNDS
            check("slo/dissemination_rounds", last_path, last, best,
                  limit, last <= limit)
        for ratio_key in ("traced_overhead_ratio", "metrics_overhead_ratio"):
            ratios = [(p, pl[ratio_key]) for p, pl in entries
                      if isinstance(pl.get(ratio_key), (int, float))]
            if ratios:
                last_path, last = ratios[-1]
                limit = 1.0 + band
                check(f"slo/{ratio_key}", last_path, last, 1.0, limit,
                      last <= limit and math.isfinite(last))
        # The delivery pipeline's floor: pipelined must not run slower
        # than the serial combine beyond noise (ratio = pipelined/serial,
        # >= 1 means the overlap pays).
        speedups = [(p, pl["pipelined_speedup_ratio"]) for p, pl in entries
                    if isinstance(pl.get("pipelined_speedup_ratio"),
                                  (int, float))]
        if speedups:
            last_path, last = speedups[-1]
            floor = 1.0 - band
            check("slo/pipelined_speedup_ratio", last_path, last, 1.0,
                  floor, last >= floor and math.isfinite(last))
        # SYNC anti-entropy heal artifacts (bench.py --sync): the latest
        # round's headline claims gate ABSOLUTELY — the plane must have
        # converged with zero post-heal divergence while the gossip-only
        # control demonstrably did not — and the convergence-time series
        # gates within the band (smaller is better; +1 quantization
        # round, like dissemination).  Smoke heal artifacts are
        # provenance, not trajectory data (their tiny N converges on a
        # different scale), UNLESS the walk holds only smoke rounds —
        # then they gate themselves, so `--sync --smoke`'s in-bench
        # check of its own fresh artifact still bites.
        heals_all = [(p, pl) for p, pl in entries
                     if "sync_rounds_to_converge" in pl]
        heals = [(p, pl) for p, pl in heals_all
                 if not pl.get("smoke")] or heals_all
        if heals is not heals_all:
            for p, pl in heals_all:
                if pl.get("smoke"):
                    rows.append({
                        "check": "slo/sync_heal", "source":
                        os.path.basename(p), "ok": None,
                        "note": "smoke heal round — different scale, "
                                "not a trajectory datum",
                    })
        if heals:
            last_path, last = heals[-1]
            converged = bool(last.get("converged"))
            check("slo/sync_heal_converged", last_path, converged, True,
                  True, converged)
            phd = last.get("post_heal_divergence")
            check("slo/post_heal_divergence", last_path, phd, 0, 0,
                  phd == 0)
            if "gossip_only_converged" in last:
                check("slo/gossip_only_diverges", last_path,
                      last["gossip_only_converged"], False, False,
                      last["gossip_only_converged"] is False)
            # Absolute contract: convergence landed inside the
            # scenario's promised window.
            rounds_c = last.get("sync_rounds_to_converge")
            window = last.get("window_rounds")
            if isinstance(rounds_c, (int, float)) and isinstance(
                    window, (int, float)):
                check("slo/sync_converge_within_window", last_path,
                      rounds_c, window, window, rounds_c <= window)
        conv = [(p, pl) for p, pl in heals
                if isinstance(pl.get("sync_rounds_to_converge"),
                              (int, float))]
        if len(conv) >= 2:
            *prior, (last_path, last) = conv
            best = min(pl["sync_rounds_to_converge"] for _, pl in prior)
            # Floor the reference at one exchange interval: where the
            # heal round lands relative to the exchange cadence is phase
            # luck, so a prior run converging on the very first probe
            # must not turn the band into a knife edge.
            floor = last.get("sync_interval") or 0
            limit = (max(best, floor) * (1.0 + band)
                     + DISSEMINATION_SLACK_ROUNDS)
            check("slo/sync_rounds_to_converge", last_path,
                  last["sync_rounds_to_converge"], best, limit,
                  last["sync_rounds_to_converge"] <= limit)
        # Config-rollout artifacts (bench.py --rollout): the staged
        # rollout's headline claims gate ABSOLUTELY — every stage
        # converged within its deadline with no rollback, the
        # gossip-only control (metadata on, SYNC off) demonstrably did
        # NOT converge through the partition, the per-push convergence
        # p99 landed inside the scenario's promised bound
        # (chaos/scenarios.metadata_convergence_bound, recorded in the
        # payload), and the monitored composite ran violation-free.
        # Smoke rollout artifacts are provenance unless the walk holds
        # only smoke rounds (the sync-heal fallback rule: `--rollout
        # --smoke`'s in-bench check of its own fresh artifact bites).
        ro_all = [(p, pl) for p, pl in entries
                  if "rollout_converged" in pl]
        ro = [(p, pl) for p, pl in ro_all
              if not pl.get("smoke")] or ro_all
        if ro is not ro_all:
            for p, pl in ro_all:
                if pl.get("smoke"):
                    rows.append({
                        "check": "slo/config_rollout", "source":
                        os.path.basename(p), "ok": None,
                        "note": "smoke rollout round — different scale, "
                                "not a trajectory datum",
                    })
        if ro:
            last_path, last = ro[-1]
            converged = bool(last.get("rollout_converged"))
            check("slo/rollout_converged", last_path, converged, True,
                  True, converged)
            rb = last.get("rolled_back")
            check("slo/rollout_not_rolled_back", last_path, rb, False,
                  False, rb is False)
            if "control_converged" in last:
                check("slo/rollout_control_diverges", last_path,
                      last["control_converged"], False, False,
                      last["control_converged"] is False)
            p99 = last.get("metadata_convergence_p99")
            bound = last.get("convergence_deadline_rounds")
            if isinstance(p99, (int, float)) and isinstance(
                    bound, (int, float)):
                check("slo/metadata_convergence_p99_within_bound",
                      last_path, p99, bound, bound, p99 <= bound)
            mv = last.get("monitor_violations")
            check("slo/rollout_monitor_violations", last_path, mv, 0, 0,
                  mv == 0)
        ro_conv = [(p, pl) for p, pl in ro
                   if isinstance(pl.get("metadata_convergence_p99"),
                                 (int, float))]
        if len(ro_conv) >= 2:
            *prior, (last_path, last) = ro_conv
            best = min(pl["metadata_convergence_p99"] for _, pl in prior)
            # Same phase-luck floor as the sync series: one exchange
            # interval.
            floor = last.get("sync_interval") or 0
            limit = (max(best, floor) * (1.0 + band)
                     + DISSEMINATION_SLACK_ROUNDS)
            check("slo/metadata_convergence_p99", last_path,
                  last["metadata_convergence_p99"], best, limit,
                  last["metadata_convergence_p99"] <= limit)
        # Lifeguard A/B artifacts (bench.py --lifeguard): the headline
        # adaptivity claims gate ABSOLUTELY — the plane must at least
        # halve the false-positive observer rate of its own control
        # while keeping crash-detection latency P99 within one round —
        # so the committed win cannot silently rot.  Smoke artifacts
        # are provenance unless the walk holds only smoke rounds (the
        # sync-heal rule: `--lifeguard --smoke`'s in-bench check of its
        # own fresh artifact still bites).
        lg_all = [(p, pl) for p, pl in entries
                  if "fp_ratio" in pl
                  and "detection_p99_delta_rounds" in pl]
        lg = [(p, pl) for p, pl in lg_all
              if not pl.get("smoke")] or lg_all
        if lg is not lg_all:
            for p, pl in lg_all:
                if pl.get("smoke"):
                    rows.append({
                        "check": "slo/lifeguard_fp", "source":
                        os.path.basename(p), "ok": None,
                        "note": "smoke lifeguard round — different "
                                "scale, not a trajectory datum",
                    })
        if lg:
            last_path, last = lg[-1]
            ratio = last.get("fp_ratio")
            if not isinstance(ratio, (int, float)):
                # bench.py records fp_ratio: null when the CONTROL arm
                # produced zero false-suspicion onsets — there was
                # nothing to improve, so the run demonstrates neither a
                # win nor a rot: provenance, not a regression.
                rows.append({
                    "check": "slo/lifeguard_fp", "source":
                    os.path.basename(last_path), "ok": None,
                    "note": "no FP signal (control recorded zero "
                            "onsets) — nothing to gate",
                })
            else:
                check("slo/lifeguard_fp_improvement", last_path, ratio,
                      0.5, 0.5, math.isfinite(ratio) and ratio <= 0.5)
                delta = last.get("detection_p99_delta_rounds")
                check("slo/lifeguard_detection_parity", last_path,
                      delta, 0.0, DISSEMINATION_SLACK_ROUNDS,
                      isinstance(delta, (int, float))
                      and math.isfinite(delta)
                      and delta <= DISSEMINATION_SLACK_ROUNDS)
        # Open-world churn A/B artifacts (bench.py --churn): ABSOLUTE
        # gates — the epoch guard must hold ZERO resurrection and
        # join-completeness violations with join propagation inside the
        # scenario's dissemination bound, the storm must actually GROW
        # the cluster, and the naive control arm must DEMONSTRATE the
        # resurrection failure (a control that stops failing means the
        # A/B stopped measuring the hazard).  Smoke artifacts are
        # provenance unless the walk holds only smoke rounds (the
        # sync-heal rule).
        ch_all = [(p, pl) for p, pl in entries
                  if "no_resurrection_violations" in pl
                  and "join_propagation_p99_rounds" in pl]
        ch = [(p, pl) for p, pl in ch_all
              if not pl.get("smoke")] or ch_all
        if ch is not ch_all:
            for p, pl in ch_all:
                if pl.get("smoke"):
                    rows.append({
                        "check": "slo/churn_growth", "source":
                        os.path.basename(p), "ok": None,
                        "note": "smoke churn round — different scale, "
                                "not a trajectory datum",
                    })
        if ch:
            last_path, last = ch[-1]
            check("slo/churn_no_resurrection", last_path,
                  last.get("no_resurrection_violations"), 0, 0,
                  last.get("no_resurrection_violations") == 0)
            check("slo/churn_join_completeness", last_path,
                  last.get("join_completeness_violations"), 0, 0,
                  last.get("join_completeness_violations") == 0)
            naive = last.get("naive_no_resurrection_violations")
            check("slo/churn_naive_demonstrates_failure", last_path,
                  naive, "> 0", 1,
                  isinstance(naive, (int, float)) and naive > 0)
            p99 = last.get("join_propagation_p99_rounds")
            jbound = last.get("join_propagation_bound_rounds")
            if isinstance(p99, (int, float)) and isinstance(
                    jbound, (int, float)):
                check("slo/churn_join_propagation_within_bound",
                      last_path, p99, jbound, jbound, p99 <= jbound)
            else:
                rows.append({
                    "check": "slo/churn_join_propagation_within_bound",
                    "source": os.path.basename(last_path), "ok": None,
                    "note": "no join-propagation samples recorded — "
                            "nothing to gate",
                })
            growth = last.get("net_growth_members")
            check("slo/churn_net_positive_growth", last_path, growth,
                  "> 0", 1,
                  isinstance(growth, (int, float)) and growth > 0)
        # Vmapped fuzz-campaign artifacts (bench.py --fuzz): the chaos
        # mega-fuzzer's speed AND quality gates.  ABSOLUTE — the
        # healthy mega-campaign is green, the deliberately-weakened
        # coverage arm FOUND its planted violations (> 0) while the
        # healthy arm found none on the same slice, and (full rounds
        # only) the vmapped batch beats the sequential dispatch loop:
        # ``vmap_speedup_ratio`` >= 1.  The speedup floor skips smoke
        # rounds as provenance — a mini smoke batch is mostly singleton
        # buckets, where there is no batch axis to amortize dispatch
        # over, so its ratio hovers at ~1 by construction and gating it
        # would be a coin flip; the quality gates keep the sync-heal
        # fallback rule (smoke rounds gate themselves when the walk
        # holds nothing else).  BANDED (non-smoke rounds only —
        # scenarios/sec is host-dependent, the throughput rule): the
        # ``scenario_throughput`` series is smaller-is-worse and must
        # not shrink beyond the noise band.
        fz_all = [(p, pl) for p, pl in entries
                  if "vmap_speedup_ratio" in pl and "coverage" in pl]
        fz = [(p, pl) for p, pl in fz_all
              if not pl.get("smoke")] or fz_all
        if fz is not fz_all:
            for p, pl in fz_all:
                if pl.get("smoke"):
                    rows.append({
                        "check": "slo/fuzz_campaign", "source":
                        os.path.basename(p), "ok": None,
                        "note": "smoke fuzz round — different scale, "
                                "not a trajectory datum (quality gates "
                                "still apply when nothing else walks)",
                    })
        if fz:
            last_path, last = fz[-1]
            speedup = last.get("vmap_speedup_ratio")
            if last.get("smoke"):
                rows.append({
                    "check": "slo/fuzz_vmap_speedup",
                    "source": os.path.basename(last_path), "ok": None,
                    "note": "smoke round — singleton-bucket mini "
                            "batches have no batch axis to amortize "
                            "dispatch over; the floor gates full "
                            "rounds",
                })
            else:
                check("slo/fuzz_vmap_speedup", last_path, speedup, 1.0,
                      1.0,
                      isinstance(speedup, (int, float))
                      and math.isfinite(speedup) and speedup >= 1.0)
            check("slo/fuzz_campaign_green", last_path,
                  last.get("green"), True, True,
                  last.get("green") is True)
            cov = last.get("coverage") or {}
            planted = cov.get("weakened_violations")
            check("slo/fuzz_coverage_finds_planted", last_path, planted,
                  "> 0", 1,
                  isinstance(planted, (int, float)) and planted > 0)
            healthy = cov.get("healthy_violations")
            check("slo/fuzz_coverage_healthy_clean", last_path, healthy,
                  0, 0, healthy == 0)
        st = [(p, pl["scenario_throughput"]) for p, pl in fz_all
              if isinstance(pl.get("scenario_throughput"), (int, float))
              and not pl.get("smoke")]
        if len(st) >= 2:
            *prior, (last_path, last) = st
            best = max(v for _, v in prior)
            check("slo/fuzz_scenario_throughput", last_path, last, best,
                  best * (1.0 - band), last >= best * (1.0 - band))
        # Fused-wire artifacts (bench.py --wire): the single-buffer
        # scatter wire's committed win.  ABSOLUTE gates on the latest
        # round — fused throughput >= the two-buffer HEAD path on BOTH
        # the serial and pipelined runs (ratio >= 1.0, a floor: the
        # collective halving must never cost throughput), the modeled
        # bytes/slot and collectives/round pinned exactly (4-vs-5 B,
        # 1-vs-2 combines — arithmetic, not host-dependent), the HLO
        # instruction counts matching the model when the text parse
        # was available (null = provenance), and shift-mode accounting
        # untouched.  Smoke artifacts are provenance unless the walk
        # holds only smoke rounds (the sync-heal rule: `--wire
        # --smoke`'s in-bench check of its own fresh artifact still
        # bites).
        wr_all = [(p, pl) for p, pl in entries
                  if "fused_serial_speedup_ratio" in pl
                  and "fused_pipelined_speedup_ratio" in pl]
        wr = [(p, pl) for p, pl in wr_all
              if not pl.get("smoke")] or wr_all
        if wr is not wr_all:
            for p, pl in wr_all:
                if pl.get("smoke"):
                    rows.append({
                        "check": "slo/wire_fused", "source":
                        os.path.basename(p), "ok": None,
                        "note": "smoke wire round — host-dependent "
                                "rates, not a trajectory datum",
                    })
        if wr:
            last_path, last = wr[-1]
            for ratio_key in ("fused_serial_speedup_ratio",
                              "fused_pipelined_speedup_ratio"):
                ratio = last.get(ratio_key)
                check(f"slo/{ratio_key}", last_path, ratio, 1.0, 1.0,
                      isinstance(ratio, (int, float))
                      and math.isfinite(ratio) and ratio >= 1.0)
            bps = last.get("wire_bytes_per_slot") or {}
            check("slo/wire_fused_bytes_per_slot", last_path,
                  bps.get("fused"), 4, 4, bps.get("fused") == 4)
            check("slo/wire_legacy_bytes_per_slot", last_path,
                  bps.get("legacy"), 5, 5, bps.get("legacy") == 5)
            cpr = last.get("wire_collectives_per_round") or {}
            check("slo/wire_fused_collectives_per_round", last_path,
                  cpr.get("fused"), 1, 1, cpr.get("fused") == 1)
            check("slo/wire_legacy_collectives_per_round", last_path,
                  cpr.get("legacy"), 2, 2, cpr.get("legacy") == 2)
            hlo = last.get("hlo_full_height_collectives")
            if isinstance(hlo, dict):
                check("slo/wire_hlo_fused_single_collective", last_path,
                      hlo.get("fused"), 1, 1, hlo.get("fused") == 1)
                check("slo/wire_hlo_legacy_collective_pair", last_path,
                      hlo.get("legacy"), 2, 2, hlo.get("legacy") == 2)
            else:
                rows.append({
                    "check": "slo/wire_hlo_fused_single_collective",
                    "source": os.path.basename(last_path), "ok": None,
                    "note": "no compiled-HLO collective count recorded "
                            "— nothing to gate",
                })
            check("slo/wire_shift_accounting_unchanged", last_path,
                  last.get("shift_accounting_unchanged"), True, True,
                  last.get("shift_accounting_unchanged") is True)
            parity = last.get("pipelined_serial_parity") or {}
            check("slo/wire_pipelined_serial_parity", last_path,
                  parity, True, True,
                  parity.get("fused") is True
                  and parity.get("legacy") is True)
        # Composed-runner artifacts (bench.py --compose): the full
        # instrumented stack through ONE scan must never lose to the
        # pre-compose alias-by-alias route.  ABSOLUTE gates on the
        # latest round — ``compose_speedup_ratio`` (head-style seconds
        # over composed seconds) >= 1.0 floor, the composed stack's
        # instrumentation overhead no worse than head-style's beyond
        # the band (both ratios share one host window, so the
        # comparison is machine-independent), and the compile-count
        # arm STRICTLY reduced (programs_composed < programs_head_
        # style — one program per layout where the aliases pay three).
        # The ratio gates apply to smoke rounds too (interleaved
        # same-host ratios, the metrics_overhead_ratio convention);
        # only the absolute rates are host-dependent provenance.
        cp = [(p, pl) for p, pl in entries
              if "compose_speedup_ratio" in pl]
        if cp:
            last_path, last = cp[-1]
            ratio = last.get("compose_speedup_ratio")
            check("slo/compose_speedup_ratio", last_path, ratio, 1.0,
                  1.0, isinstance(ratio, (int, float))
                  and math.isfinite(ratio) and ratio >= 1.0)
            fso = last.get("full_stack_overhead_ratio")
            hso = last.get("head_style_overhead_ratio")
            limit = (hso * (1.0 + band)
                     if isinstance(hso, (int, float)) else None)
            check("slo/compose_full_stack_overhead", last_path, fso,
                  hso, limit,
                  isinstance(fso, (int, float))
                  and isinstance(hso, (int, float))
                  and math.isfinite(fso) and fso <= limit)
            comp = last.get("compile") or {}
            ph = comp.get("programs_head_style")
            pc = comp.get("programs_composed")
            check("slo/compose_compile_count_reduced", last_path, pc,
                  ph, "strictly fewer",
                  isinstance(ph, (int, float))
                  and isinstance(pc, (int, float)) and 0 < pc < ph)
            par = last.get("parity") or {}
            check("slo/compose_alias_parity", last_path, par, True,
                  True, bool(par) and all(v is True
                                          for v in par.values()))
        # swimlint artifacts (python -m scalecube_cluster_tpu.analysis
        # check): ABSOLUTE — the committed static-analysis round must
        # be finding-free and self-reported ok.  findings_total counts
        # UNSUPPRESSED findings only (baselined asymmetries don't gate:
        # they carry a committed justification), so findings > 0 means
        # either a plane stopped reaching a run shape or a compile
        # audit went red — never noise, always a gate.
        sa = [(p, pl) for p, pl in entries
              if "findings_total" in pl]
        if sa:
            last_path, last = sa[-1]
            total = last.get("findings_total")
            check("slo/static_analysis_clean", last_path, total, 0, 0,
                  total == 0)
            check("slo/static_analysis_ok", last_path,
                  last.get("ok"), True, True, last.get("ok") is True)
        # Alarm-drill artifacts (bench.py --alarms): the live SLO alarm
        # engine's measured detection claim.  ABSOLUTE gates on the
        # latest round — the weakened-knobs breach arm FIRED (>= 1
        # firing transition) with ``alarm_detection_lag_windows`` <= 1
        # (the breach is caught within one metrics window of onset),
        # the alarm RESOLVED after the fault healed, and the healthy
        # arm — same world, same compiled program — fired ZERO alarms.
        # Smoke drills are provenance unless the walk holds only smoke
        # rounds (the sync-heal fallback rule: `--alarms --smoke`'s
        # in-bench check of its own fresh artifact still bites).
        al_all = [(p, pl) for p, pl in entries
                  if "alarm_detection_lag_windows" in pl
                  and "healthy_transitions" in pl]
        al = [(p, pl) for p, pl in al_all
              if not pl.get("smoke")] or al_all
        if al is not al_all:
            for p, pl in al_all:
                if pl.get("smoke"):
                    rows.append({
                        "check": "slo/alarm_drill", "source":
                        os.path.basename(p), "ok": None,
                        "note": "smoke alarm drill — different scale, "
                                "not a trajectory datum",
                    })
        if al:
            last_path, last = al[-1]
            fired = last.get("breach_fired")
            check("slo/alarm_breach_fired", last_path, fired, ">= 1",
                  1, isinstance(fired, (int, float)) and fired >= 1)
            lag = last.get("alarm_detection_lag_windows")
            check("slo/alarm_detection_lag", last_path, lag, 1.0, 1.0,
                  isinstance(lag, (int, float)) and math.isfinite(lag)
                  and lag <= 1.0)
            check("slo/alarm_resolved_after_heal", last_path,
                  last.get("breach_resolved"), True, True,
                  last.get("breach_resolved") is True)
            quiet = last.get("healthy_transitions")
            check("slo/alarm_healthy_quiet", last_path, quiet, 0, 0,
                  quiet == 0)
        # Autotuner artifacts (bench.py --tune): ABSOLUTE gates on the
        # latest round — the traced-knob grid sweep at least matches
        # the static recompile-per-config counterfactual
        # (``batch_speedup_ratio`` >= 1.0), at least
        # two named tuned profiles shipped, every profile
        # Pareto-non-dominated by the reference default over the
        # recorded objectives (dominance RECOMPUTED here from the
        # payload's SLO rows, not trusted from the writer's flag) and
        # fuzz-oracle green on its held-out seeds.  Smoke sweeps are
        # provenance unless the walk holds only smoke rounds (the
        # sync-heal fallback rule: `--tune --smoke`'s in-bench check
        # of its own fresh artifact still bites).
        tn_all = [(p, pl) for p, pl in entries
                  if "batch_speedup_ratio" in pl and "profiles" in pl]
        tn = [(p, pl) for p, pl in tn_all
              if not pl.get("smoke")] or tn_all
        if tn is not tn_all:
            for p, pl in tn_all:
                if pl.get("smoke"):
                    rows.append({
                        "check": "slo/tune_pareto", "source":
                        os.path.basename(p), "ok": None,
                        "note": "smoke tune sweep — different scale, "
                                "not a trajectory datum",
                    })
        if tn:
            last_path, last = tn[-1]
            ratio = last.get("batch_speedup_ratio")
            check("slo/tune_batch_speedup", last_path, ratio, 1.0, 1.0,
                  isinstance(ratio, (int, float)) and ratio >= 1.0)
            profs = last.get("profiles") or {}
            check("slo/tune_profiles_shipped", last_path,
                  sorted(profs), ">= 2 named profiles", 2,
                  len(profs) >= 2)
            objs = last.get("objectives") or []
            ref = last.get("reference_slos") or {}
            nondom = {}
            for name, prof in sorted(profs.items()):
                slos = prof.get("slos") or {}
                complete = bool(objs) and all(
                    isinstance(ref.get(o), (int, float))
                    and isinstance(slos.get(o), (int, float))
                    for o in objs)
                ref_dominates = complete and all(
                    ref[o] <= slos[o] for o in objs) and any(
                    ref[o] < slos[o] for o in objs)
                nondom[name] = complete and not ref_dominates
            check("slo/tune_profiles_nondominated", last_path, nondom,
                  True, True, bool(nondom) and all(nondom.values()))
            fuzz = {name: prof.get("fuzz_green")
                    for name, prof in sorted(profs.items())}
            check("slo/tune_profiles_fuzz_green", last_path, fuzz,
                  True, True,
                  bool(fuzz) and all(v is True for v in fuzz.values()))
        # Soak artifacts (bench.py --soak): the production soak's drift
        # invariants.  ABSOLUTE gates on the latest round — every one
        # of these is a "never" claim, not a trajectory: a single
        # monitor violation, one recompile after segment 1, or one
        # byte of journal divergence under SIGKILL is a regression at
        # any scale.  Smoke soaks are provenance unless the walk holds
        # only smoke rounds (the sync-heal fallback rule: `--soak
        # --smoke`'s in-bench check of its own fresh artifact still
        # bites).
        sk_all = [(p, pl) for p, pl in entries
                  if "rounds_survived" in pl and "drift" in pl]
        sk = [(p, pl) for p, pl in sk_all
              if not pl.get("smoke")] or sk_all
        if sk is not sk_all:
            for p, pl in sk_all:
                if pl.get("smoke"):
                    rows.append({
                        "check": "slo/soak", "source":
                        os.path.basename(p), "ok": None,
                        "note": "smoke soak — different scale, "
                                "not a trajectory datum",
                    })
        if sk:
            last_path, last = sk[-1]
            drift = last.get("drift") or {}
            viol = drift.get("violations")
            check("slo/soak_violations", last_path, viol, 0, 0,
                  viol == 0)
            sizes = drift.get("cache_sizes")
            check("slo/soak_compile_flat", last_path, sizes,
                  "one program, every segment", True,
                  drift.get("compile_flat") is True
                  and isinstance(sizes, list) and len(sizes) >= 1)
            check("slo/soak_rss_bounded", last_path,
                  drift.get("rss_growth_mb"),
                  "bounded growth", True,
                  drift.get("rss_bounded") is True)
            drill = last.get("kill_drill") or {}
            check("slo/soak_kill_exactly_once", last_path,
                  {k: drill.get(k) for k in
                   ("ok", "journal_match", "state_match")},
                  True, True,
                  drill.get("ok") is True
                  and drill.get("journal_match") is True
                  and drill.get("state_match") is True)
            alarms = last.get("alarms") or {}
            check("slo/soak_alarms_quiet", last_path,
                  alarms.get("transitions"), 0, 0,
                  alarms.get("quiet") is True
                  and alarms.get("transitions") == 0)
        # Blame-drill artifacts (bench.py --blame): the provenance
        # plane's measured attribution claims, gated ABSOLUTELY on the
        # latest round (docstring bullet).  Smoke drills are provenance
        # unless the walk holds only smoke rounds (the sync-heal
        # fallback rule).
        bl_all = [(p, pl) for p, pl in entries
                  if "blame_origin_correct" in pl]
        bl = [(p, pl) for p, pl in bl_all
              if not pl.get("smoke")] or bl_all
        if bl is not bl_all:
            for p, pl in bl_all:
                if pl.get("smoke"):
                    rows.append({
                        "check": "slo/blame_drill", "source":
                        os.path.basename(p), "ok": None,
                        "note": "smoke blame drill — different scale, "
                                "not a trajectory datum",
                    })
        if bl:
            last_path, last = bl[-1]
            check("slo/blame_origin_correct", last_path,
                  last.get("blame_origin_correct"), True, True,
                  last.get("blame_origin_correct") is True)
            attr = last.get("attribution") or {}
            frac = attr.get("total_fraction")
            check("slo/provenance_attribution_total", last_path, frac,
                  1.0, 1.0,
                  isinstance(frac, (int, float))
                  and math.isfinite(frac) and abs(frac - 1.0) < 1e-9)
            check("slo/provenance_dropped", last_path,
                  attr.get("dropped"), 0, 0, attr.get("dropped") == 0)
            check("slo/trace_dropped_total", last_path,
                  last.get("trace_dropped_total"), 0, 0,
                  last.get("trace_dropped_total") == 0)
            check("slo/provenance_off_switch_identical", last_path,
                  last.get("off_switch_identical"), True, True,
                  last.get("off_switch_identical") is True)
            ratio = last.get("provenance_overhead_ratio")
            check("slo/provenance_overhead_ratio", last_path, ratio,
                  1.0, PROVENANCE_OVERHEAD_LIMIT,
                  isinstance(ratio, (int, float))
                  and math.isfinite(ratio)
                  and ratio <= PROVENANCE_OVERHEAD_LIMIT)
            ex = last.get("explain_check") or {}
            check("slo/provenance_explain_resolved", last_path,
                  {k: ex.get(k) for k in
                   ("resolved", "channel_correct", "round_correct")},
                  True, True,
                  ex.get("resolved") is True
                  and ex.get("channel_correct") is True
                  and ex.get("round_correct") is True)
    return ok, rows


def expand_paths(patterns: Sequence[str]) -> List[str]:
    """Globs + literal paths -> sorted unique file list."""
    out: List[str] = []
    for pat in patterns:
        matches = sorted(globlib.glob(pat))
        out.extend(matches if matches else [pat])
    seen, uniq = set(), []
    for p in out:
        if p not in seen:
            seen.add(p)
            uniq.append(p)
    return uniq
