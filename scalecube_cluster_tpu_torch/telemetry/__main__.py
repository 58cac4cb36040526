"""The telemetry CLI: ``python -m scalecube_cluster_tpu_torch.telemetry``.

Counterpart of ``python -m scalecube_cluster_tpu.telemetry``, with the
same five subcommands, arguments, output and exit codes, over the JSONL
manifests and BENCH artifacts (telemetry/query.py, telemetry/alarms.py):

  report   <manifest.jsonl> [...]   fold manifests, print the health
                                    SLO table (``--json`` for machines,
                                    ``--windows`` for the per-window
                                    time series)
  diff     <a.jsonl> <b.jsonl>      per-SLO/counter/gauge comparison
                                    of two runs
  watch    <journal.jsonl>          live-tail a journal another process
                                    is writing (sink.follow_records —
                                    never re-reads consumed bytes) and
                                    render a refreshing alarm/SLO
                                    table; exits when the run's
                                    ``summary`` record lands (or after
                                    ``--max-seconds``); ``--json``
                                    emits one line per consumed window
                                    / transition for machines
  explain  <journal.jsonl>          answer "why did observer i believe
           --observer i --subject j  this about subject j" from the
           [--round r]               journal's provenance records alone
                                    (telemetry/query.explain_belief):
                                    the belief in force, its winning
                                    channel + round, the subject's
                                    blame report and this observer's
                                    infection path
  regress  [paths/globs ...]        walk the BENCH_*.json +
                                    MULTICHIP_*.json trajectories
                                    (the default globs) and exit 1 on
                                    throughput or SLO regressions
                                    beyond ``--band``; legacy stub
                                    rounds skip as provenance

Exit codes: 0 ok, 1 regression detected (regress), 2 usage/input error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence

from scalecube_cluster_tpu_torch.telemetry import query


def _cmd_report(args) -> int:
    reports = [query.load_report(p) for p in args.manifests]
    merged = (query.merge_reports(reports) if len(reports) > 1
              else reports[0])
    slos = query.compute_slos(merged)
    if args.json:
        print(json.dumps({
            "manifests": [r.path for r in reports],
            "slos": slos,
            "counters": merged.counters,
            "gauges": merged.gauges,
            "windows": merged.windows if args.windows else len(merged.windows),
        }))
        return 0
    rows = [{"metric": k, "value": v} for k, v in slos.items()]
    print(f"# health report: {', '.join(r.path for r in reports)}")
    print(query.format_table(rows, ["metric", "value"]))
    if merged.counters:
        print("\n# counters (summed over windows)")
        print(query.format_table(
            [{"metric": k, "value": v}
             for k, v in sorted(merged.counters.items())],
            ["metric", "value"]))
    if args.windows and merged.windows:
        print("\n# per-window")
        wrows = [{
            "window": f"[{w['round_start']}, {w['round_end']})",
            "fp_onsets": w.get("counters", {}).get("false_suspicion_onsets"),
            "suspect": w.get("gauges", {}).get("suspect_entries"),
            "occupancy": w.get("gauges", {}).get(
                "gossip_piggyback_occupancy"),
            "saturation": w.get("gauges", {}).get("wire_saturation"),
        } for w in merged.windows]
        print(query.format_table(
            wrows, ["window", "fp_onsets", "suspect", "occupancy",
                    "saturation"]))
    return 0


def _cmd_diff(args) -> int:
    a = query.load_report(args.a)
    b = query.load_report(args.b)
    rows = query.diff_reports(a, b)
    if args.json:
        print(json.dumps({"a": a.path, "b": b.path, "rows": rows}))
        return 0
    print(f"# diff: a={a.path}  b={b.path}")
    print(query.format_table(rows, ["metric", "a", "b", "delta", "rel"]))
    return 0


def _cmd_watch(args) -> int:
    """Tail a live journal and render the alarm/SLO table.

    Read-only: the watcher runs its OWN alarm engine over the tailed
    ``metrics_window``/``segment`` rows (it never writes to a journal
    it does not own) and shows journaled ``alarm_transition`` rows —
    written by the run itself — as provenance.  The follower consumes
    each durable line exactly once, so across the whole session every
    window is seen once and only once.
    """
    from scalecube_cluster_tpu_torch.telemetry import alarms as talarms
    from scalecube_cluster_tpu_torch.telemetry import sink as tsink

    threshold = (args.threshold if args.threshold is not None
                 else talarms.DEFAULT_FP_THRESHOLD)
    specs = talarms.default_specs(threshold=threshold,
                                  for_windows=args.for_windows,
                                  clear_windows=args.clear_windows)
    engine = talarms.AlarmEngine(specs)
    follower = tsink.follow_records(args.journal)
    deadline = (time.time() + args.max_seconds
                if args.max_seconds is not None else None)
    windows = transitions_seen = journal_transitions = 0
    segments = rounds_covered = 0
    unknown_kinds: dict = {}
    done = False
    while True:
        fresh = follower.poll()
        new_rows = []
        boundaries = []
        for rec in fresh:
            kind = rec.get("kind")
            if kind in talarms.WINDOW_KINDS:
                windows += 1
                # Segment rows are checkpoint boundaries, not just
                # windows: count them so a multi-segment soak tail is
                # distinguishable from a single run (segment index +
                # cumulative rounds surface in the live table).
                if kind == "segment":
                    segments += 1
                    rounds_covered = max(rounds_covered,
                                         int(rec.get("round_end", 0)))
                    boundaries.append(
                        (segments, rec.get("round_start"),
                         rec.get("round_end")))
                caused = engine.observe(rec)
                transitions_seen += len(caused)
                if args.json:
                    row = {
                        "kind": "window", "source": kind,
                        "round_start": rec.get("round_start"),
                        "round_end": rec.get("round_end"),
                        "transitions": caused,
                    }
                    if kind == "segment":
                        row["segment"] = segments
                        row["rounds_cumulative"] = rounds_covered
                    print(json.dumps(row), flush=True)
                else:
                    new_rows.append(rec)
            elif kind == talarms.TRANSITION_KIND:
                journal_transitions += 1
                if args.json:
                    print(json.dumps({"kind": "journal_transition",
                                      **{k: v for k, v in rec.items()
                                         if k != "kind"}}), flush=True)
            elif kind == "summary":
                done = True
            elif kind not in ("manifest",):
                # A record kind this watcher doesn't render (a journal
                # written by a newer schema — e.g. ``provenance`` rows
                # landing on an old reader): count it per kind so new
                # kinds degrade LOUDLY, never silently.
                kind = kind or "<missing>"
                first_sight = kind not in unknown_kinds
                unknown_kinds[kind] = unknown_kinds.get(kind, 0) + 1
                if first_sight and args.json:
                    print(json.dumps({
                        "kind": "unknown_record_kind",
                        "record_kind": kind,
                        "note": "journal kind this watcher does not "
                                "render — counted in watch_summary",
                    }), flush=True)
        if fresh and not args.json:
            header = f"\n# watch {args.journal}: {windows} window(s)"
            if segments:
                header += (f", segment {segments} · "
                           f"{rounds_covered} round(s)")
            print(header + f", cursor at byte {follower.offset}")
            for seg, start, end in boundaries:
                print(f"# segment {seg} boundary: rounds "
                      f"[{start}, {end}) · {end} cumulative")
            print(query.format_table(
                engine.state_rows(),
                ["alarm", "state", "value", "threshold", "comparator",
                 "fired", "resolved"]))
            if journal_transitions:
                print(f"({journal_transitions} alarm_transition row(s) "
                      f"journaled by the run itself)")
            if unknown_kinds:
                print("(unrendered record kinds: "
                      + ", ".join(f"{k}×{c}" for k, c
                                  in sorted(unknown_kinds.items()))
                      + ")")
            sys.stdout.flush()
        if done or (deadline is not None and time.time() >= deadline):
            break
        time.sleep(args.interval)
    digest = {
        "kind": "watch_summary", "journal": args.journal,
        "windows": windows, "engine_transitions": transitions_seen,
        "journal_transitions": journal_transitions,
        "segments": segments, "rounds_covered": rounds_covered,
        "unknown_kinds": unknown_kinds,
        "run_ended": done,
        "alarms": engine.state_rows(),
    }
    if args.json:
        print(json.dumps(digest), flush=True)
    else:
        print(f"# watch done: run {'ended' if done else 'still live'}, "
              f"{windows} window(s), {transitions_seen} transition(s)")
    return 0


def _cmd_explain(args) -> int:
    """Answer "why did i believe j was dead" from the journal alone."""
    report = query.load_report(args.journal)
    if not report.provenance:
        print(f"error: {args.journal} holds no provenance records — "
              f"run with SwimParams.provenance=True and journal the "
              f"plane (sink.write_provenance)", file=sys.stderr)
        return 2
    result = query.explain_belief(report.provenance, args.observer,
                                  args.subject, round_idx=args.round)
    if args.json:
        print(json.dumps(result))
        return 0
    obs, subj = args.observer, args.subject
    when = f" at round {args.round}" if args.round is not None else ""
    print(f"# explain: observer {obs} about subject {subj}{when} "
          f"({args.journal})")
    ans = result["answer"]
    if ans is None:
        print(f"observer {obs} recorded no transition for subject "
              f"{subj}{when} — no belief to explain")
    else:
        print(f"observer {obs} believed {ans['transition']} at round "
              f"{ans['round']} via {ans['channel']} "
              f"(epoch {ans['epoch']})")
    if result["events"]:
        print("\n# full (observer, subject) attribution history")
        print(query.format_table(
            result["events"],
            ["round", "transition", "channel", "epoch"]))
    blame = result["context"]["blame"]
    print(f"\n# blame report for subject {subj}")
    print(query.format_table(
        [{"field": k, "value": v} for k, v in blame.items()],
        ["field", "value"]))
    path = result["context"]["infection_path"]
    if path:
        print(f"\n# observer {obs}'s infection path for subject {subj}: "
              f"first informed round {path['first_round']} via "
              f"{path['first_channel']} ({path['first_transition']}); "
              f"per-channel first rounds: "
              + ", ".join(f"{c}@{r}" for c, r
                          in sorted(path["channels"].items())))
    return 0


def _cmd_regress(args) -> int:
    paths = query.expand_paths(
        args.paths
        or ["BENCH_*.json", "MULTICHIP_*.json",
            os.path.join("artifacts", "sync_heal*.json"),
            os.path.join("artifacts", "lifeguard_fp*.json"),
            os.path.join("artifacts", "churn_growth*.json"),
            os.path.join("artifacts", "fuzz_campaign*.json"),
            os.path.join("artifacts", "wire_fused*.json"),
            os.path.join("artifacts", "compose_perf*.json"),
            os.path.join("artifacts", "static_analysis*.json"),
            os.path.join("artifacts", "alarm_drill*.json"),
            os.path.join("artifacts", "tune_pareto*.json"),
            os.path.join("artifacts", "soak_report*.json"),
            os.path.join("artifacts", "config_rollout*.json"),
            os.path.join("artifacts", "provenance_blame*.json")])
    readable = [p for p in paths if os.path.exists(p)]
    if not readable:
        print("regress: no artifacts matched", file=sys.stderr)
        return 2
    ok, rows = query.regress(readable, band=args.band)
    if args.json:
        print(json.dumps({"ok": ok, "band": args.band, "checks": rows}))
    else:
        print(f"# regress over {len(readable)} artifacts "
              f"(noise band {args.band:.0%})")
        print(query.format_table(
            rows, ["check", "source", "latest", "reference", "threshold",
                   "ok", "note"]))
        print("PASS" if ok else "REGRESSION")
    return 0 if ok else 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m scalecube_cluster_tpu_torch.telemetry",
        description=__doc__.splitlines()[0],
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("report", help="health SLO report of manifest(s)")
    p.add_argument("manifests", nargs="+")
    p.add_argument("--json", action="store_true")
    p.add_argument("--windows", action="store_true",
                   help="include the per-window time series")
    p.set_defaults(fn=_cmd_report)

    p = sub.add_parser("diff", help="compare two run manifests")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_diff)

    p = sub.add_parser(
        "watch",
        help="live-tail a journal: refreshing alarm/SLO table "
             "(exits on the run's summary record)")
    p.add_argument("journal")
    p.add_argument("--interval", type=float, default=0.5,
                   help="poll interval, seconds (default 0.5)")
    p.add_argument("--max-seconds", type=float, default=None,
                   help="stop after this many seconds even if the run "
                        "is still live (default: wait for the summary "
                        "record)")
    p.add_argument("--threshold", type=float, default=None,
                   help="false_positive_observer_rate breach threshold "
                        "(default: telemetry.alarms"
                        ".DEFAULT_FP_THRESHOLD)")
    p.add_argument("--for-windows", type=int, default=1,
                   help="consecutive breached windows before firing")
    p.add_argument("--clear-windows", type=int, default=1,
                   help="consecutive clear windows before resolving")
    p.add_argument("--json", action="store_true",
                   help="one JSON line per consumed window/transition "
                        "+ a closing watch_summary line")
    p.set_defaults(fn=_cmd_watch)

    p = sub.add_parser(
        "explain",
        help="why did observer i believe this about subject j — from "
             "the journal's provenance records alone")
    p.add_argument("journal")
    p.add_argument("--observer", type=int, required=True,
                   help="observer node id (who held the belief)")
    p.add_argument("--subject", type=int, required=True,
                   help="subject node id (whom the belief was about)")
    p.add_argument("--round", type=int, default=None,
                   help="explain the belief in force at this round "
                        "(default: the latest recorded transition)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_explain)

    p = sub.add_parser(
        "regress",
        help="fail on regressions along the BENCH/MULTICHIP trajectories")
    p.add_argument("paths", nargs="*",
                   help="artifact files/globs (default: BENCH_*.json "
                        "MULTICHIP_*.json artifacts/sync_heal*.json "
                        "artifacts/lifeguard_fp*.json "
                        "artifacts/churn_growth*.json "
                        "artifacts/fuzz_campaign*.json "
                        "artifacts/wire_fused*.json "
                        "artifacts/compose_perf*.json "
                        "artifacts/static_analysis*.json "
                        "artifacts/alarm_drill*.json "
                        "artifacts/tune_pareto*.json "
                        "artifacts/soak_report*.json "
                        "artifacts/config_rollout*.json "
                        "artifacts/provenance_blame*.json)")
    p.add_argument("--band", type=float, default=query.DEFAULT_NOISE_BAND,
                   help="relative noise band (default 0.10)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_regress)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except (OSError, ValueError, KeyError) as e:
        # KeyError: a malformed manifest record (e.g. a histogram row a
        # foreign writer truncated) — input error (2), not regression (1).
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
