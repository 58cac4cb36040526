"""Live SLO alarms: streaming breach detection over a running journal.

Counterpart of ``scalecube_cluster_tpu/telemetry/alarms.py``, pure host
Python over plain-dict journal records, so it imports no other module of
the port.

``telemetry/query.py`` is post-hoc: SLOs and regress verdicts computed
from committed artifacts after a run has ended.  This module is the live
half: a declarative :class:`AlarmSpec` registry evaluated incrementally
over the streaming ``metrics_window`` / supervisor ``segment`` rows a
running cluster emits, each alarm a pending -> firing -> resolved state
machine with debounce and clear-side hysteresis.

Every state change is written back to the journal as an
``alarm_transition`` record (through ``TelemetrySink.write_record``), so
a run's alarm history is durable and resumable: transitions are a pure
deterministic function of the window-row sequence, so a relaunched
process replays the journal's rows through a fresh engine, rebuilds the
transitions the dead process would have written, and skips the ones
already durable (:func:`replay_journal` + :func:`write_transitions`, the
per-``round_end`` count dedup).

Record shape::

    {"kind": "alarm_transition", "alarm": <spec name>,
     "from": "ok|pending|firing", "to": "pending|firing|resolved|ok",
     "round_start": int, "round_end": int,   # the triggering window
     "value": float, "threshold": float, "comparator": str,
     "streak": int}

``round_end`` makes the record a citizen of the journal cursor:
``sink.covered_upto(path, kind="alarm_transition")`` works, and the
dedup above is keyed on it.  Consumers: ``telemetry.metrics
.stream_metered_run`` (per-flush-window evaluation) and the live
``watch`` CLI (``python -m scalecube_cluster_tpu_torch.telemetry watch``,
which tails a journal through ``sink.follow_records`` and renders the
table read-only).  Journals written by either package replay in the
other: the record kinds and field names are the reference's.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: Record kinds an engine evaluates as "one window of counters".
WINDOW_KINDS = ("metrics_window", "segment")

#: The journal record kind every transition is written as.
TRANSITION_KIND = "alarm_transition"

#: Alarm states.  ``resolved`` is a TRANSITION, not a resting state —
#: after a resolve the alarm is back at ``ok`` and can fire again.
OK, PENDING, FIRING = "ok", "pending", "firing"
RESOLVED = "resolved"

_COMPARATORS = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}

#: Default breach threshold for the false-positive observer-rate alarm
#: (onsets per live observer-round per window, summed over all
#: suspected targets: under an asymmetric loss pulse one healthy
#: observer cycles onset -> refute -> re-onset against many members at
#: once, so pulse-window rates exceed 1).  The reference's value,
#: calibrated by its ``bench.py --alarms`` drill (n=48, pulse_loss=0.6,
#: seeds 7/11/23): the healthy arm's worst pulse window stays <= 1.35
#: while the weakened-knobs breach arm's (``chaos.alarm_breach_knobs``)
#: never drops under 1.70 during the pulse, and both arms are 0 outside
#: it (``artifacts/alarm_drill.json``).  The smoke geometry (n=24) runs
#: lower rates and passes its own threshold (``bench.py``
#: ``SMOKE_ALARM_THRESHOLD``, 1.18).
DEFAULT_FP_THRESHOLD = 1.5


@dataclasses.dataclass(frozen=True)
class AlarmSpec:
    """One declarative alarm over a windowed counter ratio.

    ``numerator`` is a counter lane name; ``denominator`` is a counter
    lane, the literal ``"rounds"`` (the window's round count — the
    per-round-rate fallback for record kinds that don't carry the SLO's
    denominator lane, e.g. supervisor ``segment`` counter rows), or
    None for a raw windowed sum.  The value compared against
    ``threshold`` is ``sum(numerator) / sum(denominator)`` over the
    last ``window`` rows (a SLIDING window in metrics windows, not
    rounds).

    ``for_windows`` is the firing debounce: the alarm goes ``pending``
    on the first breached evaluation and ``firing`` only after that
    many CONSECUTIVE breaches (``for_windows <= 1`` fires immediately).
    ``clear_windows`` is the resolve-side hysteresis: a firing alarm
    resolves only after that many consecutive clear evaluations — a
    single healthy window inside an incident must not flap the alarm.

    A window whose denominator sums to zero (or whose lanes are absent
    from the record entirely) is NOT an evaluation: streaks and state
    are untouched — absence of signal is not health.
    """

    name: str
    numerator: str
    denominator: Optional[str] = None
    comparator: str = ">"
    threshold: float = 0.0
    window: int = 1
    for_windows: int = 1
    clear_windows: int = 1

    def __post_init__(self):
        if self.comparator not in _COMPARATORS:
            raise ValueError(
                f"alarm {self.name!r}: comparator {self.comparator!r} "
                f"not in {sorted(_COMPARATORS)}")
        for field in ("window", "for_windows", "clear_windows"):
            if getattr(self, field) < 1:
                raise ValueError(
                    f"alarm {self.name!r}: {field} must be >= 1 "
                    f"(got {getattr(self, field)})")

    def breached(self, value: float) -> bool:
        return _COMPARATORS[self.comparator](value, self.threshold)


def default_specs(threshold: float = DEFAULT_FP_THRESHOLD,
                  for_windows: int = 1,
                  clear_windows: int = 1) -> Tuple[AlarmSpec, ...]:
    """The default registry: the paper's headline bounded-false-positive
    guarantee as a live alarm — false-suspicion onsets per live
    observer-round (the ``false_positive_observer_rate`` SLO), evaluated
    per flush window."""
    return (AlarmSpec(
        name="false_positive_observer_rate",
        numerator="false_suspicion_onsets",
        denominator="live_observer_rounds",
        comparator=">", threshold=threshold,
        window=1, for_windows=for_windows, clear_windows=clear_windows,
    ),)


def _window_counters(rec: dict) -> Tuple[dict, int]:
    """(counter dict, rounds) of one window-ish record.

    Both ``metrics_window`` rows and supervisor ``segment`` rows nest
    their lanes under ``counters`` (the registry flush vs. the
    counters_row digest) and carry ``round_start``/``round_end``; the
    round span is the ``"rounds"`` denominator.
    """
    counters = rec.get("counters") or {}
    rounds = int(rec.get("round_end", 0)) - int(rec.get("round_start", 0))
    return counters, max(rounds, 0)


@dataclasses.dataclass
class _AlarmState:
    state: str = OK
    breach_streak: int = 0
    clear_streak: int = 0
    last_value: Optional[float] = None
    fired: int = 0                 # lifetime count of firing transitions
    resolved: int = 0


class AlarmEngine:
    """Incremental evaluator: feed journal records, get transitions.

    Deterministic by construction — state is a pure fold over the
    window-row sequence, specs are evaluated in registry order and each
    spec changes state at most once per row, so the transition list for
    any row prefix is reproducible across processes.  That determinism
    is what makes the replay/dedup resume protocol exactly-once
    (module docstring).

    The engine never writes; callers pair :meth:`observe` with
    :func:`write_transitions` (or just read the states for rendering —
    the ``watch`` CLI's read-only mode).
    """

    def __init__(self, specs: Sequence[AlarmSpec],
                 kinds: Sequence[str] = WINDOW_KINDS):
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate alarm names: {names}")
        self.specs = tuple(specs)
        self.kinds = tuple(kinds)
        self._states: Dict[str, _AlarmState] = {
            s.name: _AlarmState() for s in specs}
        self._history: Dict[str, collections.deque] = {
            s.name: collections.deque(maxlen=s.window) for s in specs}
        self.windows_seen = 0

    # -- state access (the watch table) ------------------------------------

    def state_rows(self) -> List[dict]:
        """One render-ready row per alarm (the watch table's shape)."""
        return [{
            "alarm": s.name,
            "state": st.state,
            "value": st.last_value,
            "threshold": s.threshold,
            "comparator": s.comparator,
            "fired": st.fired,
            "resolved": st.resolved,
        } for s in self.specs for st in (self._states[s.name],)]

    def state_of(self, name: str) -> str:
        return self._states[name].state

    # -- evaluation --------------------------------------------------------

    def observe(self, rec: dict) -> List[dict]:
        """Feed one journal record; returns the (possibly empty) list
        of transition payloads it caused, in deterministic spec order.
        Non-window kinds are ignored, so a whole record stream can be
        piped through unsorted."""
        if rec.get("kind") not in self.kinds:
            return []
        counters, rounds = _window_counters(rec)
        self.windows_seen += 1
        out: List[dict] = []
        for spec in self.specs:
            t = self._observe_one(spec, counters, rounds, rec)
            if t is not None:
                out.append(t)
        return out

    def _observe_one(self, spec: AlarmSpec, counters: dict, rounds: int,
                     rec: dict) -> Optional[dict]:
        if spec.numerator not in counters:
            return None                      # lane absent: no evaluation
        num = float(counters[spec.numerator])
        if spec.denominator == "rounds":
            den: Optional[float] = float(rounds)
        elif spec.denominator is not None:
            if spec.denominator not in counters:
                return None
            den = float(counters[spec.denominator])
        else:
            den = None
        hist = self._history[spec.name]
        hist.append((num, den))
        num_sum = sum(n for n, _ in hist)
        if den is None:
            value = num_sum
        else:
            den_sum = sum(d for _, d in hist)
            if den_sum <= 0:
                return None                  # zero denominator: no signal
            value = num_sum / den_sum
        st = self._states[spec.name]
        st.last_value = value
        return self._step(spec, st, spec.breached(value), value, rec)

    def _step(self, spec: AlarmSpec, st: _AlarmState, breached: bool,
              value: float, rec: dict) -> Optional[dict]:
        prev = st.state
        to: Optional[str] = None
        if breached:
            st.clear_streak = 0
            st.breach_streak += 1
            if prev in (OK,) and st.breach_streak >= spec.for_windows:
                st.state, to = FIRING, FIRING
                st.fired += 1
            elif prev == OK:
                st.state, to = PENDING, PENDING
            elif prev == PENDING and st.breach_streak >= spec.for_windows:
                st.state, to = FIRING, FIRING
                st.fired += 1
        else:
            st.breach_streak = 0
            if prev == PENDING:
                # Breach gone before the debounce matured: the pending
                # alarm cancels back to ok — recorded (it is a state
                # change an operator watching the table saw happen).
                st.state, to = OK, OK
            elif prev == FIRING:
                st.clear_streak += 1
                if st.clear_streak >= spec.clear_windows:
                    st.state, to = OK, RESOLVED
                    st.resolved += 1
        if to is None:
            return None
        return {
            "alarm": spec.name,
            "from": prev,
            "to": to,
            "round_start": int(rec.get("round_start", 0)),
            "round_end": int(rec.get("round_end", 0)),
            "value": round(float(value), 8),
            "threshold": spec.threshold,
            "comparator": spec.comparator,
            "streak": (st.breach_streak if breached else st.clear_streak),
        }


# --------------------------------------------------------------------------
# Resume: replay + exactly-once dedup
# --------------------------------------------------------------------------


def replay_journal(engine: AlarmEngine, records: Iterable[dict],
                   ) -> Tuple[List[dict], "collections.Counter"]:
    """Rebuild ``engine`` from an existing record stream (journal
    order), returning ``(transitions, existing)``:

    - ``transitions``: everything the engine would have emitted for the
      replayed rows — a superset of what the dead process durably wrote
      when it was killed mid-transition;
    - ``existing``: a per-``round_end`` count of ``alarm_transition``
      records already durable in the stream.

    Feed both to :func:`write_transitions`: the count dedup writes
    exactly the missing tail (transition emission order per window is
    deterministic — :class:`AlarmEngine` docstring), extending the
    journal's exactly-once guarantee to alarms across any kill/relaunch
    sequence.  One scan, no re-parsing: pass a
    :class:`~scalecube_cluster_tpu_torch.telemetry.sink.JournalFollower`'s
    ``poll()`` output (or ``iter_records``) — the same pass that feeds
    the supervisor's ``covered_upto`` rebase.
    """
    transitions: List[dict] = []
    existing: collections.Counter = collections.Counter()
    for rec in records:
        if rec.get("kind") == TRANSITION_KIND:
            existing[int(rec.get("round_end", 0))] += 1
        else:
            transitions.extend(engine.observe(rec))
    return transitions, existing


def write_transitions(sink, transitions: Sequence[dict],
                      existing: Optional["collections.Counter"] = None,
                      ) -> List[dict]:
    """Write ``transitions`` through ``sink`` as ``alarm_transition``
    records, skipping the first ``existing[round_end]`` transitions of
    each ``round_end`` (already durable — the replay dedup).  Returns
    the records actually written.  Mutates ``existing`` (counts are
    consumed), so one counter threads through replay + the live loop.
    """
    written: List[dict] = []
    for t in transitions:
        if existing is not None:
            end = int(t.get("round_end", 0))
            if existing[end] > 0:
                existing[end] -= 1
                continue
        sink.write_record(TRANSITION_KIND, dict(t))
        written.append(t)
    return written
