"""The typed membership event schema of the trace.

Counterpart of ``scalecube_cluster_tpu/telemetry/events.py``.  The
round cannot call a listener per event, so the trace speaks one numeric
schema:

    (round, observer, subject, event_type, incarnation)

  - ``round``       protocol round of the transition;
  - ``observer``    node index whose membership table transitioned;
  - ``subject``     node index the record is about;
  - ``event_type``  :class:`TraceEventType`, the table transitions that
                    cover the reference protocol's event surface;
  - ``incarnation`` incarnation of the accepted record.

Event types:

  - ``ADDED``          a null or tombstone entry accepted an ALIVE record;
  - ``SUSPECTED``      the entry turned SUSPECT (FD verdict or gossip);
  - ``ALIVE_REFUTED``  a SUSPECT entry was overridden by a
                       higher-incarnation ALIVE;
  - ``REMOVED``        the entry accepted DEAD (suspicion timeout, leave
                       notice or gossiped tombstone);
  - ``LEAVING``        the observer announced its own graceful leave
                       (DEAD at incarnation + 1); observer == subject;
  - ``JOINED``         the open-world admission: the cell's identity
                       epoch advanced to a live record.

Rounds are stochastic, so cross-layer comparisons use the timing-free
:meth:`MembershipTraceEvent.key` (:func:`event_key_set`).  The round
emits the net transition of a cell per round.  Pure Python.  The
reference's ``OracleTraceCollector`` watches its event-driven oracle,
which the port does not carry, so it is not here.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterable, Optional, Sequence, Set, Tuple


class TraceEventType(enum.IntEnum):
    """Membership-table transition kinds (int codes are the wire/lane
    values — stable, do not renumber).

    ``JOINED`` is the open-world admission lane
    (models/swim.SwimParams.open_world): the cell's stored identity
    EPOCH advanced to a live record — a NEW member entered a recycled
    slot — where plain ``ADDED`` stays the same-identity (re-)add
    (cold-start discovery, tombstone reopen after partition heal,
    crash-revival).  The reference's listener emits ADDED for both
    (it has real per-identity member ids); consumers diffing against
    the oracle union the two types (chaos/campaign.cross_validate_churn).
    """

    ADDED = 0
    SUSPECTED = 1
    ALIVE_REFUTED = 2
    REMOVED = 3
    LEAVING = 4
    JOINED = 5


@dataclasses.dataclass(frozen=True, order=True)
class MembershipTraceEvent:
    """One observed membership-table transition (module docstring)."""

    round: int
    observer: int
    subject: int
    event_type: TraceEventType
    incarnation: int

    def key(self) -> Tuple[int, int, int, int]:
        """Timing-free identity for cross-layer diffs: (observer,
        subject, type, incarnation)."""
        return (self.observer, self.subject, int(self.event_type),
                self.incarnation)

    def to_json(self) -> dict:
        return {
            "round": self.round,
            "observer": self.observer,
            "subject": self.subject,
            "event_type": self.event_type.name,
            "incarnation": self.incarnation,
        }

    @staticmethod
    def from_json(obj: dict) -> "MembershipTraceEvent":
        return MembershipTraceEvent(
            round=int(obj["round"]),
            observer=int(obj["observer"]),
            subject=int(obj["subject"]),
            event_type=TraceEventType[obj["event_type"]],
            incarnation=int(obj["incarnation"]),
        )


def event_key_set(
    events: Iterable[MembershipTraceEvent],
    types: Optional[Sequence[TraceEventType]] = None,
    subjects: Optional[Sequence[int]] = None,
    observers: Optional[Sequence[int]] = None,
    min_round: Optional[int] = None,
) -> Set[Tuple[int, int, int, int]]:
    """Timing-free key set of a filtered event stream — the diffable form.

    Two layers running the same scenario agree on WHICH transitions
    happened (the key set) even though the rounds they happen in are
    stochastic; ``set_a == set_b`` is the parity assertion
    (tests/test_telemetry_trace.py).
    """
    types_s = None if types is None else {TraceEventType(t) for t in types}
    subj_s = None if subjects is None else set(subjects)
    obs_s = None if observers is None else set(observers)
    out = set()
    for e in events:
        if types_s is not None and e.event_type not in types_s:
            continue
        if subj_s is not None and e.subject not in subj_s:
            continue
        if obs_s is not None and e.observer not in obs_s:
            continue
        if min_round is not None and e.round < min_round:
            continue
        out.add(e.key())
    return out


def diff_event_streams(a, b, **filters):
    """(only_in_a, only_in_b) timing-free key sets — the two sides of a
    model-vs-oracle trace diff.  Empty/empty means parity."""
    ka, kb = event_key_set(a, **filters), event_key_set(b, **filters)
    return ka - kb, kb - ka
