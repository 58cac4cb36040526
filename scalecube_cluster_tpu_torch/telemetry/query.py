"""The blame engine: infection paths, channel-mix SLOs and ``explain``
over the provenance plane's attribution rows.

Counterpart of the blame-engine part of
``scalecube_cluster_tpu/telemetry/query.py`` (:306-480, with
``PROVENANCE_OVERHEAD_LIMIT`` :54 and the constants it needs).  It is
pure host Python over plain-dict rows (``models/provenance
.decode_attributions``, or the rows of a journal's ``provenance``
records, ``telemetry/sink.read_provenance``), so a run on the card can be
judged without JAX.  The rest of the reference's module (manifest
loading and merging, the health SLOs, ``diff_reports``, ``regress``)
stays to port with the host layers (ROADMAP A10); the reference's
``query.load_report`` reads a port journal meanwhile.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

# The provenance plane's overhead ceiling in the reference's bench
# (armed stack over the same stack without the plane, interleaved on one
# host).
PROVENANCE_OVERHEAD_LIMIT = 1.10

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
