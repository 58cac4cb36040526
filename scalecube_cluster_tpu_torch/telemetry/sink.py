"""Host-side telemetry: JSONL run journals, their readers, the
segmented traced runner, and the gated TensorBoard export.

Counterpart of ``scalecube_cluster_tpu/telemetry/sink.py``.  One JSONL
file per run:

    line 1: {"kind": "manifest", run id, schema, config digest, device
             info, caller metadata}
    then:   {"kind": "counters", ...}        per-chunk counter digests
            {"kind": "histogram", ...}       named bucket histograms
            {"kind": "events", ...}          batches of trace events
            {"kind": "curve", ...}           per-round series
            {"kind": "metrics_window", ...}  health-registry windows
            {"kind": "provenance", ...}      channel-attribution rows
            {"kind": "summary", ...}         closing totals

plus any kind through :meth:`TelemetrySink.write_record`.  The records
are the reference's, byte for byte in their JSON payloads, so the
reference's readers read a port journal and the port's read the
reference's.  A record is durable once its line ends in a newline: the
writer flushes each record, :func:`iter_records` skips a torn trailing
line, and an append-mode sink truncates one before writing
(``_heal_torn_tail``); ``round_end`` makes a record resumable through
:func:`covered_upto` and :class:`JournalFollower`.

Sink directory: an explicit argument, else ``SCALECUBE_TPU_TELEMETRY_DIR``,
else the caller's default.  The TensorBoard export runs only when
``SCALECUBE_TPU_PROFILE_DIR`` is set and gives None when no writer
package (``tensorboardX``) is importable.

:func:`stream_traced_run` drives ``run_traced`` in segments, each
segment's offload to the host overlapped with the next one's rounds.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from scalecube_cluster_tpu_torch.telemetry.events import (
    MembershipTraceEvent,
    TraceEventType,
)

SCHEMA_VERSION = 1
TELEMETRY_DIR_ENV = "SCALECUBE_TPU_TELEMETRY_DIR"
PROFILE_DIR_ENV = "SCALECUBE_TPU_PROFILE_DIR"
# Segment length (in protocol rounds) of the overlapped trace offload
# (stream_traced_run); override with this env var.
TRACE_SEGMENT_ENV = "SCALECUBE_TPU_TRACE_SEGMENT_ROUNDS"
DEFAULT_SEGMENT_ROUNDS = 256

# Counter names digested into a counters row (the same families
# utils/runlog.log_metrics_summary prints; per-subject [rounds, K]
# traces sum over subjects).
_COUNTER_NAMES = (
    "messages_gossip", "messages_ping", "messages_ping_sent",
    "messages_ping_req_sent", "refutations", "false_positives",
    "false_suspicion_onsets", "false_suspect_rounds", "stale_view_rounds",
)


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def new_run_id(prefix: str = "run") -> str:
    stamp = time.strftime("%Y%m%d-%H%M%S")
    return f"{prefix}-{stamp}-{os.urandom(3).hex()}"


def config_digest(params) -> str:
    """Stable 12-hex digest of a run configuration.

    Accepts a dataclass (SwimParams, ClusterConfig, ...) or a plain
    dict; same knobs -> same digest across processes, so manifests from
    different runs of one configuration are groupable.
    """
    if dataclasses.is_dataclass(params) and not isinstance(params, type):
        obj = dataclasses.asdict(params)
    elif isinstance(params, dict):
        obj = params
    else:
        obj = {"repr": repr(params)}
    blob = json.dumps(obj, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


def device_info() -> dict:
    """Backend and device census, robust to a backend that cannot start:
    ``torch.cuda`` when a card is visible, else the CPU."""
    try:
        if torch.cuda.is_available():
            return {
                "backend": "cuda",
                "device_count": torch.cuda.device_count(),
                "device_kind": torch.cuda.get_device_name(0),
            }
        return {"backend": "cpu", "device_count": 1, "device_kind": "cpu"}
    except Exception as e:  # noqa: BLE001 — telemetry must not kill a run
        return {"backend": "unavailable", "error": f"{type(e).__name__}: {e}"}


# Keys counters_row has already warned about (warn ONCE per key per
# process — a non-numeric lane repeats every flush window, and one
# warning per window would bury the signal it exists to raise).
_WARNED_NON_NUMERIC: set = set()


def counters_row(metrics: dict, round_offset: int = 0,
                 label: Optional[str] = None) -> dict:
    """Digest one chunk of per-round metric traces into a counters row.

    The input is a dict of [n_rounds, ...] traces from models/swim.run
    (tensors on any device, or arrays).  Scalar-trace counters
    are summed over the chunk; per-subject traces sum over subjects too.
    An empty metrics dict produces an empty (but valid) row.

    A counter lane whose values are NOT summable numbers (an object
    array, strings, a malformed registry flush) is skipped from the row
    — but never silently: the first time each key fails it warns, so a
    registry or writer schema drift can't quietly lose a lane forever.
    """
    row: dict = {"label": label, "round_offset": round_offset}
    n_rounds = 0
    for v in metrics.values():
        n_rounds = int(_host(v).shape[0])
        break
    row["n_rounds"] = n_rounds
    for name in _COUNTER_NAMES:
        if name in metrics:
            try:
                v = _host(metrics[name])
                if not (np.issubdtype(v.dtype, np.number)
                        or np.issubdtype(v.dtype, np.bool_)):
                    raise TypeError(f"non-numeric dtype {v.dtype}")
                row[name] = int(v.sum())
            except (TypeError, ValueError) as e:
                if name not in _WARNED_NON_NUMERIC:
                    _WARNED_NON_NUMERIC.add(name)
                    import warnings

                    warnings.warn(
                        f"counters_row: dropping non-numeric metric "
                        f"{name!r} ({e}) — this lane will be missing "
                        f"from counter rows (warned once per key)",
                        stacklevel=2,
                    )
    return row


class TelemetrySink:
    """One JSONL run manifest under a sink directory (module docstring).

    Every record is flushed as it is written, so a SIGKILL loses at most
    the one line being emitted — and :func:`read_records` skips that
    torn trailing line instead of refusing the whole file.

    ``path`` pins the sink to an exact file instead of deriving one
    from (out_dir, run_id); with ``append=True`` an existing file is
    extended rather than truncated — the resilient-runner journal shape
    (resilience/supervisor.py), where a relaunched process must
    continue the SAME file with no holes and no duplicate rounds
    (:func:`covered_upto` is the dedup cursor).
    """

    def __init__(self, out_dir: Optional[str] = None,
                 run_id: Optional[str] = None, prefix: str = "run",
                 path: Optional[str] = None, append: bool = False):
        if path is not None:
            self.path = path
            stem = os.path.splitext(os.path.basename(path))[0]
            self.run_id = run_id or stem
            directory = os.path.dirname(os.path.abspath(path)) or "."
        else:
            if out_dir is None:
                raise ValueError("TelemetrySink needs out_dir or path")
            self.run_id = run_id or new_run_id(prefix)
            directory = out_dir
            self.path = os.path.join(out_dir, f"{self.run_id}.jsonl")
        os.makedirs(directory, exist_ok=True)
        if append:
            self._heal_torn_tail(self.path)
        self._f = open(self.path, "a" if append else "w")
        self._closed = False

    @staticmethod
    def _heal_torn_tail(path: str) -> None:
        """Truncate an unterminated final line before appending.

        A record is durable iff its line is newline-terminated (writes
        are flushed per record); a file ending mid-line means the
        previous writer was killed mid-write.  Appending after it would
        fuse the torn fragment with the next record into one corrupt
        INTERIOR line — which read_records correctly refuses — so the
        fragment is dropped at reopen instead: it was never durable.
        """
        if not os.path.exists(path) or os.path.getsize(path) == 0:
            return
        with open(path, "rb+") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(-1, os.SEEK_END)
            if f.read(1) == b"\n":
                return
            # Bounded backward scan for the last newline (journals at
            # scale run to GBs — never slurped; only the torn tail is
            # ever in memory, one chunk at a time).
            keep, pos, chunk = 0, size, 1 << 16
            while pos > 0:
                start = max(0, pos - chunk)
                f.seek(start)
                idx = f.read(pos - start).rfind(b"\n")
                if idx != -1:
                    keep = start + idx + 1
                    break
                pos = start
            import warnings

            warnings.warn(
                f"{path}: dropping {size - keep}-byte torn trailing "
                f"record before appending (writer killed mid-line)",
                stacklevel=3,
            )
            f.truncate(keep)

    @staticmethod
    def from_env(default_dir: Optional[str] = None,
                 prefix: str = "run") -> Optional["TelemetrySink"]:
        """Sink in $SCALECUBE_TPU_TELEMETRY_DIR, else ``default_dir``,
        else None (telemetry off)."""
        out_dir = os.environ.get(TELEMETRY_DIR_ENV) or default_dir
        if not out_dir:
            return None
        return TelemetrySink(out_dir, prefix=prefix)

    # -- record writers ----------------------------------------------------

    def _write(self, kind: str, payload: dict) -> None:
        rec = {"kind": kind, "run_id": self.run_id}
        rec.update(payload)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def write_manifest(self, params=None, **extra) -> None:
        self._write("manifest", {
            "schema_version": SCHEMA_VERSION,
            "wall_time": time.time(),
            "config_digest": config_digest(params) if params is not None
            else None,
            "device": device_info(),
            **extra,
        })

    def write_counters(self, metrics: dict, round_offset: int = 0,
                       label: Optional[str] = None) -> None:
        self._write("counters", counters_row(metrics, round_offset, label))

    def write_events(self, events: Iterable[MembershipTraceEvent],
                     dropped: int = 0, batch: int = 1000) -> None:
        """Event batches (chunked so single lines stay parseable-sized);
        ``dropped`` reports the trace buffer's overflow count so a
        truncated trace is never mistaken for a complete one."""
        events = list(events)
        for i in range(0, len(events), batch):
            self._write("events", {
                "offset": i,
                "events": [e.to_json() for e in events[i:i + batch]],
            })
        self._write("events_footer",
                    {"recorded": len(events), "dropped": int(dropped)})

    def write_histogram(self, name: str, edges: Sequence[int],
                        counts: Sequence[int], **meta) -> None:
        self._write("histogram", {
            "name": name,
            "edges": _host(edges).tolist(),
            "counts": _host(counts).tolist(),
            **meta,
        })

    def write_curve(self, name: str, values, round_offset: int = 0,
                    max_points: int = 2048, **meta) -> None:
        """A per-round series (e.g. fraction-informed-by-round),
        stride-downsampled to ``max_points``."""
        v = _host(values)
        stride = max(1, int(np.ceil(v.shape[0] / max_points)))
        idx = list(range(0, v.shape[0], stride))
        # Always keep the terminal sample (a dissemination curve's
        # converged value) even when the stride would skip it.
        if idx and idx[-1] != v.shape[0] - 1:
            idx.append(v.shape[0] - 1)
        self._write("curve", {
            "name": name,
            "round_offset": round_offset,
            "stride": stride,
            "values": v[idx].tolist(),
            **meta,
        })

    def write_summary(self, **fields) -> None:
        self._write("summary", fields)

    def write_metrics_window(self, window: dict) -> None:
        """One health-metrics flush window (telemetry/metrics.py):
        ``{"round_start", "round_end", "counters", "gauges",
        "histograms"}``.  ``round_end`` makes the record resumable
        through the journal cursor — ``covered_upto(path,
        kind="metrics_window")`` is the dedup cursor a relaunched
        metered run consults, exactly the resilient supervisor's
        segment semantics."""
        for key in ("round_start", "round_end"):
            if key not in window:
                raise ValueError(
                    f"metrics_window record needs {key!r} (the journal "
                    f"cursor dedups on round_end)")
        self._write("metrics_window", dict(window))

    def write_provenance(self, payload: dict, batch: int = 2000) -> None:
        """Channel-attribution rows (models/provenance.py's
        ``attributions_payload``) as ``provenance`` records, chunked so
        single lines stay parseable-sized.  EVERY chunk carries the
        buffer accounting (``recorded``/``dropped``/``capacity`` — they
        are totals, idempotent across chunks), so a reader holding any
        one chunk knows whether the stream is complete; a truncated
        attribution stream is never mistaken for a whole one (the
        write_events ``dropped`` discipline)."""
        rows = list(payload.get("rows", []))
        acct = {k: int(payload[k])
                for k in ("recorded", "dropped", "capacity")
                if k in payload}
        if not rows:
            self._write("provenance", {"offset": 0, "rows": [], **acct})
            return
        for i in range(0, len(rows), batch):
            self._write("provenance", {
                "offset": i,
                "rows": rows[i:i + batch],
                **acct,
            })

    def write_record(self, kind: str, payload: dict) -> None:
        """Generic typed row for schema extensions that don't warrant a
        dedicated writer (the chaos verdict rows — module docstring).
        ``payload`` must be JSON-serializable."""
        self._write(kind, payload)

    def close(self) -> None:
        if not self._closed:
            self._f.close()
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# --------------------------------------------------------------------------
# Readers (the round-trip half of the contract)
# --------------------------------------------------------------------------


def iter_records(path: str, kind: Optional[str] = None):
    """Stream the records of a JSONL manifest one at a time.

    A record is durable iff its line is NEWLINE-TERMINATED: the writer
    emits ``json + "\\n"`` per record and flushes, so a SIGKILL landing
    mid-write leaves at most one unterminated trailing line.  That line
    is skipped with a warning — EVEN IF it happens to parse (the kill
    can land between the payload bytes and the newline; counting such a
    record would disagree with the byte-identical truncation
    ``TelemetrySink._heal_torn_tail`` applies at reopen, and a resumed
    writer would then dedup against a record that no longer exists).
    An unparseable newline-terminated line still raises: the per-record
    write discipline cannot produce one, so it is real corruption, not
    a torn write.

    Generator on purpose: journals at scale run to GBs of event
    batches, and consumers that fold over them (covered_upto's running
    max) must not hold every record resident the way
    :func:`read_records`'s list does.
    """
    # One-byte tail probe: is the final line newline-terminated?
    with open(path, "rb") as fb:
        fb.seek(0, os.SEEK_END)
        size = fb.tell()
        terminated = True
        if size:
            fb.seek(-1, os.SEEK_END)
            terminated = fb.read(1) == b"\n"

    def parse(lineno: int, line: str, is_final_payload: bool):
        line = line.strip()
        if is_final_payload and not terminated:
            import warnings

            warnings.warn(
                f"{path}: skipping torn trailing record ({len(line)} "
                f"bytes, no newline) — the writer was killed mid-line",
                stacklevel=4,
            )
            return None
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            raise ValueError(
                f"{path}: unparseable newline-terminated record at "
                f"line {lineno} — interior corruption, not a torn tail"
            ) from e
        if kind is None or rec.get("kind") == kind:
            return rec
        return None

    # Streamed with one payload-line of lookahead: a line is processed
    # once a later payload line proves it is not the file's last.
    with open(path) as f:
        pending = None
        for i, raw in enumerate(f):
            if not raw.strip():
                continue
            if pending is not None:
                rec = parse(pending[0], pending[1], False)
                if rec is not None:
                    yield rec
            pending = (i + 1, raw)
        if pending is not None:
            rec = parse(pending[0], pending[1], True)
            if rec is not None:
                yield rec


def read_records(path: str, kind: Optional[str] = None) -> List[dict]:
    """All (or one ``kind`` of) records in a JSONL manifest, as a list
    (:func:`iter_records` has the durability/torn-tail contract)."""
    return list(iter_records(path, kind=kind))


def covered_upto(path: str, kind: str = "segment") -> int:
    """The journal's round cursor: max ``round_end`` over well-formed
    ``kind`` records, 0 for a missing/empty journal.  Torn trailing
    lines don't count (iter_records skips them) — exactly the
    resume-dedup semantics the resilient supervisor needs: a segment
    whose ``round_end`` <= this cursor is already durably journaled.
    Streams: each record is dropped after its round_end is folded in.
    """
    if not os.path.exists(path):
        return 0
    ends = (int(r["round_end"]) for r in iter_records(path, kind=kind)
            if "round_end" in r)
    return max(ends, default=0)


class JournalFollower:
    """Incremental reader of a journal another process may still be
    writing: a byte-offset cursor over NEWLINE-TERMINATED lines.

    :func:`iter_records`'s durability rule, applied live: a record is
    durable iff its line is newline-terminated, so each :meth:`poll`
    consumes bytes only up to the LAST newline currently in the file —
    an in-progress (or torn) trailing fragment is simply left for the
    next poll, which is the streaming equivalent of iter_records'
    torn-tail skip.  Consumed bytes are NEVER re-read (the cursor only
    advances, and always lands just after a newline), so tailing a
    long-running journal — or rebasing ``covered_upto`` across
    supervisor relaunch segments — costs one scan of the new bytes, not
    a fresh parse from byte 0 (pinned by tests/test_alarms.py).

    A terminated-but-unparseable line still raises ``ValueError``
    (interior corruption, iter_records' rule).  The file SHRINKING
    below the cursor also raises: ``_heal_torn_tail`` can only ever
    truncate an unterminated fragment this follower never consumed, so
    a shorter-than-cursor file means the journal was rewritten
    out-of-band and every downstream dedup cursor is void.

    Per-kind ``round_end`` maxima fold incrementally as lines are
    consumed — :meth:`covered_upto` is :func:`covered_upto` rebased on
    the cursor.
    """

    def __init__(self, path: str, kind: Optional[str] = None):
        self.path = path
        self.kind = kind
        self.offset = 0
        self._covered: Dict[str, int] = {}

    def covered_upto(self, kind: str = "segment") -> int:
        """Max ``round_end`` over ``kind`` records consumed SO FAR
        (module-level :func:`covered_upto` semantics, incremental)."""
        return self._covered.get(kind, 0)

    def poll(self) -> List[dict]:
        """Consume every newly-durable record; [] when nothing new
        (including a missing file — the writer may not have started)."""
        if not os.path.exists(self.path):
            return []
        with open(self.path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if size < self.offset:
                raise ValueError(
                    f"{self.path}: journal shrank below the follower "
                    f"cursor ({size} < {self.offset}) — rewritten "
                    f"out-of-band; the consumed-record cursor is void")
            if size == self.offset:
                return []
            f.seek(self.offset)
            chunk = f.read(size - self.offset)
        nl = chunk.rfind(b"\n")
        if nl < 0:
            return []            # only an unterminated fragment so far
        lineno_base = self.offset   # byte position, for error messages
        self.offset += nl + 1
        out: List[dict] = []
        for raw in chunk[:nl + 1].split(b"\n"):
            if not raw.strip():
                continue
            try:
                rec = json.loads(raw.decode("utf-8"))
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                raise ValueError(
                    f"{self.path}: unparseable newline-terminated "
                    f"record after byte {lineno_base} — interior "
                    f"corruption, not a torn tail") from e
            k = rec.get("kind")
            if "round_end" in rec and k is not None:
                self._covered[k] = max(self._covered.get(k, 0),
                                       int(rec["round_end"]))
            if self.kind is None or k == self.kind:
                out.append(rec)
        return out


def follow_records(path: str, kind: Optional[str] = None) -> JournalFollower:
    """A :class:`JournalFollower` over ``path`` — the live-tail reader
    (``telemetry watch``) and the supervisor's scan-once resume cursor."""
    return JournalFollower(path, kind=kind)


def read_events(path: str) -> List[MembershipTraceEvent]:
    events: List[MembershipTraceEvent] = []
    for rec in read_records(path, kind="events"):
        events.extend(
            MembershipTraceEvent.from_json(e) for e in rec["events"]
        )
    return events


def read_provenance(path: str) -> Tuple[List[dict], dict]:
    """The journal's channel-attribution stream: (rows, accounting).

    Rows concatenate across ``provenance`` chunks in offset order (the
    writer emits them in order; the sort makes a merged journal safe);
    accounting is the LAST chunk's recorded/dropped/capacity totals
    (idempotent across chunks — write_provenance's contract)."""
    chunks = read_records(path, kind="provenance")
    chunks.sort(key=lambda r: int(r.get("offset", 0)))
    rows: List[dict] = []
    acct: dict = {}
    for rec in chunks:
        rows.extend(rec.get("rows", []))
        for k in ("recorded", "dropped", "capacity"):
            if k in rec:
                acct[k] = int(rec[k])
    return rows, acct


def fraction_informed_curve(dead_counts, n_live_observers: int):
    """[rounds] fraction of live observers holding the death notice —
    the dissemination curve, from the tick's per-round ``dead`` counts
    for one subject column."""
    v = _host(dead_counts).astype(np.float64)
    return v / max(1, int(n_live_observers))


# --------------------------------------------------------------------------
# Overlapped trace offload: the segmented traced runner
# --------------------------------------------------------------------------


@dataclasses.dataclass
class TracedRunResult:
    """What :func:`stream_traced_run` hands back, host-side.

    ``events`` is the decoded stream in round order (empty when
    ``decode=False``); ``recorded``/``dropped`` total the per-segment
    buffers.  ``telemetry`` carries the final first-suspect /
    first-removed matrices on the device (feed it to
    ``telemetry.trace.latency_histograms``); its trace buffer is a
    placeholder, the event stream lives in ``events``.  ``metrics`` is
    the concatenated [n_rounds, ...] trace dict as numpy arrays."""

    events: List[MembershipTraceEvent]
    recorded: int
    dropped: int
    capacity: int
    segment_rounds: int
    n_segments: int
    metrics: dict
    telemetry: object


def _offload(tensors, device: torch.device):
    """Start copying ``tensors`` to the host: on the card into pinned
    memory without blocking, with an event recorded after the copies;
    returns ``(host copies, event or None)``."""
    if device.type != "cuda":
        return [t.clone() for t in tensors], None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def stream_traced_run(seed: int, params, world, n_rounds: int, *,
                      state=None, knobs=None, start_round: int = 0,
                      segment_rounds: Optional[int] = None,
                      trace_capacity: Optional[int] = None,
                      decode: bool = True,
                      draws: Optional[Callable[[int], object]] = None,
                      device="cuda"):
    """Drive ``models/swim.run_traced`` in segments with the trace
    offload overlapped against the next segment's rounds.

    Segment k's lanes, count, dropped and metric rows are copied to
    pinned host memory without blocking as soon as its rounds are issued;
    the host waits on that copy only after segment k+1 has been issued,
    so the card does not idle on the offload.  ``segment_rounds``
    defaults to ``$SCALECUBE_TPU_TRACE_SEGMENT_ROUNDS``, else
    ``DEFAULT_SEGMENT_ROUNDS``.

    Each segment gets a fresh event buffer of ``trace_capacity`` while
    the first-suspect/first-removed matrices thread through.  With zero
    drops the concatenated stream is exactly the monolithic run's; under
    overflow, drops are counted per segment, exactly (a segmented run
    drops no more events than one shared buffer).

    Returns ``(final_state, TracedRunResult)``.  ``decode=False`` skips
    building the event objects (the offload still happens), for timing.
    """
    from scalecube_cluster_tpu_torch.models import swim
    from scalecube_cluster_tpu_torch.ops import prng
    from scalecube_cluster_tpu_torch.telemetry import trace as ttrace

    device = swim.resolve_device(device)
    if segment_rounds is None:
        env = os.environ.get(TRACE_SEGMENT_ENV)
        segment_rounds = int(env) if env else DEFAULT_SEGMENT_ROUNDS
    segment_rounds = max(1, segment_rounds)
    cap = trace_capacity or ttrace.DEFAULT_CAPACITY

    if state is None:
        state = swim.initial_state(params, world, device=device)
    if draws is None:
        draws = prng.TorchDraws(seed, device, params, world)
    tel0 = ttrace.TelemetryState.init(params.n_members, params.n_subjects,
                                      capacity=1, device=device)
    fs, fr = tel0.first_suspect, tel0.first_removed

    pending = None          # (host copies, event, metric names)
    slabs, metric_parts = [], []

    def harvest(p):
        host, event, names = p
        if event is not None:
            event.synchronize()
        lanes, count, seg_dropped = host[:3]
        slabs.append((lanes.numpy(), int(count), int(seg_dropped)))
        metric_parts.append({name: t.numpy()
                             for name, t in zip(names, host[3:])})

    r, n_segments = 0, 0
    while r < n_rounds:
        step = min(segment_rounds, n_rounds - r)
        tel_in = ttrace.TelemetryState.resume(fs, fr, capacity=cap)
        state, tel_out, metrics = swim.run_traced(
            seed, params, world, step, trace_capacity=cap, state=state,
            start_round=start_round + r, draws=draws, knobs=knobs,
            telemetry=tel_in, device=device)
        fs, fr = tel_out.first_suspect, tel_out.first_removed
        r += step
        n_segments += 1
        names = list(metrics)
        issued = _offload([tel_out.trace.lanes, tel_out.trace.count,
                           tel_out.trace.dropped]
                          + [metrics[name] for name in names], device)
        if pending is not None:     # overlapped: the next segment is issued
            harvest(pending)
        pending = issued + (names,)
    if pending is not None:
        harvest(pending)

    events: List[MembershipTraceEvent] = []
    recorded = dropped = 0
    for lanes, count, seg_dropped in slabs:
        recorded += count
        dropped += seg_dropped
        if decode:
            events.extend(
                MembershipTraceEvent(
                    round=int(lanes[i, 0]), observer=int(lanes[i, 1]),
                    subject=int(lanes[i, 2]),
                    event_type=TraceEventType(int(lanes[i, 3])),
                    incarnation=int(lanes[i, 4]))
                for i in range(count))
    metrics_np = {}
    if metric_parts:
        metrics_np = {name: np.concatenate([p[name] for p in metric_parts],
                                           axis=0)
                      for name in metric_parts[0]}
    final_tel = ttrace.TelemetryState(
        trace=ttrace.EventTrace.empty(1, device), first_suspect=fs,
        first_removed=fr)
    return state, TracedRunResult(
        events=events, recorded=recorded, dropped=dropped, capacity=cap,
        segment_rounds=segment_rounds, n_segments=n_segments,
        metrics=metrics_np, telemetry=final_tel)


# --------------------------------------------------------------------------
# TensorBoard export (gated; never a hard dependency)
# --------------------------------------------------------------------------


def _summary_writer(logdir: str):
    try:
        from tensorboardX import SummaryWriter
    except Exception:  # noqa: BLE001 — optional dependency
        return None
    return SummaryWriter(logdir=logdir)


def export_tensorboard(logdir: str, run_id: str,
                       scalars: Optional[Dict[str, Sequence]] = None,
                       histograms: Optional[dict] = None,
                       max_points: int = 1024) -> Optional[str]:
    """Write scalar traces + bucket histograms as TensorBoard summaries.

    ``scalars``: name -> per-round series (downsampled to max_points).
    ``histograms``: name -> (edges, counts) bucket pairs.  Returns the
    event-file directory, or None when no writer package is available.
    """
    path = os.path.join(logdir, run_id)
    w = _summary_writer(path)
    if w is None:
        return None
    try:
        for name, series in (scalars or {}).items():
            v = _host(series)
            if v.ndim > 1:
                v = v.sum(axis=tuple(range(1, v.ndim)))
            stride = max(1, int(np.ceil(v.shape[0] / max_points)))
            for step in range(0, v.shape[0], stride):
                w.add_scalar(name, float(v[step]), global_step=step)
        for name, (edges, counts) in (histograms or {}).items():
            e = _host(edges).astype(np.float64)
            c = _host(counts).astype(np.float64)
            if c.sum() <= 0:
                continue
            # Bucket i covers [e[i], e[i+1]); the open last bucket gets a
            # synthetic right edge so TB has a finite limit.
            limits = np.append(e[1:], e[-1] * 2 + 1)
            mids = (limits + e) / 2.0
            w.add_histogram_raw(
                name,
                min=float(e[0]), max=float(limits[-1]),
                num=int(c.sum()),
                sum=float((mids * c).sum()),
                sum_squares=float((mids * mids * c).sum()),
                bucket_limits=limits.tolist(),
                bucket_counts=c.tolist(),
                global_step=0,
            )
    finally:
        w.close()
    return path


def maybe_export_tensorboard(run_id: str,
                             scalars: Optional[Dict[str, Sequence]] = None,
                             histograms: Optional[dict] = None,
                             log=None) -> Optional[str]:
    """TensorBoard export gated behind SCALECUBE_TPU_PROFILE_DIR (the
    repo's existing profiling-surface convention — runlog.profiled)."""
    logdir = os.environ.get(PROFILE_DIR_ENV)
    if not logdir:
        return None
    path = export_tensorboard(logdir, run_id, scalars, histograms)
    if log is not None:
        if path:
            log.info("tensorboard telemetry written to %s", path)
        else:
            log.info("tensorboard export skipped (no writer package)")
    return path
