"""The membership event trace riding the rounds.

Counterpart of ``scalecube_cluster_tpu/telemetry/trace.py``.  The round
cannot call a listener per event, so the trace is a fixed-capacity
buffer on the device:

  - :class:`EventTrace`: ``lanes`` [capacity, 5] int32, one row
    (round, observer, subject, event_type, incarnation) per recorded
    event, plus ``count`` (events written) and ``dropped`` (events that
    arrived after the buffer filled), int32 scalars on the device.
    Overflow is always counted: the decoded trace is an exact prefix of
    the event stream, and ``dropped`` says how many events are missing.
  - :class:`TelemetryState`: the trace plus the per-(observer, subject)
    ``first_suspect`` / ``first_removed`` round matrices, the inputs of
    :func:`latency_histograms`.

Events are transitions: each round's net change of a cell's (status,
incarnation, epoch) codes one event (``events.TraceEventType`` + 1, 0
for none).  On the card :func:`observe_round` is one launch of
``kernels/trace.trace_observe``: the codes derived in registers, the
first-round matrices stamped at their event cells, and the events
compacted into the buffer in cell order, with no code plane, prefix or
first-round pass in device memory; the counters stay on the device, so
a traced round reads nothing back to the host.  On CPU tensors the same
call runs the plain composition (:func:`derive_event_codes`,
:func:`update_first_rounds`, :func:`record_events`).
:func:`record_events` is the reference's codes-in record, one launch of
``kernels/trace.trace_record``.

The reference skips the derivation and the record in rounds without an
event (``lax.cond``); its silent branch is the identity on the buffer and
the first-round matrices, so the port, which has no device-side branch
in eager PyTorch, runs the ungated path every round with the same
results.  The trace updates its own tensors in place: a ``TelemetryState``
handed to :class:`TracePlane` (``run_traced(telemetry=...)``) is cloned
once, so the caller's tensors are not modified.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch.profiler import record_function

from scalecube_cluster_tpu_torch.kernels import trace as trace_kernel
from scalecube_cluster_tpu_torch.telemetry.events import (
    MembershipTraceEvent,
    TraceEventType,
)

INT32_MAX = 2**31 - 1

# Default event-buffer capacity: 65,536 rows x 5 lanes x 4 B = 1.3 MB.
DEFAULT_CAPACITY = 1 << 16

# Latency histogram bucket edges, in protocol rounds.  Bucket i covers
# [edges[i], edges[i+1]); the last bucket is open-ended.
DEFAULT_LATENCY_EDGES = (0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64,
                         96, 128, 192, 256, 384, 512)

_N_LANES = trace_kernel.N_LANES  # (round, observer, subject, type, inc)


def _device(device) -> torch.device:
    from scalecube_cluster_tpu_torch.models import swim

    return swim.resolve_device(device)


# --------------------------------------------------------------------------
# Carried state
# --------------------------------------------------------------------------


@dataclasses.dataclass
class EventTrace:
    """Fixed-capacity event buffer (module docstring).  ``lanes[i]`` for
    i < ``count`` in (round, observer-major cell) order."""

    lanes: torch.Tensor     # [capacity, 5] int32
    count: torch.Tensor     # 0-dim int32: events recorded (<= capacity)
    dropped: torch.Tensor   # 0-dim int32: events lost to overflow

    @property
    def capacity(self) -> int:
        return self.lanes.shape[0]

    @staticmethod
    def empty(capacity: int = DEFAULT_CAPACITY,
              device="cuda") -> "EventTrace":
        device = _device(device)
        return EventTrace(
            lanes=torch.full((capacity, _N_LANES), -1, dtype=torch.int32,
                             device=device),
            count=torch.zeros((), dtype=torch.int32, device=device),
            dropped=torch.zeros((), dtype=torch.int32, device=device))

    def clone(self) -> "EventTrace":
        return EventTrace(lanes=self.lanes.clone(), count=self.count.clone(),
                          dropped=self.dropped.clone())


@dataclasses.dataclass
class TelemetryState:
    """The trace and the first-transition rounds.  ``first_suspect`` /
    ``first_removed`` [N, K] int32: the first round observer i turned
    subject slot k SUSPECT / DEAD (INT32_MAX = never)."""

    trace: EventTrace
    first_suspect: torch.Tensor
    first_removed: torch.Tensor

    @staticmethod
    def init(n_members: int, n_subjects: int,
             capacity: int = DEFAULT_CAPACITY,
             device="cuda") -> "TelemetryState":
        device = _device(device)

        def full():
            return torch.full((n_members, n_subjects), INT32_MAX,
                              dtype=torch.int32, device=device)

        return TelemetryState(trace=EventTrace.empty(capacity, device),
                              first_suspect=full(), first_removed=full())

    @staticmethod
    def resume(first_suspect, first_removed,
               capacity: int = DEFAULT_CAPACITY,
               device=None) -> "TelemetryState":
        """A fresh event buffer with the first-transition matrices carried
        over: what a segmented traced runner hands ``run_traced`` per
        segment.  Tensors keep their device (``device`` moves them);
        numpy arrays go to ``device``, CUDA by default."""
        if device is None:
            device = (first_suspect.device
                      if isinstance(first_suspect, torch.Tensor) else "cuda")
        device = _device(device)

        def on_device(m):
            return torch.as_tensor(np.asarray(m) if not isinstance(
                m, torch.Tensor) else m, dtype=torch.int32).to(device)

        return TelemetryState(trace=EventTrace.empty(capacity, device),
                              first_suspect=on_device(first_suspect),
                              first_removed=on_device(first_removed))

    def clone(self) -> "TelemetryState":
        return TelemetryState(trace=self.trace.clone(),
                              first_suspect=self.first_suspect.clone(),
                              first_removed=self.first_removed.clone())


# --------------------------------------------------------------------------
# Per-round recording
# --------------------------------------------------------------------------


# The plain derivation lives beside the kernel it is the plain version of.
derive_event_codes = trace_kernel.derive_event_codes


def record_events(trace: EventTrace, round_idx: int, codes, incarnations,
                  subject_ids, observer_offset: int = 0) -> EventTrace:
    """Compact this round's coded cells into ``trace`` (in place; returned
    for the reference's call shape): one ``kernels/trace.trace_record``
    launch."""
    if incarnations.dtype not in (torch.int32, torch.int16):
        incarnations = incarnations.to(torch.int32)
    trace_kernel.trace_record(
        trace.lanes, trace.count, trace.dropped, codes.contiguous(),
        incarnations.contiguous(), subject_ids.to(torch.int32),
        round_idx, observer_offset)
    return trace


def record_events_batch(trace: EventTrace, round_ids, codes, incarnations,
                        subject_ids, observer_offset: int = 0) -> EventTrace:
    """Compact a batch of rounds' coded cells (``codes``/``incarnations``
    [R, N, K], ``round_ids`` [R]) into ``trace``, round-major: the
    reference's batched form, which its fused steps use and which gives
    exactly R single-round records.  Kept for parity; the runner records
    round by round."""
    for i, round_idx in enumerate(torch.as_tensor(round_ids).tolist()):
        record_events(trace, int(round_idx), codes[i], incarnations[i],
                      subject_ids, observer_offset)
    return trace


def round_transition_codes(round_idx: int, prev_status, prev_inc,
                           new_state, world, observer_offset: int = 0,
                           prev_epoch=None, is_self=None):
    """``(codes, ev_inc)`` of one round's net transitions.  ``prev_epoch``
    is the carry's epoch lane before the round (the new one is
    ``new_state.epoch``); None disables JOINED.  ``is_self`` may pass in
    the [N, K] self mask (it depends on the world alone)."""
    n = prev_status.shape[0]
    if is_self is None:
        is_self = trace_kernel.self_mask(world.subject_ids, n,
                                         observer_offset)
    leave_at = world.leave_at[observer_offset:observer_offset + n]
    leaving_now = (leave_at == round_idx)[:, None] & is_self
    return derive_event_codes(
        prev_status, prev_inc, new_state.status, new_state.inc, is_self,
        leaving_now, new_state.self_inc, prev_epoch=prev_epoch,
        new_epoch=None if prev_epoch is None else new_state.epoch)


def update_first_rounds(tel: TelemetryState, codes,
                        round_idx: int) -> TelemetryState:
    """Advance the first-suspect/first-removed matrices for one round's
    codes, in place (the trace buffer untouched)."""
    trace_kernel.update_first_round_matrices(tel.first_suspect,
                                             tel.first_removed, codes,
                                             round_idx)
    return tel


def observe_round_codes(tel: TelemetryState, round_idx: int, prev_status,
                        prev_inc, new_state, world,
                        observer_offset: int = 0, prev_epoch=None,
                        any_status_change=None, is_self=None):
    """``(tel, codes, ev_inc)`` for one round: the codes and the
    first-round update.  The reference gates both on an emptiness
    predicate (``any_status_change`` among its terms) whose silent branch
    is the identity; the port derives every round, so
    ``any_status_change`` is accepted and unused."""
    codes, ev_inc = round_transition_codes(
        round_idx, prev_status, prev_inc, new_state, world, observer_offset,
        prev_epoch=prev_epoch, is_self=is_self)
    return update_first_rounds(tel, codes, round_idx), codes, ev_inc


def observe_round(tel: TelemetryState, round_idx: int, prev_status,
                  prev_inc, new_state, world, observer_offset: int = 0,
                  prev_epoch=None, any_status_change=None,
                  is_self=None) -> TelemetryState:
    """One round's telemetry update, in place: derive the transitions,
    advance the first-round matrices, record the events, as one
    ``kernels/trace.trace_observe`` call under the profiler range
    ``trace.record``.  ``prev_status`` / ``prev_inc`` are the carry's
    before the round and ``new_state`` the carry after it, both in their
    stored layout; ``prev_epoch`` the epoch lane before the round (None:
    no JOINED).  ``is_self`` (the [N, K] self mask) serves the plain
    version on CPU tensors; ``prev_inc`` and ``any_status_change`` are
    the reference's arguments, unused."""
    n = prev_status.shape[0]
    with record_function("trace.record"):
        trace_kernel.trace_observe(
            tel.trace.lanes, tel.trace.count, tel.trace.dropped,
            tel.first_suspect, tel.first_removed, prev_status,
            new_state.status, new_state.inc, new_state.self_inc,
            world.leave_at[observer_offset:observer_offset + n],
            world.subject_ids, round_idx, observer_offset,
            prev_epoch=prev_epoch,
            new_epoch=None if prev_epoch is None else new_state.epoch,
            is_self=is_self)
    return tel


# --------------------------------------------------------------------------
# The compose plane
# --------------------------------------------------------------------------


class TracePlane:
    """The membership event trace as a plane of ``models/compose``: its
    slice is a :class:`TelemetryState`, its round hook
    :func:`observe_round` on the shared round context.  ``telemetry``
    resumes an earlier state (cloned once, then updated in place).  The
    reference's batched fold (``on_round_batch``) waits for the batch
    runner."""

    name = "trace"

    def __init__(self, capacity: int = DEFAULT_CAPACITY, telemetry=None,
                 observer_offset: int = 0):
        self.capacity = capacity
        self.telemetry = telemetry
        self.observer_offset = observer_offset
        self._is_self = None

    def init(self, params, world):
        n, k = params.n_members, params.n_subjects
        # Only the plain version reads the [N, K] self mask; the kernel
        # tests subject_ids[col] == row + offset itself.
        self._is_self = (trace_kernel.self_mask(world.subject_ids, n,
                                                self.observer_offset)
                         if world.device.type == "cpu" else None)
        if self.telemetry is None:
            return TelemetryState.init(n, k, self.capacity, world.device)
        tel = self.telemetry
        if tuple(tel.first_suspect.shape) != (n, k) \
                or tuple(tel.first_removed.shape) != (n, k):
            raise ValueError(
                f"telemetry first-round matrices are "
                f"{tuple(tel.first_suspect.shape)}, the params need "
                f"{(n, k)}")
        if tel.first_suspect.device != world.device:
            raise ValueError(f"telemetry is on {tel.first_suspect.device}, "
                             f"the world on {world.device}")
        return tel.clone()

    def _prev_epoch(self, rc):
        return rc.prev.epoch if rc.params.epoch_bits else None

    def on_round(self, rc, tel):
        return observe_round(
            tel, rc.round_idx, rc.prev.status, rc.prev.inc, rc.new,
            rc.world, observer_offset=self.observer_offset,
            prev_epoch=self._prev_epoch(rc), is_self=self._is_self)

    def finalize(self, fc, tel):
        return tel


# --------------------------------------------------------------------------
# Derived metrics
# --------------------------------------------------------------------------


def _bucketize(values, edges: torch.Tensor):
    idx = torch.searchsorted(edges, values, right=True) - 1
    return torch.clamp(idx, 0, edges.shape[0] - 1)


def latency_histograms(tel: TelemetryState, world,
                       edges: Sequence[int] = DEFAULT_LATENCY_EDGES,
                       ref_rounds=None) -> dict:
    """Detection/removal latency histograms per subject, on the device.

    The latency of observer i for subject slot k is its first transition
    round minus the subject's fault round (``ref_rounds`` [K]; default:
    the earlier of the subject's crash and leave rounds).  Subjects with
    no fault, and transitions before the fault (false positives), are
    left out; ``*_undetected`` counts observers that never transitioned
    for a faulted subject.

    Returns ``{"edges": [B], "detection": [K, B], "removal": [K, B],
    "detection_undetected": [K], "removal_undetected": [K]}`` of int32
    tensors."""
    device = tel.first_suspect.device
    subject_ids = world.subject_ids.to(device).long()
    if ref_rounds is None:
        ref_rounds = torch.minimum(world.down_from[subject_ids],
                                   world.leave_at[subject_ids])
    ref = torch.as_tensor(ref_rounds, dtype=torch.int32).to(device)
    n = tel.first_suspect.shape[0]
    k = subject_ids.shape[0]
    b = len(edges)
    e = torch.tensor(edges, dtype=torch.int32, device=device)
    is_self = (subject_ids[None, :]
               == torch.arange(n, device=device)[:, None])
    faulted = (ref != INT32_MAX)[None, :]

    out = {"edges": e}
    for name, first in (("detection", tel.first_suspect),
                        ("removal", tel.first_removed)):
        lat = first - ref[None, :]
        valid = (first != INT32_MAX) & faulted & (lat >= 0) & ~is_self
        bucket = _bucketize(lat, e)
        flat = torch.where(
            valid, torch.arange(k, device=device)[None, :] * b + bucket,
            k * b).reshape(-1)
        out[name] = torch.bincount(flat, minlength=k * b + 1)[
            :k * b].reshape(k, b).to(torch.int32)
        out[name + "_undetected"] = (
            (first == INT32_MAX) & faulted & ~is_self).sum(
                dim=0, dtype=torch.int32)
    return out


# --------------------------------------------------------------------------
# Host-side decoding
# --------------------------------------------------------------------------


def decode_events(trace_or_tel) -> list:
    """The buffer as a typed ``MembershipTraceEvent`` list (host side),
    from an :class:`EventTrace` or a :class:`TelemetryState`: the exact
    recorded prefix of the event stream, in (round, observer-major cell)
    order; ``trace.dropped`` says how many later events did not fit."""
    trace = getattr(trace_or_tel, "trace", trace_or_tel)
    count = int(trace.count)
    lanes = trace.lanes[:count].cpu().tolist()
    return [MembershipTraceEvent(round=row[0], observer=row[1],
                                 subject=row[2],
                                 event_type=TraceEventType(row[3]),
                                 incarnation=row[4])
            for row in lanes]


def histograms_to_json(hists: dict) -> dict:
    """Histogram dict -> plain-Python, JSONL-ready form."""
    return {name: torch.as_tensor(v).cpu().tolist()
            for name, v in hists.items()}
