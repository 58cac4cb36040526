"""The segmented traced runner: the trace offloaded to the host
segment by segment, each copy overlapped with the next segment's rounds.

Counterpart of the traced runner of ``scalecube_cluster_tpu/telemetry/
sink.py`` (``TRACE_SEGMENT_ENV``, ``DEFAULT_SEGMENT_ROUNDS``,
``TracedRunResult``, ``stream_traced_run``).  The reference's JSONL run
manifests and TensorBoard export are not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional

import numpy as np
import torch

from scalecube_cluster_tpu_torch.telemetry.events import (
    MembershipTraceEvent,
    TraceEventType,
)

# Segment length (in protocol rounds) of the overlapped trace offload
# (stream_traced_run); override with this environment variable.
TRACE_SEGMENT_ENV = "SCALECUBE_TPU_TRACE_SEGMENT_ROUNDS"
DEFAULT_SEGMENT_ROUNDS = 256


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
