"""The event record of the membership trace: the CUDA kernel's wrapper
and its plain PyTorch version.

:func:`trace_record` compacts one round's coded cells into the trace's
lanes in cell order, and advances the trace's ``count`` and ``dropped``
in place, all on the device (``csrc/trace_record.cu``; the reference's
XLA record, ``scalecube_cluster_tpu/telemetry/trace.py:254-301``).  On
CPU tensors the plain version below runs; a CUDA tensor launches the
kernel or raises.

No single PyTorch library call computes the function, so the kernel has
no library yardstick.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from scalecube_cluster_tpu_torch.kernels import _build, check_args, i32
from scalecube_cluster_tpu_torch.kernels import launch, on_cpu

SOURCE = "trace_record"
NAME = "trace_record"
N_LANES = 5


def event_prefix(codes: torch.Tensor) -> torch.Tensor:
    """[N * K] int32 inclusive prefix sum of ``codes > 0`` in cell order:
    each event cell's 1-based rank among the round's events."""
    return torch.cumsum(codes.reshape(-1) > 0, dim=0, dtype=torch.int32)


def trace_record_reference(lanes, count, dropped, codes, incs, prefix,
                           subject_ids, round_idx: int,
                           observer_offset: int) -> None:
    """Plain version of :func:`trace_record` (``nonzero`` reads the event
    count to the host)."""
    cap, k = lanes.shape[0], codes.shape[1]
    flat = codes.reshape(-1)
    cells = torch.nonzero(flat > 0).squeeze(1)
    slot = count.to(torch.int64) + prefix[cells].to(torch.int64) - 1
    keep = slot < cap
    cells, slot = cells[keep], slot[keep]
    rows = torch.stack([
        torch.full_like(cells, i32(round_idx)),
        cells // k + observer_offset,
        subject_ids[cells % k].to(torch.int64),
        flat[cells].to(torch.int64) - 1,
        incs.reshape(-1)[cells].to(torch.int64),
    ], dim=1).to(torch.int32)
    lanes[slot] = rows
    total = prefix[-1]
    new_count = torch.clamp(count + total, max=cap)
    dropped.add_(total - (new_count - count))
    count.copy_(new_count)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load(SOURCE).trace_record_launch
    fn.argtypes = ([ctypes.c_void_p] * 8
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _tickets(device: torch.device) -> torch.Tensor:
    """The kernel's ticket word on ``device`` (zero between launches)."""
    return torch.zeros((1,), dtype=torch.int32, device=device)


def trace_record(lanes, count, dropped, codes, incs, prefix, subject_ids,
                 round_idx: int, observer_offset: int = 0) -> None:
    """Record one round: every cell with ``codes > 0`` ([N, K] int8, the
    event type + 1) becomes the row ``(round, observer_offset + row,
    subject_ids[col], code - 1, incs[row, col])`` of ``lanes``
    ([capacity, 5] int32) at slot ``count + prefix - 1`` while that slot
    is below the capacity; then ``count`` becomes ``min(count + total,
    capacity)`` and ``dropped`` grows by the events that did not fit
    (``count``/``dropped`` 0-dim int32, updated in place).  ``prefix``
    is :func:`event_prefix` of ``codes``; ``subject_ids`` [K] int32."""
    device = codes.device
    n, k = codes.shape
    check_args(NAME, device, (n, k), dict(codes=(codes, torch.int8),
                                          incs=(incs, torch.int32)))
    check_args(NAME, device, (n * k,), dict(prefix=(prefix, torch.int32)))
    check_args(NAME, device, (k,),
               dict(subject_ids=(subject_ids, torch.int32)))
    check_args(NAME, device, (lanes.shape[0], N_LANES),
               dict(lanes=(lanes, torch.int32)))
    check_args(NAME, device, (), dict(count=(count, torch.int32),
                                      dropped=(dropped, torch.int32)))
    if on_cpu(NAME, device):
        trace_record_reference(lanes, count, dropped, codes, incs, prefix,
                               subject_ids, round_idx, observer_offset)
        return
    launch(NAME, _launcher(), device, codes.data_ptr(), incs.data_ptr(),
           prefix.data_ptr(), subject_ids.data_ptr(), lanes.data_ptr(),
           count.data_ptr(), dropped.data_ptr(), _tickets(device).data_ptr(),
           n * k, k, lanes.shape[0], i32(round_idx), i32(observer_offset))
