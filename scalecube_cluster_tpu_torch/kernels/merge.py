"""The merge/timers step: CUDA kernel wrapper and its plain PyTorch version.

``merge_and_timers`` runs the inbox merge, self-refutation, suspicion
timers, crash freeze and spread reset of one round
(``scalecube_cluster_tpu/models/swim._merge_and_timers`` at the port's
settings) over the [N, K] planes.  On CUDA tensors it launches
``csrc/merge_timers.cu`` (replacing the TPU kernel
``experiments/merge_kernel_bench.py::kernel``); on CPU tensors it runs
:func:`merge_and_timers_reference`, the line-for-line transcription the
CPU tests hold against the JAX package.  There is no fallback: a CUDA
tensor launches the kernel or raises.

No single PyTorch library call computes this function, so the kernel has
no library yardstick.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from scalecube_cluster_tpu_torch import records
from scalecube_cluster_tpu_torch.kernels import LAUNCHES, _build
from scalecube_cluster_tpu_torch.ops import delivery

NAME = "merge_and_timers"
SOURCE = "merge_timers"
INT32_MAX = 2**31 - 1


def _i32(x: int) -> int:
    """Python int -> int32 with two's-complement wrap (the reference's
    traced int32 round arithmetic)."""
    return ((int(x) + 2**31) % 2**32) - 2**31


def merge_and_timers_reference(status, inc, spread_until, suspect_deadline,
                               inbox, inbox_alive, self_inc, alive_here,
                               slot_of_node, round_idx: int,
                               suspicion_rounds: int, periods_to_spread: int,
                               inc_sat: int):
    """Plain PyTorch version of the kernel (same arguments and results as
    :func:`merge_and_timers`), transcribed from the reference's
    ``_merge_and_timers`` + ``merge_inbox``.  ``status``/``inc`` are the
    round's pinned planes (self cells ALIVE at ``self_inc``)."""
    k = status.shape[1]
    is_self = (torch.arange(k, dtype=torch.int32, device=status.device)[None, :]
               == slot_of_node[:, None])
    new_status, new_inc, changed = delivery.merge_inbox(
        status, inc, inbox, inbox_alive)

    # Self-refutation: the winner about ME overriding ALIVE@self_inc bumps
    # self_inc to max(inc)+1, clamped at the wire key's incarnation cap.
    win_status, win_inc = delivery.unpack_record(inbox)
    self_overridden = is_self & records.is_overrides_array(
        win_status, win_inc, records.ALIVE, self_inc[:, None])
    refuted = self_overridden.any(dim=1)
    bumped_inc = torch.clamp(
        torch.maximum(self_inc,
                      torch.where(self_overridden, win_inc, 0).amax(dim=1)) + 1,
        max=inc_sat)
    new_self_inc = torch.where(refuted & alive_here, bumped_inc, self_inc)
    new_status = torch.where(is_self, records.ALIVE, new_status).to(torch.int8)
    new_inc = torch.where(is_self, new_self_inc[:, None], new_inc)
    changed = torch.where(is_self, self_overridden & alive_here[:, None],
                          changed)

    # Suspicion timers (computeIfAbsent: an accepted SUSPECT keeps a
    # pending timer; any accepted non-SUSPECT cancels it).
    no_timer = suspect_deadline == INT32_MAX
    start_timer = changed & (new_status == records.SUSPECT) & no_timer
    cancel_timer = changed & (new_status != records.SUSPECT)
    deadline = torch.where(
        start_timer, _i32(round_idx + suspicion_rounds),
        torch.where(cancel_timer, INT32_MAX, suspect_deadline))
    fired = (new_status == records.SUSPECT) & (round_idx >= deadline)
    new_status = torch.where(fired, records.DEAD, new_status).to(torch.int8)
    deadline = torch.where(fired, INT32_MAX, deadline)
    changed = changed | fired

    # Crashed/left rows are frozen.
    frozen = ~alive_here[:, None]
    new_status = torch.where(frozen, status, new_status)
    new_inc = torch.where(frozen, inc, new_inc)
    deadline = torch.where(frozen, suspect_deadline, deadline)
    changed = changed & ~frozen
    new_spread = torch.where(
        changed, _i32(round_idx + 1 + periods_to_spread), spread_until)
    return (new_status, new_inc.to(torch.int32), new_spread.to(torch.int32),
            deadline.to(torch.int32), new_self_inc.to(torch.int32), refuted)


def _check(status, inc, spread_until, suspect_deadline, inbox, inbox_alive,
           self_inc, alive_here, slot_of_node):
    n, k = status.shape
    planes = dict(status=(status, torch.int8), inc=(inc, torch.int32),
                  spread_until=(spread_until, torch.int32),
                  suspect_deadline=(suspect_deadline, torch.int32),
                  inbox=(inbox, torch.int32),
                  inbox_alive=(inbox_alive, torch.bool))
    rows = dict(self_inc=(self_inc, torch.int32),
                alive_here=(alive_here, torch.bool),
                slot_of_node=(slot_of_node, torch.int32))
    device = status.device
    for group, shape in ((planes, (n, k)), (rows, (n,))):
        for name, (t, dtype) in group.items():
            if t.device != device:
                raise ValueError(f"{NAME}: {name} is on {t.device}, "
                                 f"status on {device}")
            if t.dtype != dtype:
                raise TypeError(f"{NAME}: {name} must be {dtype}, "
                                f"got {t.dtype}")
            if tuple(t.shape) != shape:
                raise ValueError(f"{NAME}: {name} must have shape {shape}, "
                                 f"got {tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{NAME}: {name} must be contiguous")


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load(SOURCE).merge_and_timers_launch
    fn.argtypes = ([ctypes.c_void_p] * 15
                   + [ctypes.c_longlong] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def merge_and_timers(status, inc, spread_until, suspect_deadline, inbox,
                     inbox_alive, self_inc, alive_here, slot_of_node,
                     round_idx: int, suspicion_rounds: int,
                     periods_to_spread: int, inc_sat: int):
    """One round's merge + refutation + timers + freeze.

    Planes [N, K]: pinned ``status`` int8, ``inc``, ``spread_until``,
    ``suspect_deadline``, ``inbox`` int32, ``inbox_alive`` bool.  Rows
    [N]: ``self_inc`` int32, ``alive_here`` bool, ``slot_of_node`` int32
    (each row's self column, -1 for none; at most one per row).  Returns
    new ``(status, inc, spread_until, suspect_deadline, self_inc,
    refuted)``.
    """
    _check(status, inc, spread_until, suspect_deadline, inbox, inbox_alive,
           self_inc, alive_here, slot_of_node)
    scalars = (round_idx, suspicion_rounds, periods_to_spread, inc_sat)
    if status.device.type == "cpu":
        return merge_and_timers_reference(
            status, inc, spread_until, suspect_deadline, inbox, inbox_alive,
            self_inc, alive_here, slot_of_node, *scalars)
    if status.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {status.device}")
    n, k = status.shape
    outs = (torch.empty_like(status), torch.empty_like(inc),
            torch.empty_like(spread_until), torch.empty_like(suspect_deadline),
            torch.empty_like(self_inc), torch.empty_like(alive_here))
    ins = (status, inc, spread_until, suspect_deadline, inbox, inbox_alive,
           self_inc, alive_here, slot_of_node)
    with torch.cuda.device(status.device):
        stream = torch.cuda.current_stream(status.device).cuda_stream
        err = _launcher()(*(t.data_ptr() for t in ins + outs), n, k,
                          *(_i32(s) for s in scalars), stream)
    if err != 0:
        raise RuntimeError(f"{NAME}: kernel launch failed with cudaError_t "
                           f"{err}")
    LAUNCHES[NAME] += 1
    return outs
