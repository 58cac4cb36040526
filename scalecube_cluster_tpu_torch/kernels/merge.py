"""The merge/timers step: CUDA kernel wrapper and its plain PyTorch version.

``merge_and_timers`` runs the inbox merge, self-refutation, suspicion
timers, crash freeze and spread reset of one round
(``scalecube_cluster_tpu/models/swim._merge_and_timers`` at the port's
settings) over the [N, K] planes.  On CUDA tensors it launches one
instance of the template in ``csrc/merge_timers.cu`` (replacing the TPU
kernel ``experiments/merge_kernel_bench.py::kernel``), chosen by the wire
format: ``merge_and_timers`` (wide int32 inbox),
``merge_and_timers_wire16`` (int16 inbox) or ``merge_and_timers_wire24``
(int32 inbox, dead bit 23).  On CPU tensors it runs
:func:`merge_and_timers_reference`, the line-for-line transcription the
CPU tests hold against the JAX package, in the same format.  There is no
fallback: a CUDA tensor launches the kernel or raises.

No single PyTorch library call computes this function, so the kernel has
no library yardstick.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from scalecube_cluster_tpu_torch import records
from scalecube_cluster_tpu_torch.kernels import _build, check_args, i32
from scalecube_cluster_tpu_torch.kernels import launch, on_cpu
from scalecube_cluster_tpu_torch.ops import delivery

SOURCE = "merge_timers"
INT32_MAX = 2**31 - 1
# Kernel (launch-count) name of each wire format's instance.
NAMES = {"wide": "merge_and_timers", "wire16": "merge_and_timers_wire16",
         "wire24": "merge_and_timers_wire24"}
NAME = NAMES["wide"]


def merge_and_timers_reference(status, inc, spread_until, suspect_deadline,
                               inbox, inbox_alive, self_inc, alive_here,
                               slot_of_node, round_idx: int,
                               suspicion_rounds: int, periods_to_spread: int,
                               inc_sat: int, fmt: delivery.WireFormat = None):
    """Plain PyTorch version of the kernel (same arguments and results as
    :func:`merge_and_timers`), transcribed from the reference's
    ``_merge_and_timers`` + ``merge_inbox``.  ``status``/``inc`` are the
    round's pinned planes (self cells ALIVE at ``self_inc``)."""
    k = status.shape[1]
    is_self = (torch.arange(k, dtype=torch.int32, device=status.device)[None, :]
               == slot_of_node[:, None])
    new_status, new_inc, changed = delivery.merge_inbox(
        status, inc, inbox, inbox_alive, fmt=fmt)

    # Self-refutation: the winner about ME overriding ALIVE@self_inc bumps
    # self_inc to max(inc)+1, clamped at ``inc_sat`` (the wire key's and
    # the carry's incarnation cap).
    win_status, win_inc = delivery.unpack_record(inbox, fmt=fmt)
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
        start_timer, i32(round_idx + suspicion_rounds),
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
        changed, i32(round_idx + 1 + periods_to_spread), spread_until)
    return (new_status, new_inc.to(torch.int32), new_spread.to(torch.int32),
            deadline.to(torch.int32), new_self_inc.to(torch.int32), refuted)


def _check(fmt, status, inc, spread_until, suspect_deadline, inbox,
           inbox_alive, self_inc, alive_here, slot_of_node):
    n, k = status.shape
    name = NAMES[fmt.name]
    check_args(name, status.device, (n, k), dict(
        status=(status, torch.int8), inc=(inc, torch.int32),
        spread_until=(spread_until, torch.int32),
        suspect_deadline=(suspect_deadline, torch.int32),
        inbox=(inbox, fmt.dtype), inbox_alive=(inbox_alive, torch.bool)))
    check_args(name, status.device, (n,), dict(
        self_inc=(self_inc, torch.int32), alive_here=(alive_here, torch.bool),
        slot_of_node=(slot_of_node, torch.int32)))


@functools.lru_cache(maxsize=None)
def _launcher(fmt_name: str):
    symbol = ("merge_and_timers_launch" if fmt_name == "wide"
              else f"merge_and_timers_{fmt_name}_launch")
    fn = getattr(_build.load(SOURCE), symbol)
    fn.argtypes = ([ctypes.c_void_p] * 15
                   + [ctypes.c_longlong] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def merge_and_timers(status, inc, spread_until, suspect_deadline, inbox,
                     inbox_alive, self_inc, alive_here, slot_of_node,
                     round_idx: int, suspicion_rounds: int,
                     periods_to_spread: int, inc_sat: int,
                     fmt: delivery.WireFormat = None):
    """One round's merge + refutation + timers + freeze.

    Planes [N, K]: pinned ``status`` int8, ``inc``, ``spread_until``,
    ``suspect_deadline`` int32, ``inbox`` in the wire format's dtype
    (``fmt``, default wide: int32; wire16: int16; wire24: int32),
    ``inbox_alive`` bool.  Rows [N]: ``self_inc`` int32, ``alive_here``
    bool, ``slot_of_node`` int32 (each row's self column, -1 for none; at
    most one per row).  Returns new ``(status, inc, spread_until,
    suspect_deadline, self_inc, refuted)``.
    """
    fmt = delivery.resolve_format(fmt)
    _check(fmt, status, inc, spread_until, suspect_deadline, inbox,
           inbox_alive, self_inc, alive_here, slot_of_node)
    scalars = (round_idx, suspicion_rounds, periods_to_spread, inc_sat)
    name = NAMES[fmt.name]
    if on_cpu(name, status.device):
        return merge_and_timers_reference(
            status, inc, spread_until, suspect_deadline, inbox, inbox_alive,
            self_inc, alive_here, slot_of_node, *scalars, fmt=fmt)
    n, k = status.shape
    outs = (torch.empty_like(status), torch.empty_like(inc),
            torch.empty_like(spread_until), torch.empty_like(suspect_deadline),
            torch.empty_like(self_inc), torch.empty_like(alive_here))
    ins = (status, inc, spread_until, suspect_deadline, inbox, inbox_alive,
           self_inc, alive_here, slot_of_node)
    launch(name, _launcher(fmt.name), status.device,
           *(t.data_ptr() for t in ins + outs), n, k,
           *(i32(s) for s in scalars))
    return outs
