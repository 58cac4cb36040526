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

Two plane branches, off by default: ``armed_rounds`` [N] int32, the
rounds to DEAD each row arms for a new SUSPECT entry (Lifeguard's LHA
Suspicion; None arms ``suspicion_rounds`` everywhere), and
``dead_suppress_rounds``, the dead-member suppression window (0 = off).

The open-world epoch form (``epoch`` given): the raw identity-epoch lane
[N, Kb] int32 and ``own_epoch`` [N] int32, each row's ground-truth
epoch; every key carries the format's ``epoch_bits`` field, the merge
gate resolves identities (``delivery.merge_inbox`` guarded), the self
cell refutes only a winner at its own epoch, and the new lane comes back
as a seventh result.  The self cell's entry epoch is pinned to
``own_epoch`` inside, so the caller passes the raw lane.

Block form (the K-tiled capacity round, ``SwimParams.k_block``): the
planes may be an [N, Kb] column block of [N, K] planes, given as views
with contiguous rows (``plane[:, c0:c0 + kb]``) and ``col0 = c0``, and
``out`` may name the views the four new planes go to (the output carry's
columns).  Each plane keeps its own row stride; the self cell of row i
is column ``slot_of_node[i] - col0`` when that lies in the block.

No single PyTorch library call computes this function, so the kernel has
no library yardstick.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from scalecube_cluster_tpu_torch import records
from scalecube_cluster_tpu_torch.kernels import _build, check_args, i32
from scalecube_cluster_tpu_torch.kernels import check_block_args
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
                               inc_sat: int, fmt: delivery.WireFormat = None,
                               col0: int = 0, armed_rounds=None,
                               dead_suppress_rounds: int = 0, epoch=None,
                               own_epoch=None):
    """Plain PyTorch version of the kernel (same arguments and results as
    :func:`merge_and_timers`, without ``out``), transcribed from the
    reference's ``_merge_and_timers`` + ``merge_inbox``.  ``status``/
    ``inc`` are the round's pinned planes (self cells ALIVE at
    ``self_inc``); they may be a column block starting at ``col0``.
    ``epoch`` is the raw lane, pinned here as the reference's round
    context pins it."""
    fmt = delivery.resolve_format(fmt)
    kb = status.shape[1]
    cols = torch.arange(col0, col0 + kb, dtype=torch.int32,
                        device=status.device)
    is_self = cols[None, :] == slot_of_node[:, None]
    eb = 0 if epoch is None else fmt.epoch_bits
    if eb:
        epoch = torch.where(is_self, own_epoch[:, None], epoch)
    # Dead-member suppression: a tombstone whose deadline lane holds an
    # expiry still ahead gates by its true DEAD key.
    suppress = None
    if dead_suppress_rounds > 0:
        suppress = ((status == records.DEAD)
                    & (suspect_deadline != INT32_MAX)
                    & (round_idx < suspect_deadline))
    new_epoch = None
    if eb:
        new_status, new_inc, new_epoch, changed = delivery.merge_inbox(
            status, inc, inbox, inbox_alive, fmt=fmt, suppress=suppress,
            entry_epoch=epoch, epoch_bits=eb)
    else:
        new_status, new_inc, changed = delivery.merge_inbox(
            status, inc, inbox, inbox_alive, fmt=fmt, suppress=suppress)

    # Self-refutation: the winner about ME overriding ALIVE@self_inc bumps
    # self_inc to max(inc)+1, clamped at ``inc_sat`` (the wire key's and
    # the carry's incarnation cap); a winner at another epoch is about a
    # different member of the slot.
    win_status, win_inc = delivery.unpack_record(inbox, fmt=fmt,
                                                 epoch_bits=eb)
    self_overridden = is_self & records.is_overrides_array(
        win_status, win_inc, records.ALIVE, self_inc[:, None])
    if eb:
        self_overridden = self_overridden & (
            delivery.unpack_epoch(inbox, fmt=fmt, epoch_bits=eb)
            == own_epoch[:, None])
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
    if eb:
        new_epoch = torch.where(is_self, own_epoch[:, None], new_epoch)

    # Suspicion timers (computeIfAbsent: an accepted SUSPECT keeps a
    # pending timer; any accepted non-SUSPECT cancels it).  With
    # suppression on, a DEAD cell's lane holds its expiry, not a timer,
    # and an accepted DEAD keeps it.
    no_timer = suspect_deadline == INT32_MAX
    if suppress is not None:
        no_timer = no_timer | (status == records.DEAD)
    if armed_rounds is None:
        armed = i32(round_idx + suspicion_rounds)
    else:
        armed = (torch.tensor(i32(round_idx), dtype=torch.int32,
                              device=status.device)
                 + armed_rounds)[:, None]
    start_timer = changed & (new_status == records.SUSPECT) & no_timer
    cancel_timer = changed & (new_status != records.SUSPECT)
    if suppress is not None:
        cancel_timer = cancel_timer & (new_status != records.DEAD)
    deadline = torch.where(
        start_timer, armed,
        torch.where(cancel_timer, INT32_MAX, suspect_deadline))
    fired = (new_status == records.SUSPECT) & (round_idx >= deadline)
    new_status = torch.where(fired, records.DEAD, new_status).to(torch.int8)
    deadline = torch.where(fired, INT32_MAX, deadline)
    changed = changed | fired
    if suppress is not None:
        # Every newly stored tombstone opens its suppression window.
        became_dead = (new_status == records.DEAD) & changed
        deadline = torch.where(became_dead,
                               i32(round_idx + dead_suppress_rounds),
                               deadline)

    # Crashed/left rows are frozen.
    frozen = ~alive_here[:, None]
    new_status = torch.where(frozen, status, new_status)
    new_inc = torch.where(frozen, inc, new_inc)
    deadline = torch.where(frozen, suspect_deadline, deadline)
    changed = changed & ~frozen
    new_spread = torch.where(
        changed, i32(round_idx + 1 + periods_to_spread), spread_until)
    got = (new_status, new_inc.to(torch.int32), new_spread.to(torch.int32),
           deadline.to(torch.int32), new_self_inc.to(torch.int32), refuted)
    if eb:
        got += (torch.where(frozen, epoch, new_epoch).to(torch.int32),)
    return got


def _check(fmt, planes, out, self_inc, alive_here, slot_of_node,
           armed_rounds, epoch=None, own_epoch=None):
    """Check the planes, the ``out`` views and the row vectors; returns
    the twelve planes' row strides (inputs, then outputs, then the epoch
    lane in and out; 0 for the epoch lane without it)."""
    status = planes[0]
    name = NAMES[fmt.name]
    dtypes = (torch.int8, torch.int32, torch.int32, torch.int32, fmt.dtype,
              torch.bool)
    fields = ("status", "inc", "spread_until", "suspect_deadline", "inbox",
              "inbox_alive")
    views = {f: (t, d) for f, t, d in zip(fields, planes, dtypes)}
    views.update((f"out[{i}]", (t, d))
                 for i, (t, d) in enumerate(zip(out[:4], dtypes)))
    rows = dict(self_inc=(self_inc, torch.int32),
                alive_here=(alive_here, torch.bool),
                slot_of_node=(slot_of_node, torch.int32))
    if armed_rounds is not None:
        rows["armed_rounds"] = (armed_rounds, torch.int32)
    if epoch is not None:
        views.update(epoch=(epoch, torch.int32),
                     epoch_out=(out[4], torch.int32))
        rows["own_epoch"] = (own_epoch, torch.int32)
    strides = check_block_args(name, status.device, tuple(status.shape),
                               views)
    check_args(name, status.device, (status.shape[0],), rows)
    return strides + (0, 0) * (epoch is None)


@functools.lru_cache(maxsize=None)
def _launcher(fmt_name: str):
    symbol = ("merge_and_timers_launch" if fmt_name == "wide"
              else f"merge_and_timers_{fmt_name}_launch")
    fn = getattr(_build.load(SOURCE), symbol)
    fn.argtypes = ([ctypes.c_void_p] * 19
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def merge_and_timers(status, inc, spread_until, suspect_deadline, inbox,
                     inbox_alive, self_inc, alive_here, slot_of_node,
                     round_idx: int, suspicion_rounds: int,
                     periods_to_spread: int, inc_sat: int,
                     fmt: delivery.WireFormat = None, col0: int = 0,
                     out=None, armed_rounds=None,
                     dead_suppress_rounds: int = 0, epoch=None,
                     own_epoch=None):
    """One round's merge + refutation + timers + freeze.

    Planes [N, Kb] (Kb = K, or a column block of the [N, K] planes
    starting at column ``col0``; rows contiguous, any row stride): pinned
    ``status`` int8, ``inc``, ``spread_until``, ``suspect_deadline``
    int32, ``inbox`` in the wire format's dtype (``fmt``, default wide:
    int32; wire16: int16; wire24: int32), ``inbox_alive`` bool.  Rows
    [N]: ``self_inc`` int32, ``alive_here`` bool, ``slot_of_node`` int32
    (each row's self column in [0, K), -1 for none; at most one per row).
    ``out``: four [N, Kb] views (status, inc, spread_until,
    suspect_deadline dtypes), and a fifth int32 one for the epoch lane in
    the epoch form, that receive the new planes, overlapping no input;
    fresh planes when None.  ``armed_rounds``: [N] int32 rounds to DEAD a
    row arms (None: ``suspicion_rounds``); ``dead_suppress_rounds``: the
    suppression window, 0 = off.  ``epoch``: the raw [N, Kb] int32
    identity-epoch lane, with ``own_epoch`` [N] int32 (the epoch form;
    None: the epoch-free form).  Returns new ``(status, inc,
    spread_until, suspect_deadline, self_inc, refuted)``, and the new
    epoch lane after them in the epoch form; a row whose self column lies
    outside the block keeps its ``self_inc`` and is not refuted.
    """
    fmt = delivery.resolve_format(fmt)
    planes = (status, inc, spread_until, suspect_deadline, inbox,
              inbox_alive)
    fresh = out is None
    lanes = planes[:4] if epoch is None else planes[:4] + (epoch,)
    if fresh:
        out = tuple(torch.empty(status.shape, dtype=t.dtype,
                                device=status.device) for t in lanes)
    out = tuple(out)
    if len(out) != len(lanes):
        raise ValueError(f"out must hold {len(lanes)} views (got "
                         f"{len(out)})")
    if (epoch is None) != (own_epoch is None):
        raise ValueError("the epoch form takes both epoch and own_epoch")
    if dead_suppress_rounds < 0:
        raise ValueError(f"dead_suppress_rounds must be >= 0 (got "
                         f"{dead_suppress_rounds})")
    strides = _check(fmt, planes, out, self_inc, alive_here, slot_of_node,
                     armed_rounds, epoch, own_epoch)
    scalars = (round_idx, suspicion_rounds, periods_to_spread, inc_sat)
    name = NAMES[fmt.name]
    if on_cpu(name, status.device):
        got = merge_and_timers_reference(
            *planes, self_inc, alive_here, slot_of_node, *scalars, fmt=fmt,
            col0=col0, armed_rounds=armed_rounds,
            dead_suppress_rounds=dead_suppress_rounds, epoch=epoch,
            own_epoch=own_epoch)
        if fresh:
            return got
        for view, value in zip(out, got[:4] + got[6:]):
            view.copy_(value)
        return (*out[:4], *got[4:6], *out[4:])
    n, kb = status.shape
    rows = (torch.empty_like(self_inc), torch.empty_like(alive_here))
    ins = (*planes, self_inc, alive_here, slot_of_node)

    def ptr(t):
        return None if t is None else t.data_ptr()

    launch(name, _launcher(fmt.name), status.device,
           *(t.data_ptr() for t in ins), ptr(armed_rounds), ptr(epoch),
           ptr(own_epoch), *(t.data_ptr() for t in out[:4] + rows),
           ptr(out[4] if epoch is not None else None), n, kb, col0,
           (ctypes.c_longlong * 12)(*strides),
           *(i32(s) for s in scalars), i32(dead_suppress_rounds))
    return (*out[:4], *rows, *out[4:])
