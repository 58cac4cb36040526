"""The provenance plane's round: the CUDA kernel's wrapper and its plain
PyTorch version.

:func:`provenance_observe` is the third front end of
``csrc/trace_record.cu``'s single-pass compaction (beside
``kernels/trace.trace_observe`` and ``trace_record``), one launch a
round.  It replaces the reference's XLA round of
``scalecube_cluster_tpu/models/provenance.py`` (``observe_round``:
``round_channel_records`` :184-223, with ``telemetry/trace``'s code
derivation and the ``attribute_channels`` cascade :135-181, then
``record_attributions`` :236-321); the reference has no Pallas kernel
there.  Each cell's transition code is derived from the round's two
stored status planes (and epoch lanes) as the trace derives it, the self
cell of a row that bumped its own incarnation codes ALIVE_REFUTED, and
each event's channel is the cascade over the round's three exposed key
planes read at that cell; the rows ``(observer, subject, epoch,
transition, channel, round)`` land in cell order in the plane's
``[capacity, 6]`` lanes, with ``count`` and ``dropped`` advanced on the
device.  On CPU tensors the plain version runs; a CUDA tensor launches
the kernel or raises.

No single PyTorch library call computes the function, so the kernel has
no library yardstick.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from scalecube_cluster_tpu_torch.kernels import check_args, i32, launch
from scalecube_cluster_tpu_torch.kernels import on_cpu
from scalecube_cluster_tpu_torch.kernels import trace as trace_kernel
from scalecube_cluster_tpu_torch.telemetry.events import TraceEventType

NAME = "provenance_observe"
N_LANES = 6

# Channel codes, in the cascade's priority order (models/provenance.py).
CH_FD_DIRECT = 0
CH_PINGREQ_PROXY = 1
CH_GOSSIP = 2
CH_SYNC = 3
CH_SELF_REFUTATION = 4
CH_JOIN_REBIRTH = 5

_KEY_DTYPES = (torch.int32, torch.int16)


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------


def channel_cascade(fd, gossip, sync, ping_req, codes, join_now,
                    dead_bit: int):
    """[N, K] int8 channel of every cell: the reference's where-cascade,
    least specific first.  ``fd``/``gossip``/``sync`` [N, K] wire keys;
    ``ping_req`` [N] bool splits an FD win into direct and proxy (None:
    no ping-req members, always direct); ``codes`` [N, K] int8 (REMOVED
    with a winner that is not a DEAD key is the local timer: FD);
    ``join_now`` [N, K] or [1, K] bool (JOIN_REBIRTH over all); a DEAD
    key has ``dead_bit`` set."""
    fd, gossip, sync = (x.to(torch.int32) for x in (fd, gossip, sync))
    winner = torch.maximum(fd, torch.maximum(sync, gossip))
    chan = torch.full(codes.shape, CH_FD_DIRECT, dtype=torch.int8,
                      device=codes.device)
    chan = chan.masked_fill((gossip >= 0) & (gossip == winner), CH_GOSSIP)
    chan = chan.masked_fill((sync >= 0) & (sync == winner), CH_SYNC)
    fd_wins = (fd >= 0) & (fd == winner)
    if ping_req is None:
        chan = chan.masked_fill(fd_wins, CH_FD_DIRECT)
    else:
        fd_code = torch.where(ping_req[:, None],
                              torch.tensor(CH_PINGREQ_PROXY, dtype=torch.int8,
                                           device=codes.device),
                              torch.tensor(CH_FD_DIRECT, dtype=torch.int8,
                                           device=codes.device))
        chan = torch.where(fd_wins, fd_code, chan)
    w_dead = (winner >= 0) & (((winner >> dead_bit) & 1) == 1)
    timer_fired = (codes == int(TraceEventType.REMOVED) + 1) & ~w_dead
    chan = chan.masked_fill(timer_fired, CH_FD_DIRECT)
    return chan.masked_fill(join_now, CH_JOIN_REBIRTH)


def provenance_record_reference(lanes, count, dropped, codes, channels,
                                epochs, subject_ids, round_idx: int,
                                observer_offset: int = 0) -> None:
    """Record one round's attributed cells (``codes > 0``, [N, K] int8)
    into ``lanes`` [capacity, 6] int32, in place: the round's e-th cell
    (cell order) writes ``(observer_offset + row, subject_ids[col],
    epochs, code - 1, channels, round_idx)`` at slot ``count + e`` while
    that slot is below the capacity; ``count`` becomes ``min(count +
    total, capacity)`` and ``dropped`` grows by the rest (the reference's
    exact-path accounting).  ``nonzero`` reads the count to the host."""
    cap, k = lanes.shape[0], codes.shape[1]
    flat = codes.reshape(-1)
    has = flat > 0
    prefix = torch.cumsum(has, dim=0, dtype=torch.int32)
    cells = torch.nonzero(has).squeeze(1)
    slot = count.to(torch.int64) + prefix[cells].to(torch.int64) - 1
    keep = slot < cap
    cells, slot = cells[keep], slot[keep]
    rows = torch.stack([
        cells // k + observer_offset,
        subject_ids.to(torch.int64)[cells % k],
        epochs.reshape(-1)[cells].to(torch.int64),
        flat[cells].to(torch.int64) - 1,
        channels.reshape(-1)[cells].to(torch.int64),
        torch.full_like(cells, i32(round_idx)),
    ], dim=1).to(torch.int32)
    lanes[slot] = rows
    total = prefix[-1] if prefix.numel() else torch.zeros_like(count)
    new_count = torch.clamp(count + total, max=cap)
    dropped.add_(total - (new_count - count))
    count.copy_(new_count)


def provenance_observe_reference(lanes, count, dropped, prev_status,
                                 new_status, fd, gossip, sync, ping_req,
                                 prev_self_inc, new_self_inc, leave_at,
                                 join_at, subject_ids, round_idx: int,
                                 observer_offset: int = 0,
                                 dead_bit: int = 30,
                                 split_ping_req: bool = False,
                                 prev_epoch=None, new_epoch=None,
                                 is_self=None) -> None:
    """Plain version of :func:`provenance_observe`: the trace's eager
    derivation, the cascade, the self-refutation overlay, then
    :func:`provenance_record_reference`."""
    n = prev_status.shape[0]
    if is_self is None:
        is_self = trace_kernel.self_mask(subject_ids, n, observer_offset)
    leaving_now = (leave_at == i32(round_idx))[:, None] & is_self
    codes, _ = trace_kernel.derive_event_codes(
        prev_status, None, new_status, None, is_self, leaving_now, None,
        prev_epoch=prev_epoch, new_epoch=new_epoch)
    join_now = (join_at[subject_ids.long()] == i32(round_idx))[None, :]
    channels = channel_cascade(fd, gossip, sync,
                               ping_req if split_ping_req else None, codes,
                               join_now, dead_bit)
    refuted = new_self_inc.to(torch.int32) > prev_self_inc.to(torch.int32)
    self_refute = is_self & refuted[:, None] & (codes == 0)
    codes = codes.masked_fill(self_refute,
                              int(TraceEventType.ALIVE_REFUTED) + 1)
    channels = channels.masked_fill(self_refute, CH_SELF_REFUTATION)
    epochs = (new_epoch.to(torch.int32) if prev_epoch is not None
              else torch.zeros(codes.shape, dtype=torch.int32,
                               device=codes.device))
    provenance_record_reference(lanes, count, dropped, codes, channels,
                                epochs, subject_ids, round_idx,
                                observer_offset)


# --------------------------------------------------------------------------
# The kernel
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = trace_kernel._library().provenance_observe_launch
    fn.argtypes = ([ctypes.c_void_p] * 17
                   + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_longlong] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def provenance_observe(lanes, count, dropped, prev_status, new_status, fd,
                       gossip, sync, ping_req, prev_self_inc, new_self_inc,
                       leave_at, join_at, subject_ids, round_idx: int,
                       observer_offset: int = 0, dead_bit: int = 30,
                       split_ping_req: bool = False, prev_epoch=None,
                       new_epoch=None, is_self=None) -> None:
    """Attribute and record one round, in place.  ``prev_status`` /
    ``new_status`` [N, K] int8 (the stored carries before and after the
    round), ``prev_epoch`` / ``new_epoch`` [N, K] int32 or int16 (one
    dtype; None or zero-size: no epoch lane, rows carry epoch 0) derive
    the codes as ``kernels/trace.derive_event_codes`` does with the self
    cells ``subject_ids[col] == row + observer_offset`` and ``leave_at``
    [N] int32; the self cell of a row whose ``new_self_inc`` exceeds
    ``prev_self_inc`` ([N] int32) codes ALIVE_REFUTED (channel
    SELF_REFUTATION) unless it leaves.  Each event's channel is
    :func:`channel_cascade` over ``fd``, ``gossip``, ``sync`` ([N, K],
    int32 or int16, one dtype) with ``ping_req`` [N] bool when
    ``split_ping_req``, ``join_at`` [world N] int32 (JOIN_REBIRTH where
    ``join_at[subject] == round_idx``) and the wire format's
    ``dead_bit``.  The rows ``(observer, subject, epoch, code - 1,
    channel, round)`` go to ``lanes`` [capacity, 6] int32 as
    :func:`provenance_record_reference` writes them; ``count`` and
    ``dropped`` (0-dim int32) move on the device.  ``is_self`` (the
    [N, K] self mask, if the caller holds one) is read by the plain
    version only."""
    device = prev_status.device
    n, k = prev_status.shape
    if fd.dtype not in _KEY_DTYPES:
        raise TypeError(f"{NAME}: fd must be torch.int32 or torch.int16, "
                        f"got {fd.dtype}")
    check_args(NAME, device, (n, k),
               dict(prev_status=(prev_status, torch.int8),
                    new_status=(new_status, torch.int8),
                    fd=(fd, fd.dtype), gossip=(gossip, fd.dtype),
                    sync=(sync, fd.dtype)))
    check_args(NAME, device, (n,),
               dict(ping_req=(ping_req, torch.bool),
                    prev_self_inc=(prev_self_inc, torch.int32),
                    new_self_inc=(new_self_inc, torch.int32),
                    leave_at=(leave_at, torch.int32)))
    check_args(NAME, device, (join_at.shape[0],),
               dict(join_at=(join_at, torch.int32)))
    check_args(NAME, device, (k,), dict(subject_ids=(subject_ids,
                                                     torch.int32)))
    check_args(NAME, device, (lanes.shape[0], N_LANES),
               dict(lanes=(lanes, torch.int32)))
    check_args(NAME, device, (), dict(count=(count, torch.int32),
                                      dropped=(dropped, torch.int32)))
    if n * k > trace_kernel.MAX_CELLS:
        raise ValueError(f"{NAME}: {n} x {k} cells exceed int32 indexing")
    if prev_epoch is not None and prev_epoch.numel() == 0:
        prev_epoch = new_epoch = None
    epoch_bytes = 0
    if prev_epoch is not None:
        if prev_epoch.dtype not in _KEY_DTYPES:
            raise TypeError(f"{NAME}: prev_epoch must be torch.int32 or "
                            f"torch.int16, got {prev_epoch.dtype}")
        check_args(NAME, device, (n, k),
                   dict(prev_epoch=(prev_epoch, prev_epoch.dtype),
                        new_epoch=(new_epoch, prev_epoch.dtype)))
        epoch_bytes = prev_epoch.element_size()
    if not 0 < dead_bit < 8 * fd.element_size() - 1:
        raise ValueError(f"{NAME}: dead_bit {dead_bit} outside the "
                         f"{fd.dtype} key")
    if on_cpu(NAME, device):
        provenance_observe_reference(
            lanes, count, dropped, prev_status, new_status, fd, gossip, sync,
            ping_req, prev_self_inc, new_self_inc, leave_at, join_at,
            subject_ids, round_idx, observer_offset, dead_bit,
            split_ping_req, prev_epoch, new_epoch, is_self)
        return
    launch(NAME, _launcher(), device,
           prev_status.data_ptr(), new_status.data_ptr(), fd.data_ptr(),
           gossip.data_ptr(), sync.data_ptr(),
           prev_epoch.data_ptr() if epoch_bytes else None,
           new_epoch.data_ptr() if epoch_bytes else None,
           prev_self_inc.data_ptr(), new_self_inc.data_ptr(),
           leave_at.data_ptr(), join_at.data_ptr(), ping_req.data_ptr(),
           subject_ids.data_ptr(), lanes.data_ptr(), count.data_ptr(),
           dropped.data_ptr(), *trace_kernel._scratch(device, n * k),
           n * k, k, lanes.shape[0], i32(round_idx), i32(observer_offset),
           fd.element_size(), epoch_bytes, dead_bit, int(split_ping_req))

