"""The membership trace's record: the CUDA kernels' wrappers and their
plain PyTorch versions.

One source, ``csrc/trace_record.cu``, two front ends over one
single-pass compaction (the reference's XLA trace,
``scalecube_cluster_tpu/telemetry/trace.py``):

  - :func:`trace_observe`, the traced round's one launch: each cell's
    transition code derived from the round's two stored carries
    (``derive_event_codes``, :166-241), the first-suspect/first-removed
    rounds stamped (``update_first_rounds``, :326-341), and the events
    recorded (``record_events_batch``, :254-301), with no code plane, no
    prefix and no first-round pass in device memory;
  - :func:`trace_record`, the codes-in record behind ``record_events``
    and the invariant monitor's evidence (``chaos/monitor.record_round``:
    one plane a code, and with ``subject_ids=None`` the self lanes, each
    row's subject its observer);
  - :func:`trace_observe_batch` and :func:`trace_record_batch`, the two
    over a batch of B rounds of one shape (the batched runner's planes,
    ``models/compose.composed_batch_scan``): row b's planes, vectors,
    buffer and counters at index b, each row recorded into its own
    buffer with its own overflow, in one launch.  Their plain versions
    are the one-round plain versions looped over the rows.

Both compact their events into the trace's lanes in cell order and
advance its ``count`` and ``dropped`` in place, all on the device.  On
CPU tensors the plain versions below run; a CUDA tensor launches the
kernel or raises.  The plain versions are the eager composition the
reference writes: :func:`derive_event_codes`,
:func:`update_first_round_matrices` and :func:`trace_record_reference`
with the slots from :func:`event_prefix`.

No single PyTorch library call computes either function, so the kernels
have no library yardstick.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from scalecube_cluster_tpu_torch import records
from scalecube_cluster_tpu_torch.kernels import _build, check_args, i32
from scalecube_cluster_tpu_torch.kernels import launch, on_cpu
from scalecube_cluster_tpu_torch.telemetry.events import TraceEventType

SOURCE = "trace_record"
NAME = "trace_record"
OBSERVE = "trace_observe"
RECORD_BATCH = "trace_record_batch"
OBSERVE_BATCH = "trace_observe_batch"
N_LANES = 5
INT32_MAX = 2**31 - 1
# The flattened [N, K] index, the slots and the rows' observer are int32.
MAX_CELLS = 2**31 - 1
_INC_DTYPES = (torch.int32, torch.int16)


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------


def derive_event_codes(prev_status, prev_inc, new_status, new_inc,
                       is_self, leaving_now, self_inc,
                       prev_epoch=None, new_epoch=None):
    """``(codes, incarnations)`` of this round's net cell transitions.

    ``codes`` [N, K] int8: 0 = no event, else ``TraceEventType`` + 1.  The
    (prev, new) status pair gives at most one transition per cell:

      ABSENT/DEAD -> ALIVE   ADDED
      !SUSPECT    -> SUSPECT SUSPECTED
      SUSPECT     -> ALIVE   ALIVE_REFUTED
      !DEAD       -> DEAD    REMOVED

    Self cells never transition; the one self event is LEAVING, from the
    world's leave schedule (``leaving_now``), with incarnation
    ``self_inc + 1``.  With ``prev_epoch``/``new_epoch`` (the open-world
    epoch lane; None when off), a cell whose stored epoch advanced to a
    live record codes JOINED, which wins over every status code.  The
    masks are disjoint, so the codes are one weighted sum.  ``prev_inc``
    is unused (the reference's signature); with ``new_inc`` None the
    incarnations are not derived (None)."""
    prev, new = prev_status, new_status
    added = (((prev == records.ABSENT) | (prev == records.DEAD))
             & (new == records.ALIVE))
    suspected = (new == records.SUSPECT) & (prev != records.SUSPECT)
    refuted = (prev == records.SUSPECT) & (new == records.ALIVE)
    removed = (new == records.DEAD) & (prev != records.DEAD)

    joined = None
    if prev_epoch is not None and prev_epoch.numel():
        joined = ((new_epoch.to(torch.int32) > prev_epoch.to(torch.int32))
                  & ((new == records.ALIVE) | (new == records.SUSPECT)))
        not_joined = ~joined
        added &= not_joined
        suspected &= not_joined
        refuted &= not_joined
        removed &= not_joined

    def weighted(mask, event):
        return mask.to(torch.int8) * (int(event) + 1)

    code = (weighted(added, TraceEventType.ADDED)
            + weighted(suspected, TraceEventType.SUSPECTED)
            + weighted(refuted, TraceEventType.ALIVE_REFUTED)
            + weighted(removed, TraceEventType.REMOVED))
    if joined is not None:
        code = code + weighted(joined, TraceEventType.JOINED)
    code = code.masked_fill(is_self, 0)
    code = code.masked_fill(leaving_now, int(TraceEventType.LEAVING) + 1)

    if new_inc is None:
        return code.to(torch.int8), None
    inc = new_inc.to(torch.int32)
    inc = torch.where(leaving_now, self_inc.to(torch.int32)[:, None] + 1,
                      inc)
    return code.to(torch.int8), inc


def update_first_round_matrices(first_suspect, first_removed, codes,
                                round_idx: int) -> None:
    """Stamp ``round_idx`` into ``first_suspect`` / ``first_removed``
    ([N, K] int32, in place) at this round's SUSPECTED / REMOVED cells
    that still hold INT32_MAX."""
    for first, event in ((first_suspect, TraceEventType.SUSPECTED),
                         (first_removed, TraceEventType.REMOVED)):
        first.masked_fill_((codes == int(event) + 1) & (first == INT32_MAX),
                           i32(round_idx))


def event_prefix(codes: torch.Tensor) -> torch.Tensor:
    """[N * K] int32 inclusive prefix sum of ``codes > 0`` in cell order:
    each event cell's 1-based rank among the round's events."""
    return torch.cumsum(codes.reshape(-1) > 0, dim=0, dtype=torch.int32)


def trace_record_reference(lanes, count, dropped, codes, incs, subject_ids,
                           round_idx: int, observer_offset: int) -> None:
    """Plain version of :func:`trace_record`: the slots from
    :func:`event_prefix` (``nonzero`` reads the event count to the
    host)."""
    cap, k = lanes.shape[0], codes.shape[1]
    flat = codes.reshape(-1)
    prefix = event_prefix(codes)
    cells = torch.nonzero(flat > 0).squeeze(1)
    slot = count.to(torch.int64) + prefix[cells].to(torch.int64) - 1
    keep = slot < cap
    cells, slot = cells[keep], slot[keep]
    observer = cells // k + observer_offset
    rows = torch.stack([
        torch.full_like(cells, i32(round_idx)),
        observer,
        observer if subject_ids is None
        else subject_ids[cells % k].to(torch.int64),
        flat[cells].to(torch.int64) - 1,
        incs.reshape(-1)[cells].to(torch.int64),
    ], dim=1).to(torch.int32)
    lanes[slot] = rows
    total = prefix[-1] if prefix.numel() else torch.zeros_like(count)
    new_count = torch.clamp(count + total, max=cap)
    dropped.add_(total - (new_count - count))
    count.copy_(new_count)


def self_mask(subject_ids, n: int, observer_offset: int = 0):
    """[N, K] bool: cell (i, k) is observer ``i + observer_offset``'s
    record of itself (``subject_ids[k] == i + observer_offset``)."""
    node_ids = torch.arange(n, dtype=torch.int32,
                            device=subject_ids.device) + observer_offset
    return subject_ids[None, :] == node_ids[:, None]


def trace_observe_reference(lanes, count, dropped, first_suspect,
                            first_removed, prev_status, new_status, new_inc,
                            self_inc, leave_at, subject_ids, round_idx: int,
                            observer_offset: int = 0, prev_epoch=None,
                            new_epoch=None, is_self=None) -> None:
    """Plain version of :func:`trace_observe`: the eager derivation, the
    first-round stamps, then :func:`trace_record_reference`.  ``is_self``
    may pass in :func:`self_mask` (it depends on the world alone)."""
    if is_self is None:
        is_self = self_mask(subject_ids, prev_status.shape[0],
                            observer_offset)
    leaving_now = (leave_at == i32(round_idx))[:, None] & is_self
    codes, incs = derive_event_codes(
        prev_status, None, new_status, new_inc, is_self, leaving_now,
        self_inc, prev_epoch=prev_epoch, new_epoch=new_epoch)
    update_first_round_matrices(first_suspect, first_removed, codes,
                                round_idx)
    trace_record_reference(lanes, count, dropped, codes, incs, subject_ids,
                           round_idx, observer_offset)


def trace_record_batch_reference(lanes, count, dropped, codes, incs,
                                 subject_ids, round_idx: int,
                                 observer_offset: int = 0) -> None:
    """Plain version of :func:`trace_record_batch`: :func:`trace_record_
    reference` on each row."""
    for b in range(codes.shape[0]):
        trace_record_reference(
            lanes[b], count[b], dropped[b], codes[b], incs[b],
            None if subject_ids is None else subject_ids[b], round_idx,
            observer_offset)


def trace_observe_batch_reference(lanes, count, dropped, first_suspect,
                                  first_removed, prev_status, new_status,
                                  new_inc, self_inc, leave_at, subject_ids,
                                  round_idx: int, observer_offset: int = 0,
                                  prev_epoch=None, new_epoch=None) -> None:
    """Plain version of :func:`trace_observe_batch`:
    :func:`trace_observe_reference` on each row."""
    for b in range(prev_status.shape[0]):
        trace_observe_reference(
            lanes[b], count[b], dropped[b], first_suspect[b],
            first_removed[b], prev_status[b], new_status[b], new_inc[b],
            self_inc[b], leave_at[b], subject_ids[b], round_idx,
            observer_offset,
            None if prev_epoch is None else prev_epoch[b],
            None if new_epoch is None else new_epoch[b])


# --------------------------------------------------------------------------
# The kernels
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load(SOURCE)
    lib.trace_tile_cells.argtypes = []
    lib.trace_tile_cells.restype = ctypes.c_int
    lib.trace_observe_launch.argtypes = (
        [ctypes.c_void_p] * 14
        + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
           ctypes.c_longlong]
        + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.trace_observe_launch.restype = ctypes.c_int
    lib.trace_record_launch.argtypes = (
        [ctypes.c_void_p] * 7
        + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
           ctypes.c_longlong]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.trace_record_launch.restype = ctypes.c_int
    lib.trace_observe_batch_launch.argtypes = (
        [ctypes.c_void_p] * 14
        + [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_longlong]
        + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.trace_observe_batch_launch.restype = ctypes.c_int
    lib.trace_record_batch_launch.argtypes = (
        [ctypes.c_void_p] * 7
        + [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_longlong]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.trace_record_batch_launch.restype = ctypes.c_int
    return lib


_SCRATCH = {}


@functools.lru_cache(maxsize=None)
def _tile_cells() -> int:
    """The cells of the kernels' smaller tile."""
    return _library().trace_tile_cells()


def _scratch(device: torch.device, n_cells: int):
    """The kernels' scratch on ``device`` and the tiles it holds: the
    tile counter, the generation, one descriptor a tile and two banks of
    group totals (at most one a tile each, over a tile of room), int64,
    zeroed once and reused by every launch (a larger launch allocates a
    larger one)."""
    tiles = -(-n_cells // _tile_cells())
    held = _SCRATCH.get(device)
    if held is None or (held.numel() - 4) // 2 < tiles:
        held = torch.zeros((4 + 2 * tiles,), dtype=torch.int64, device=device)
        _SCRATCH[device] = held
    return held.data_ptr(), (held.numel() - 4) // 2


_BATCH_SCRATCH = {}


def _batch_scratch(device: torch.device, batch: int, n_cells: int):
    """The batch forms' scratch on ``device``: four words, one descriptor
    a tile and two banks of group totals, a row's tiles and groups times
    ``batch`` at least, int64, zeroed once and reused (a larger launch
    allocates a larger one, zeroed).  Returns ``(pointer, tiles,
    groups)``; every launch sharing it passes the same bank size."""
    row_tiles = -(-n_cells // _tile_cells())
    tiles, groups = batch * row_tiles, batch * -(-row_tiles // 32)
    held = _BATCH_SCRATCH.get(device)
    if held is None or held[1] < tiles or held[2] < groups:
        tiles = max(tiles, held[1] if held else 0)
        groups = max(groups, held[2] if held else 0)
        held = (torch.zeros((4 + tiles + 2 * groups,), dtype=torch.int64,
                            device=device), tiles, groups)
        _BATCH_SCRATCH[device] = held
    return held[0].data_ptr(), held[1], held[2]


def _check_common(kernel, device, n, k, lanes, count, dropped, subject_ids):
    if n * k > MAX_CELLS:
        raise ValueError(f"{kernel}: {n} x {k} cells exceed int32 "
                         f"indexing")
    if subject_ids is None:
        if k != 1:
            raise ValueError(f"{kernel}: without subject_ids the codes "
                             f"must be [N, 1] (the self lanes), got "
                             f"{n} x {k}")
    else:
        check_args(kernel, device, (k,),
                   dict(subject_ids=(subject_ids, torch.int32)))
    check_args(kernel, device, (lanes.shape[0], N_LANES),
               dict(lanes=(lanes, torch.int32)))
    check_args(kernel, device, (), dict(count=(count, torch.int32),
                                        dropped=(dropped, torch.int32)))


def _inc_dtype(kernel, name, t):
    if t.dtype not in _INC_DTYPES:
        raise TypeError(f"{kernel}: {name} must be torch.int32 or "
                        f"torch.int16, got {t.dtype}")
    return t.dtype


def trace_record(lanes, count, dropped, codes, incs, subject_ids,
                 round_idx: int, observer_offset: int = 0) -> None:
    """Record one round: every cell with ``codes > 0`` ([N, K] int8, the
    event type + 1) becomes the row ``(round, observer_offset + row,
    subject_ids[col], code - 1, incs[row, col])`` of ``lanes``
    ([capacity, 5] int32) at slot ``count + e`` for the round's e-th
    event (cell order) while that slot is below the capacity; then
    ``count`` becomes ``min(count + total, capacity)`` and ``dropped``
    grows by the events that did not fit (``count``/``dropped`` 0-dim
    int32, updated in place).  ``incs`` [N, K] int32 or int16;
    ``subject_ids`` [K] int32, or None for the self lanes: ``codes`` and
    ``incs`` [N, 1] and each row's subject its observer (the invariant
    monitor's self-incarnation evidence)."""
    device = codes.device
    n, k = codes.shape
    inc_dtype = _inc_dtype(NAME, "incs", incs)
    check_args(NAME, device, (n, k), dict(codes=(codes, torch.int8),
                                          incs=(incs, inc_dtype)))
    _check_common(NAME, device, n, k, lanes, count, dropped, subject_ids)
    if on_cpu(NAME, device):
        trace_record_reference(lanes, count, dropped, codes, incs,
                               subject_ids, round_idx, observer_offset)
        return
    launch(NAME, _library().trace_record_launch, device, codes.data_ptr(),
           incs.data_ptr(),
           None if subject_ids is None else subject_ids.data_ptr(),
           lanes.data_ptr(),
           count.data_ptr(), dropped.data_ptr(), *_scratch(device, n * k),
           n * k, k, lanes.shape[0], i32(round_idx), i32(observer_offset),
           incs.element_size())


def trace_observe(lanes, count, dropped, first_suspect, first_removed,
                  prev_status, new_status, new_inc, self_inc, leave_at,
                  subject_ids, round_idx: int, observer_offset: int = 0,
                  prev_epoch=None, new_epoch=None, is_self=None) -> None:
    """Observe one round, in place: derive each cell's transition code
    from ``prev_status``/``new_status`` ([N, K] int8, the carries before
    and after the round), ``new_inc`` ([N, K] int32 or int16), the epoch
    lanes ``prev_epoch``/``new_epoch`` ([N, K] int32 or int16, one dtype;
    None or zero-size: no JOINED), ``self_inc`` [N] int32 and
    ``leave_at`` [N] int32 (the world's rows ``observer_offset`` to
    ``observer_offset + N``) as :func:`derive_event_codes` does with the
    self cells ``subject_ids[col] == row + observer_offset``; stamp
    ``round_idx`` into ``first_suspect``/``first_removed`` ([N, K]
    int32) where a SUSPECTED/REMOVED cell holds INT32_MAX; record the
    events as :func:`trace_record` does.  ``is_self``, the [N, K]
    :func:`self_mask` if the caller holds one, is read by the plain
    version only."""
    device = prev_status.device
    n, k = prev_status.shape
    inc_dtype = _inc_dtype(OBSERVE, "new_inc", new_inc)
    check_args(OBSERVE, device, (n, k),
               dict(prev_status=(prev_status, torch.int8),
                    new_status=(new_status, torch.int8),
                    new_inc=(new_inc, inc_dtype),
                    first_suspect=(first_suspect, torch.int32),
                    first_removed=(first_removed, torch.int32)))
    check_args(OBSERVE, device, (n,), dict(self_inc=(self_inc, torch.int32),
                                           leave_at=(leave_at, torch.int32)))
    _check_common(OBSERVE, device, n, k, lanes, count, dropped, subject_ids)
    if prev_epoch is not None and prev_epoch.numel() == 0:
        prev_epoch = new_epoch = None
    epoch_bytes = 0
    if prev_epoch is not None:
        epoch_dtype = _inc_dtype(OBSERVE, "prev_epoch", prev_epoch)
        check_args(OBSERVE, device, (n, k),
                   dict(prev_epoch=(prev_epoch, epoch_dtype),
                        new_epoch=(new_epoch, epoch_dtype)))
        epoch_bytes = prev_epoch.element_size()
    if on_cpu(OBSERVE, device):
        trace_observe_reference(
            lanes, count, dropped, first_suspect, first_removed, prev_status,
            new_status, new_inc, self_inc, leave_at, subject_ids, round_idx,
            observer_offset, prev_epoch, new_epoch, is_self)
        return
    launch(OBSERVE, _library().trace_observe_launch, device,
           prev_status.data_ptr(), new_status.data_ptr(), new_inc.data_ptr(),
           prev_epoch.data_ptr() if epoch_bytes else None,
           new_epoch.data_ptr() if epoch_bytes else None,
           self_inc.data_ptr(), leave_at.data_ptr(), subject_ids.data_ptr(),
           first_suspect.data_ptr(), first_removed.data_ptr(),
           lanes.data_ptr(), count.data_ptr(), dropped.data_ptr(),
           *_scratch(device, n * k), n * k, k, lanes.shape[0],
           i32(round_idx), i32(observer_offset), new_inc.element_size(),
           epoch_bytes)


def _check_batch_common(kernel, device, b, n, k, lanes, count, dropped,
                        subject_ids):
    if n * k > MAX_CELLS:
        raise ValueError(f"{kernel}: {n} x {k} cells a row exceed int32 "
                         f"indexing")
    if subject_ids is None:
        if k != 1:
            raise ValueError(f"{kernel}: without subject_ids the codes "
                             f"must be [B, N, 1] (the self lanes), got "
                             f"{b} x {n} x {k}")
    else:
        check_args(kernel, device, (b, k),
                   dict(subject_ids=(subject_ids, torch.int32)))
    if lanes.dim() != 3:
        raise ValueError(f"{kernel}: lanes must be [B, capacity, "
                         f"{N_LANES}], got {tuple(lanes.shape)}")
    check_args(kernel, device, (b, lanes.shape[1], N_LANES),
               dict(lanes=(lanes, torch.int32)))
    check_args(kernel, device, (b,), dict(count=(count, torch.int32),
                                          dropped=(dropped, torch.int32)))


def trace_record_batch(lanes, count, dropped, codes, incs, subject_ids,
                       round_idx: int, observer_offset: int = 0) -> None:
    """:func:`trace_record` over a batch of B rounds of one shape, in one
    launch: row b records ``codes[b]`` ([B, N, K] int8) with
    ``incs[b]`` ([B, N, K] int32 or int16) and ``subject_ids[b]`` ([B, K]
    int32; None for the self lanes, codes [B, N, 1]) into ``lanes[b]``
    ([B, capacity, 5] int32) from slot ``count[b]``, moving ``count[b]``
    and ``dropped[b]`` ([B] int32) as :func:`trace_record` does."""
    device = codes.device
    if codes.dim() != 3:
        raise ValueError(f"{RECORD_BATCH}: codes must be [B, N, K], got "
                         f"{tuple(codes.shape)}")
    b, n, k = codes.shape
    inc_dtype = _inc_dtype(RECORD_BATCH, "incs", incs)
    check_args(RECORD_BATCH, device, (b, n, k),
               dict(codes=(codes, torch.int8), incs=(incs, inc_dtype)))
    _check_batch_common(RECORD_BATCH, device, b, n, k, lanes, count,
                        dropped, subject_ids)
    if on_cpu(RECORD_BATCH, device):
        trace_record_batch_reference(lanes, count, dropped, codes, incs,
                                     subject_ids, round_idx, observer_offset)
        return
    launch(RECORD_BATCH, _library().trace_record_batch_launch, device,
           codes.data_ptr(), incs.data_ptr(),
           None if subject_ids is None else subject_ids.data_ptr(),
           lanes.data_ptr(), count.data_ptr(), dropped.data_ptr(),
           *_batch_scratch(device, b, n * k), b, n * k, k, lanes.shape[1],
           i32(round_idx), i32(observer_offset), incs.element_size())


def trace_observe_batch(lanes, count, dropped, first_suspect, first_removed,
                        prev_status, new_status, new_inc, self_inc, leave_at,
                        subject_ids, round_idx: int,
                        observer_offset: int = 0, prev_epoch=None,
                        new_epoch=None) -> None:
    """:func:`trace_observe` over a batch of B rounds of one shape, in one
    launch: row b observes ``prev_status[b]``/``new_status[b]`` ([B, N,
    K] int8), ``new_inc[b]``, the epoch lanes' rows (each [B, N, K], or
    None), ``self_inc[b]``/``leave_at[b]`` ([B, N] int32) and
    ``subject_ids[b]`` ([B, K] int32), stamping ``first_suspect[b]``/
    ``first_removed[b]`` ([B, N, K] int32) and recording into
    ``lanes[b]`` ([B, capacity, 5]) with ``count[b]``/``dropped[b]``
    ([B] int32), as :func:`trace_observe` does for one round."""
    device = prev_status.device
    if prev_status.dim() != 3:
        raise ValueError(f"{OBSERVE_BATCH}: prev_status must be [B, N, K], "
                         f"got {tuple(prev_status.shape)}")
    b, n, k = prev_status.shape
    inc_dtype = _inc_dtype(OBSERVE_BATCH, "new_inc", new_inc)
    check_args(OBSERVE_BATCH, device, (b, n, k),
               dict(prev_status=(prev_status, torch.int8),
                    new_status=(new_status, torch.int8),
                    new_inc=(new_inc, inc_dtype),
                    first_suspect=(first_suspect, torch.int32),
                    first_removed=(first_removed, torch.int32)))
    check_args(OBSERVE_BATCH, device, (b, n),
               dict(self_inc=(self_inc, torch.int32),
                    leave_at=(leave_at, torch.int32)))
    _check_batch_common(OBSERVE_BATCH, device, b, n, k, lanes, count,
                        dropped, subject_ids)
    if prev_epoch is not None and prev_epoch.numel() == 0:
        prev_epoch = new_epoch = None
    epoch_bytes = 0
    if prev_epoch is not None:
        epoch_dtype = _inc_dtype(OBSERVE_BATCH, "prev_epoch", prev_epoch)
        check_args(OBSERVE_BATCH, device, (b, n, k),
                   dict(prev_epoch=(prev_epoch, epoch_dtype),
                        new_epoch=(new_epoch, epoch_dtype)))
        epoch_bytes = prev_epoch.element_size()
    if on_cpu(OBSERVE_BATCH, device):
        trace_observe_batch_reference(
            lanes, count, dropped, first_suspect, first_removed, prev_status,
            new_status, new_inc, self_inc, leave_at, subject_ids, round_idx,
            observer_offset, prev_epoch, new_epoch)
        return
    launch(OBSERVE_BATCH, _library().trace_observe_batch_launch, device,
           prev_status.data_ptr(), new_status.data_ptr(), new_inc.data_ptr(),
           prev_epoch.data_ptr() if epoch_bytes else None,
           new_epoch.data_ptr() if epoch_bytes else None,
           self_inc.data_ptr(), leave_at.data_ptr(), subject_ids.data_ptr(),
           first_suspect.data_ptr(), first_removed.data_ptr(),
           lanes.data_ptr(), count.data_ptr(), dropped.data_ptr(),
           *_batch_scratch(device, b, n * k), b, n * k, k, lanes.shape[1],
           i32(round_idx), i32(observer_offset), new_inc.element_size(),
           epoch_bytes)
