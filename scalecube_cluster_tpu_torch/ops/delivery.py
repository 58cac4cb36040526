"""Wire keys, scatter delivery and the inbox merge gate.

Counterpart of ``scalecube_cluster_tpu/ops/delivery.py``: a record
(status + incarnation) packs into one key whose max is the SWIM merge
winner, :func:`scatter_max` / :func:`scatter_or` deliver each sender's
row to its drawn targets (scatter delivery), and :func:`merge_inbox`
applies the entry gate to a round's max-folded inbox.

Wire layout, one signed word: ``[sign 0] [dead] [incarnation] [suspect]``
with the dead bit on top so the max-fold keeps the reference's
DEAD-absorbs order.  The ``WireFormat`` table lists the reference's
three rungs: ``WIDE`` (int32, dead bit 30), ``WIRE24`` (int32, dead bit
23, the compact carry's headroom rung) and ``WIRE16`` (int16, dead bit
14, ``records.merge_key16``).  Every function takes the rung as ``fmt``
(default wide) and keeps keys in its dtype: under ``WIRE16`` every key
tensor is ``torch.int16``.  ALIVE is a key with the dead and suspect
bits clear, so a delivered key carries its own merge-gate flag
(:func:`is_alive_key`).

The open-world plane (``epoch_bits > 0``) carves an identity-epoch field
out of the top of the incarnation field, directly under the dead bit:
``[dead] [epoch] [incarnation] [suspect]``, so the max-fold still lets
DEAD absorb, and within a liveness class a higher epoch outranks any
incarnation of an older occupant.  :func:`merge_inbox` then resolves
identities: a lower-epoch winner drops, a higher-epoch one is admitted
only if it is ALIVE.
"""

from __future__ import annotations

import dataclasses

import torch

from scalecube_cluster_tpu_torch import records

# Inbox key for "no message": below every real record key.
NO_MESSAGE = -1


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """One rung of the wire-format ladder: ``dead_bit`` fixes the layout
    (suspect at bit 0, incarnation at bits 1..dead_bit-1-epoch_bits)."""

    name: str
    dead_bit: int
    epoch_bits: int      # field width when the open-world plane is on
    wide_word: bool      # True: int32 wire word; False: int16

    @property
    def dtype(self) -> torch.dtype:
        return torch.int32 if self.wide_word else torch.int16

    def inc_bits(self, epoch_bits: int = 0) -> int:
        return self.dead_bit - 1 - epoch_bits

    def inc_sat(self, epoch_bits: int = 0) -> int:
        """Largest incarnation the key field carries exactly."""
        return (1 << self.inc_bits(epoch_bits)) - 1

    def epoch_cap(self) -> int:
        return (1 << self.epoch_bits) - 1


WIDE = WireFormat("wide", dead_bit=30, epoch_bits=6, wide_word=True)
WIRE24 = WireFormat("wire24", dead_bit=23, epoch_bits=4, wide_word=True)
WIRE16 = WireFormat("wire16", dead_bit=14, epoch_bits=2, wide_word=False)

WIRE_FORMATS = {f.name: f for f in (WIDE, WIRE24, WIRE16)}


def resolve_format(fmt: WireFormat = None) -> WireFormat:
    """The active :class:`WireFormat` (``None`` = wide)."""
    return WIDE if fmt is None else fmt


def no_message(fmt: WireFormat = None) -> int:
    """The "no message" key, -1 in every format (``fmt`` is accepted for
    the reference's signature).  A Python int takes the dtype of the
    tensor it meets in ``torch.where``, so it never widens an int16 wire
    buffer."""
    return NO_MESSAGE


def pack_record(status, inc, fmt: WireFormat = None, epoch=None,
                epoch_bits: int = 0):
    """(status, incarnation[, epoch]) -> merge key of the wire format, in
    its dtype; ABSENT packs to -1 == :func:`no_message`.  With
    ``epoch_bits > 0`` the epoch (clipped to the field) sits under the
    dead bit and the incarnation saturates at ``inc_sat(epoch_bits)``."""
    f = resolve_format(fmt)
    if epoch_bits == 0:
        return records.pack_key(status, inc, f.dead_bit, f.inc_sat(),
                                f.dtype)
    inc_bits = f.inc_bits(epoch_bits)
    key = records.pack_key(status, inc, f.dead_bit, f.inc_sat(epoch_bits))
    ep = torch.clamp(torch.as_tensor(0 if epoch is None else epoch,
                                     device=key.device).to(torch.int32),
                     0, (1 << epoch_bits) - 1)
    key = torch.where(key < 0, key, key | (ep << (inc_bits + 1)))
    return key.to(f.dtype)


def unpack_record(key, fmt: WireFormat = None, epoch_bits: int = 0):
    """Invert :func:`pack_record`: key -> (status int8, inc int32); keys
    < 0 unpack to (ABSENT, 0).  The epoch field is read by
    :func:`unpack_epoch`."""
    f = resolve_format(fmt)
    inc_mask = (1 << f.inc_bits(epoch_bits)) - 1
    key = torch.as_tensor(key).to(torch.int32)
    is_dead = (key >> f.dead_bit) & 1
    is_suspect = key & 1
    status = torch.where(is_suspect == 1, records.SUSPECT, records.ALIVE)
    status = torch.where(is_dead == 1, records.DEAD, status)
    status = torch.where(key < 0, records.ABSENT, status).to(torch.int8)
    inc = torch.where(key < 0, 0, (key >> 1) & inc_mask).to(torch.int32)
    return status, inc


def unpack_epoch(key, fmt: WireFormat = None, epoch_bits: int = 0):
    """The identity-epoch field of an epoch-extended key (int32; keys < 0
    unpack to epoch 0, as does every key at ``epoch_bits == 0``)."""
    key = torch.as_tensor(key).to(torch.int32)
    if epoch_bits == 0:
        return torch.zeros_like(key)
    f = resolve_format(fmt)
    ep = (key >> (f.inc_bits(epoch_bits) + 1)) & ((1 << epoch_bits) - 1)
    return torch.where(key < 0, 0, ep)


def is_alive_key(key, fmt: WireFormat = None):
    """True where ``key`` packs an ALIVE record (dead/suspect bits clear)."""
    f = resolve_format(fmt)
    return (key >= 0) & (((key >> f.dead_bit) & 1) == 0) & ((key & 1) == 0)


def merge_inbox(entry_status, entry_inc, inbox_key, inbox_any_alive,
                fmt: WireFormat = None, suppress=None, entry_epoch=None,
                epoch_bits: int = 0, epoch_guard: bool = True):
    """Merge one round's max-folded inbox into the table entries.

    One valid arrival-order serialization of the reference's
    ``updateMembership`` loop (MembershipProtocolImpl.java:475-541): an
    ABSENT entry opens only if an ALIVE record arrived; a live entry
    takes the winner when its key is strictly above the entry's key.  A
    stored DEAD gates like ABSENT (the reference deletes the record),
    except where ``suppress`` [N, K] bool (the dead-member suppression
    window) holds: there the tombstone gates by its true DEAD key, so
    only a strictly higher DEAD key overrides it.

    ``inbox_key`` is in the format's dtype; the entry's key is packed in
    the same format, so the gate compares like with like.

    With ``epoch_bits > 0`` (the open-world plane) ``entry_epoch`` [N, K]
    is each entry's identity epoch.  Guarded (``epoch_guard``): the
    same-epoch gate compares the epoch-stripped keys in the wide layout,
    a lower-epoch winner drops, and a higher-epoch winner is admitted
    only if it is ALIVE, over a suppressed tombstone too.  Unguarded
    (the naive-reuse control, reachable only by a direct call): the gate
    compares the full keys, epoch included.

    Returns (status int8, inc int32, changed bool), or with
    ``epoch_bits > 0`` (status, inc, epoch int32, changed).
    """
    f = resolve_format(fmt)
    win_status, win_inc = unpack_record(inbox_key, fmt=f,
                                        epoch_bits=epoch_bits)
    gate_status = torch.where(entry_status == records.DEAD, records.ABSENT,
                              entry_status)
    absent = gate_status == records.ABSENT
    opens = inbox_any_alive & (inbox_key >= 0)
    new_epoch = None
    if epoch_bits == 0:
        entry_key = pack_record(gate_status, entry_inc, fmt=f)
        accepts = torch.where(absent, opens, inbox_key > entry_key)
        if suppress is not None:
            true_key = pack_record(entry_status, entry_inc, fmt=f)
            accepts = torch.where(suppress, inbox_key > true_key, accepts)
    else:
        entry_ep = torch.as_tensor(entry_epoch).to(torch.int32)
        win_ep = unpack_epoch(inbox_key, fmt=f, epoch_bits=epoch_bits)
        if epoch_guard:
            win_key0 = pack_record(win_status, win_inc)
            accepts = torch.where(absent, opens,
                                  win_key0 > pack_record(gate_status,
                                                         entry_inc))
            if suppress is not None:
                accepts = torch.where(
                    suppress, win_key0 > pack_record(entry_status,
                                                     entry_inc), accepts)
            accepts = torch.where(
                win_ep > entry_ep, win_status == records.ALIVE,
                accepts & ~(win_ep < entry_ep))
        else:
            entry_key = pack_record(gate_status, entry_inc, fmt=f,
                                    epoch=entry_ep, epoch_bits=epoch_bits)
            accepts = torch.where(absent, opens, inbox_key > entry_key)
            if suppress is not None:
                true_key = pack_record(entry_status, entry_inc, fmt=f,
                                       epoch=entry_ep, epoch_bits=epoch_bits)
                accepts = torch.where(suppress, inbox_key > true_key,
                                      accepts)
        new_epoch = torch.where(accepts, win_ep, entry_ep)
    new_status = torch.where(accepts, win_status, entry_status).to(torch.int8)
    new_inc = torch.where(accepts, win_inc, entry_inc).to(torch.int32)
    changed = accepts & ((new_status != entry_status) | (new_inc != entry_inc))
    if new_epoch is None:
        return new_status, new_inc, changed
    changed = changed | (accepts & (new_epoch != entry_ep))
    return new_status, new_inc, new_epoch, changed


def scatter_max_into(inbox: torch.Tensor, values: torch.Tensor,
                     targets: torch.Tensor, drop: torch.Tensor) -> None:
    """Max-fold each sender's row of ``values`` [S, K] into ``inbox``
    [N, K] (in place) at each of its ``targets`` [S, F] whose ``drop``
    [S, F] is false: one ``index_reduce_`` a fanout column.  Max does
    not depend on the order of colliding targets, so the result is the
    same on every device.  Keys stay in ``values``' dtype."""
    index = targets.long()
    for f in range(targets.shape[1]):
        contribution = torch.where(drop[:, f, None], NO_MESSAGE, values)
        inbox.index_reduce_(0, index[:, f], contribution, "amax",
                            include_self=True)


def scatter_or_into(inbox: torch.Tensor, flags: torch.Tensor,
                    targets: torch.Tensor, drop: torch.Tensor) -> None:
    """:func:`scatter_max_into` for flag bits: ``inbox`` [N, K] bool (or
    int8 0/1) or-folds ``flags`` [S, K] bool at the undropped targets,
    through an int8 view (a max over 0/1 is the or)."""
    plane = inbox.view(torch.int8)
    index = targets.long()
    for f in range(targets.shape[1]):
        contribution = (flags & ~drop[:, f, None]).view(torch.int8)
        plane.index_reduce_(0, index[:, f], contribution, "amax",
                            include_self=True)


def scatter_max(values: torch.Tensor, targets: torch.Tensor,
                drop: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Deliver each sender's row to its targets: the ``[n_rows, K]``
    inbox of the max key received a cell, ``NO_MESSAGE`` where nothing
    arrived (the reference's ``scatter_max``)."""
    inbox = torch.full((n_rows, values.shape[1]), NO_MESSAGE,
                       dtype=values.dtype, device=values.device)
    scatter_max_into(inbox, values, targets, drop)
    return inbox


def scatter_or(flags: torch.Tensor, targets: torch.Tensor,
               drop: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Boolean :func:`scatter_max`: ``[n_rows, K]`` true where some
    undropped sender flagged the cell (the reference's ``scatter_or``)."""
    inbox = torch.zeros((n_rows, flags.shape[1]), dtype=torch.bool,
                        device=flags.device)
    scatter_or_into(inbox, flags, targets, drop)
    return inbox


def wire_saturation(messages_sent, live_senders, fanout):
    """Wire-channel saturation (a gauge of ``telemetry/metrics.py``):
    gossip messages sent this round over the channel's send-slot
    capacity, live senders x ``fanout`` (each live member owns ``fanout``
    gossip sends a round, hot records or not), at least 1.  0 is an idle
    channel, 1 every live member spreading every round.  float32, as the
    reference computes it: int32 totals cast, then one division."""
    live = torch.as_tensor(live_senders).to(torch.float32)
    cap = torch.clamp(live * torch.tensor(float(fanout), dtype=torch.float32,
                                          device=live.device), min=1.0)
    return torch.as_tensor(messages_sent).to(torch.float32) / cap
