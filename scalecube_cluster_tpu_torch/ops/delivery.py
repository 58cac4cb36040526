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
tensor is ``torch.int16``.  The open-world epoch field is not ported:
a non-zero ``epoch_bits`` raises.  ALIVE is a key with the dead and
suspect bits clear, so a delivered key carries its own merge-gate flag
(:func:`is_alive_key`).
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


WIDE = WireFormat("wide", dead_bit=30, epoch_bits=6, wide_word=True)
WIRE24 = WireFormat("wire24", dead_bit=23, epoch_bits=4, wide_word=True)
WIRE16 = WireFormat("wire16", dead_bit=14, epoch_bits=2, wide_word=False)

WIRE_FORMATS = {f.name: f for f in (WIDE, WIRE24, WIRE16)}


def resolve_format(fmt: WireFormat = None,
                   epoch_bits: int = 0) -> WireFormat:
    """The active :class:`WireFormat` (``None`` = wide).  The epoch field
    is not ported: a non-zero ``epoch_bits`` raises."""
    if epoch_bits:
        raise NotImplementedError(
            f"epoch_bits={epoch_bits}: the identity-epoch wire field "
            f"(open_world) is not ported")
    return WIDE if fmt is None else fmt


def no_message(fmt: WireFormat = None) -> int:
    """The "no message" key, -1 in every format (``fmt`` is accepted for
    the reference's signature).  A Python int takes the dtype of the
    tensor it meets in ``torch.where``, so it never widens an int16 wire
    buffer."""
    return NO_MESSAGE


def pack_record(status, inc, fmt: WireFormat = None, epoch_bits: int = 0):
    """(status, incarnation) -> merge key of the wire format, in its
    dtype; ABSENT packs to -1 == :func:`no_message`."""
    f = resolve_format(fmt, epoch_bits)
    return records.pack_key(status, inc, f.dead_bit, f.inc_sat(), f.dtype)


def unpack_record(key, fmt: WireFormat = None, epoch_bits: int = 0):
    """Invert :func:`pack_record`: key -> (status int8, inc int32); keys
    < 0 unpack to (ABSENT, 0)."""
    f = resolve_format(fmt, epoch_bits)
    inc_mask = (1 << f.inc_bits()) - 1
    key = torch.as_tensor(key).to(torch.int32)
    is_dead = (key >> f.dead_bit) & 1
    is_suspect = key & 1
    status = torch.where(is_suspect == 1, records.SUSPECT, records.ALIVE)
    status = torch.where(is_dead == 1, records.DEAD, status)
    status = torch.where(key < 0, records.ABSENT, status).to(torch.int8)
    inc = torch.where(key < 0, 0, (key >> 1) & inc_mask).to(torch.int32)
    return status, inc


def is_alive_key(key, fmt: WireFormat = None):
    """True where ``key`` packs an ALIVE record (dead/suspect bits clear)."""
    f = resolve_format(fmt)
    return (key >= 0) & (((key >> f.dead_bit) & 1) == 0) & ((key & 1) == 0)


def merge_inbox(entry_status, entry_inc, inbox_key, inbox_any_alive,
                fmt: WireFormat = None, epoch_bits: int = 0, suppress=None):
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

    Returns (status int8, inc int32, changed bool).
    """
    f = resolve_format(fmt, epoch_bits)
    win_status, win_inc = unpack_record(inbox_key, fmt=f)
    gate_status = torch.where(entry_status == records.DEAD, records.ABSENT,
                              entry_status)
    entry_key = pack_record(gate_status, entry_inc, fmt=f)
    absent = gate_status == records.ABSENT
    accepts = torch.where(absent, inbox_any_alive & (inbox_key >= 0),
                          inbox_key > entry_key)
    if suppress is not None:
        true_key = pack_record(entry_status, entry_inc, fmt=f)
        accepts = torch.where(suppress, inbox_key > true_key, accepts)
    new_status = torch.where(accepts, win_status, entry_status).to(torch.int8)
    new_inc = torch.where(accepts, win_inc, entry_inc).to(torch.int32)
    changed = accepts & ((new_status != entry_status) | (new_inc != entry_inc))
    return new_status, new_inc, changed


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
