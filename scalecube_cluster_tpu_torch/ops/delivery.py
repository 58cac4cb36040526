"""Wire keys and the inbox merge gate.

Counterpart of ``scalecube_cluster_tpu/ops/delivery.py`` for the shift
path: a record (status + incarnation) packs into one int32 key whose max
is the SWIM merge winner, and :func:`merge_inbox` applies the entry gate
to a round's max-folded inbox.

Wire layout, one signed word: ``[sign 0] [dead] [incarnation] [suspect]``
with the dead bit on top so the max-fold keeps the reference's
DEAD-absorbs order.  The ``WireFormat`` table lists the reference's
three rungs; this port carries the wide int32 rung only, and the other
two raise when used.  ALIVE is a key with the dead and suspect bits
clear, so a delivered key carries its own merge-gate flag
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

    def inc_bits(self, epoch_bits: int = 0) -> int:
        return self.dead_bit - 1 - epoch_bits

    def inc_sat(self, epoch_bits: int = 0) -> int:
        """Largest incarnation the key field carries exactly."""
        return (1 << self.inc_bits(epoch_bits)) - 1


WIDE = WireFormat("wide", dead_bit=30, epoch_bits=6, wide_word=True)
WIRE24 = WireFormat("wire24", dead_bit=23, epoch_bits=4, wide_word=True)
WIRE16 = WireFormat("wire16", dead_bit=14, epoch_bits=2, wide_word=False)

WIRE_FORMATS = {f.name: f for f in (WIDE, WIRE24, WIRE16)}


def _wide_only(fmt: WireFormat) -> WireFormat:
    fmt = WIDE if fmt is None else fmt
    if fmt is not WIDE:
        raise NotImplementedError(
            f"wire format {fmt.name!r} is not ported; the port carries "
            f"the wide int32 key only")
    return fmt


def no_message(fmt: WireFormat = None) -> int:
    """The "no message" key of the wire format."""
    _wide_only(fmt)
    return NO_MESSAGE


def pack_record(status, inc, fmt: WireFormat = None):
    """(status, incarnation) -> wide merge key; ABSENT packs to -1."""
    _wide_only(fmt)
    return records.merge_key(status, inc)


def unpack_record(key, fmt: WireFormat = None):
    """Invert :func:`pack_record`: key -> (status int8, inc int32); keys
    < 0 unpack to (ABSENT, 0)."""
    f = _wide_only(fmt)
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
    f = _wide_only(fmt)
    return (key >= 0) & (((key >> f.dead_bit) & 1) == 0) & ((key & 1) == 0)


def merge_inbox(entry_status, entry_inc, inbox_key, inbox_any_alive,
                fmt: WireFormat = None):
    """Merge one round's max-folded inbox into the table entries.

    One valid arrival-order serialization of the reference's
    ``updateMembership`` loop (MembershipProtocolImpl.java:475-541): an
    ABSENT entry opens only if an ALIVE record arrived; a live entry
    takes the winner when its key is strictly above the entry's key.  A
    stored DEAD gates like ABSENT (the reference deletes the record).

    Returns (status int8, inc int32, changed bool).
    """
    f = _wide_only(fmt)
    win_status, win_inc = unpack_record(inbox_key, fmt=f)
    gate_status = torch.where(entry_status == records.DEAD, records.ABSENT,
                              entry_status)
    entry_key = pack_record(gate_status, entry_inc, fmt=f)
    absent = gate_status == records.ABSENT
    accepts = torch.where(absent, inbox_any_alive & (inbox_key >= 0),
                          inbox_key > entry_key)
    new_status = torch.where(accepts, win_status, entry_status).to(torch.int8)
    new_inc = torch.where(accepts, win_inc, entry_inc).to(torch.int32)
    changed = accepts & ((new_status != entry_status) | (new_inc != entry_inc))
    return new_status, new_inc, changed
