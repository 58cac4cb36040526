"""Membership-record status codes and the merge rule.

Counterpart of ``scalecube_cluster_tpu/records.py``: the reference's
``MembershipRecord.isOverrides`` (cluster/src/main/java/io/scalecube/
cluster/membership/MembershipRecord.java:66-84) as a scalar function and
a tensor function, and the packed ``merge_key`` (int32) and
``merge_key16`` (int16) whose max is the merge winner.  ALIVE=0, SUSPECT=1, DEAD=2 follow the reference enum order;
ABSENT=3 encodes "no record" in the dense table.
"""

from __future__ import annotations

import enum

import torch


class MemberStatus(enum.IntEnum):
    """Member liveness status (membership/MemberStatus.java:3-16), plus
    ABSENT for a missing record (never on the wire)."""

    ALIVE = 0
    SUSPECT = 1
    DEAD = 2
    ABSENT = 3


ALIVE = int(MemberStatus.ALIVE)
SUSPECT = int(MemberStatus.SUSPECT)
DEAD = int(MemberStatus.DEAD)
ABSENT = int(MemberStatus.ABSENT)

# Incarnation saturation of the int32 merge key (bits 1..29) and of the
# int16 key (bits 1..13).
KEY_INC_SAT = 2**29 - 1
KEY16_INC_SAT = 2**13 - 1


def is_overrides(new_status: int, new_inc: int, old_status: int,
                 old_inc: int) -> bool:
    """Does record (new_status, new_inc) override entry (old_status, old_inc)?

    MembershipRecord.java:66-84: ABSENT accepts only ALIVE; DEAD is
    terminal; a new DEAD always overrides; at equal incarnation only
    SUSPECT beats ALIVE; otherwise the higher incarnation wins.
    """
    if old_status == ABSENT:
        return new_status == ALIVE
    if old_status == DEAD:
        return False
    if new_status == DEAD:
        return True
    if new_status == ABSENT:
        return False
    if new_inc == old_inc:
        return new_status != old_status and new_status == SUSPECT
    return new_inc > old_inc


def is_overrides_array(new_status, new_inc, old_status, old_inc):
    """Tensor ``is_overrides`` over broadcastable status/incarnation
    tensors (or Python ints), the five rules as selects in the same order
    as the reference package."""
    new_status = torch.as_tensor(new_status)
    old_status = torch.as_tensor(old_status)
    new_inc = torch.as_tensor(new_inc)
    old_inc = torch.as_tensor(old_inc)

    equal_inc = new_inc == old_inc
    suspect_beats_alive = (new_status != old_status) & (new_status == SUSPECT)
    result = torch.where(equal_inc, suspect_beats_alive, new_inc > old_inc)
    result = result | (new_status == DEAD)
    result = result & (new_status != ABSENT)
    result = result & (old_status != DEAD)
    return torch.where(old_status == ABSENT, new_status == ALIVE, result)


def pack_key(status, inc, dead_bit: int, inc_sat: int,
             dtype: torch.dtype = torch.int32):
    """Fold key ``(is_dead << dead_bit) | (min(inc, inc_sat) << 1) |
    is_suspect`` in ``dtype``; ABSENT maps to -1.  Its max over a round's
    records is the schedule winner (DEAD absorbs, then incarnation, then
    SUSPECT).  Every wire format packs through here
    (``ops/delivery.pack_record``)."""
    device = next((x.device for x in (status, inc)
                   if isinstance(x, torch.Tensor)), None)
    status = torch.as_tensor(status, device=device)
    inc = torch.as_tensor(inc, device=device).to(torch.int32)
    is_dead = (status == DEAD).to(torch.int32)
    is_suspect = (status == SUSPECT).to(torch.int32)
    inc_sat = torch.clamp(inc, max=inc_sat)
    key = (is_dead << dead_bit) | (inc_sat << 1) | is_suspect
    return torch.where(status == ABSENT, torch.full_like(key, -1),
                       key).to(dtype)


def merge_key(status, inc):
    """int32 fold key ``(is_dead << 30) | (min(inc, 2^29-1) << 1) |
    is_suspect``; ABSENT maps to -1."""
    return pack_key(status, inc, 30, KEY_INC_SAT)


def merge_key16(status, inc):
    """int16 variant of :func:`merge_key`, the narrow wire's key:
    ``(is_dead << 14) | (min(inc, 8191) << 1) | is_suspect``; ABSENT
    maps to -1.  Same order as the int32 key at half the bytes."""
    return pack_key(status, inc, 14, KEY16_INC_SAT, torch.int16)
