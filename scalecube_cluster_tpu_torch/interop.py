"""Carry parameters, worlds, states and checkpoints across from the JAX
package, with numpy alone.

The reference's objects reach this module as plain data: ``SwimParams``
as the dict ``dataclasses.asdict`` gives, worlds and states as dicts of
numpy arrays under the reference's field names, and checkpoints as the
``.npz`` that ``scalecube_cluster_tpu.utils.checkpoint.save`` writes
(``state/<field>`` arrays, ``next_round``, optional ``key_data``,
``meta_json``).  Lanes of planes the port does not carry must be
zero-size; anything else raises ``NotImplementedError`` naming it.  A
state's carry layout (wide, or the ``compact_carry`` int16/int8 lanes)
must be the one its params name.
"""

from __future__ import annotations

import json
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from scalecube_cluster_tpu_torch.models import swim

_STATE_FIELDS = ("status", "inc", "spread_until", "suspect_deadline",
                 "self_inc")
# Reference state lanes of optional planes, and the axis that is zero
# when the plane is off.
_PLANE_LANES = {"inbox_ring": 0, "flag_ring": 0, "g_infected": 1,
                "g_spread_until": 1, "g_ring": 0, "lhm": 0, "epoch": 1,
                "md": 1, "md_spread": 1}


def params_from_fields(fields: Mapping) -> swim.SwimParams:
    """``SwimParams`` from ``dataclasses.asdict`` of the reference's."""
    return swim.SwimParams(**dict(fields))


def world_from_arrays(arrays: Mapping, device="cuda") -> swim.SwimWorld:
    """``SwimWorld`` from the reference world's fields as numpy arrays.

    ``faults`` may be given as a mapping of the ``LinkFaults`` arrays; a
    world with fault rules, seeds, user-gossip spreads, joins or metadata
    pushes raises."""
    device = swim.resolve_device(device)
    faults = arrays.get("faults")
    if faults is not None and np.asarray(faults["src_lo"]).shape[0] > 0:
        raise NotImplementedError("LinkFaults rules are not ported")
    for name in ("seed_ids", "gossip_origin", "md_push_at"):
        if name in arrays and np.asarray(arrays[name]).size > 0:
            raise NotImplementedError(f"world field {name} is not ported")
    if "join_at" in arrays and (np.asarray(arrays["join_at"])
                                < swim.INT32_MAX).any():
        raise NotImplementedError("world field join_at is not ported")

    def t(name, dtype):
        return torch.tensor(np.asarray(arrays[name]), dtype=dtype,
                            device=device)

    world = swim.SwimWorld(
        down_from=t("down_from", torch.int32),
        down_until=t("down_until", torch.int32),
        leave_at=t("leave_at", torch.int32),
        partition_of=t("partition_of", torch.int8),
        partition_phase_rounds=int(np.asarray(arrays["partition_phase_rounds"])),
        subject_ids=t("subject_ids", torch.int32),
        slot_of_node=t("slot_of_node", torch.int32),
    )
    k = world.subject_ids.shape[0]
    expected = torch.full_like(world.slot_of_node, -1)
    expected[world.subject_ids.long()] = torch.arange(
        k, dtype=torch.int32, device=device)
    if not torch.equal(expected, world.slot_of_node):
        raise ValueError("slot_of_node disagrees with subject_ids")
    return world


def _carry_dtypes(compact: bool) -> dict:
    narrow = (np.int16, np.int8, np.int16) if compact else (np.int32,) * 3
    return dict(status=np.int8, inc=narrow[0], spread_until=narrow[1],
                suspect_deadline=narrow[2], self_inc=np.int32)


def state_from_arrays(arrays: Mapping, device="cuda",
                      params: Optional[swim.SwimParams] = None
                      ) -> swim.SwimState:
    """``SwimState`` from the reference's ``state_to_arrays`` payload
    (keys with or without the ``state/`` prefix).  Plane lanes must be
    zero-size or absent.  The carry must be the layout ``params`` names:
    the compact one under ``params.compact_carry``, else (and when
    ``params`` is None) the wide one."""
    device = swim.resolve_device(device)
    fields = {name[len("state/"):] if name.startswith("state/") else name:
              np.asarray(value) for name, value in arrays.items()}
    for lane, axis in _PLANE_LANES.items():
        if lane in fields and fields[lane].ndim > axis \
                and fields[lane].shape[axis] != 0:
            raise NotImplementedError(
                f"state lane {lane} holds a plane the port does not carry")
    missing = [f for f in _STATE_FIELDS if f not in fields]
    if missing:
        raise KeyError(f"state arrays lack {missing}")
    compact = params is not None and params.compact_carry
    layout = "compact_carry" if compact else "wide"
    for name, dtype in _carry_dtypes(compact).items():
        if fields[name].dtype != dtype:
            raise ValueError(
                f"state field {name} is {fields[name].dtype}, the {layout} "
                f"carry has {np.dtype(dtype)} (pass the run's params; "
                f"compact_carry selects the int16/int8 lanes)")
    return swim.SwimState(**{
        name: torch.tensor(fields[name], device=device)
        for name in _STATE_FIELDS})


def load_jax_checkpoint(path: str, device="cuda",
                        params: Optional[swim.SwimParams] = None) -> Tuple[
        swim.SwimState, int, Optional[np.ndarray], dict]:
    """Read a checkpoint written by the reference's
    ``utils.checkpoint.save``: returns ``(state, next_round, key_data or
    None, meta)``.  ``params`` names the carry layout, as for
    :func:`state_from_arrays` (a compact run resumes with its compact
    params).  ``key_data`` is the raw key array; the port's own draws do
    not use it."""
    with np.load(path) as z:
        state = state_from_arrays(
            {name: z[name] for name in z.files if name.startswith("state/")},
            device=device, params=params)
        next_round = int(z["next_round"])
        key_data = np.array(z["key_data"]) if "key_data" in z.files else None
        meta = json.loads(bytes(z["meta_json"].tobytes()).decode() or "{}")
    return state, next_round, key_data, meta
