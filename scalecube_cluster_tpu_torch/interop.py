"""Carry parameters, worlds, states and checkpoints across from the JAX
package, with numpy alone.

The reference's objects reach this module as plain data: ``SwimParams``
as the dict ``dataclasses.asdict`` gives, worlds and states as dicts of
numpy arrays under the reference's field names (a world's ``faults`` as
a dict of the ``LinkFaults`` arrays), and checkpoints as the ``.npz``
that ``scalecube_cluster_tpu.utils.checkpoint.save`` writes
(``state/<field>`` arrays, ``next_round``, optional ``key_data``,
``meta_json``).  A world's fault rules, seeds, user-gossip, join and
config-push schedules and a state's delay rings, user-gossip lanes,
Lifeguard ``lhm`` lane, open-world ``epoch`` lane and metadata ``md`` /
``md_spread`` lanes carry over.
:func:`state_to_arrays` carries a port state back, under the names the
reference's ``checkpoint.state_from_arrays`` reads.  A membership trace
(the reference's ``telemetry.trace.TelemetryState``) crosses as the dict
of numpy arrays ``lanes``, ``count``, ``dropped``, ``first_suspect`` and
``first_removed`` (:func:`telemetry_from_arrays`,
:func:`telemetry_to_arrays`), so a port run can resume a reference
trace; a provenance buffer (``models.provenance.ProvenanceState``) as
``lanes``, ``count`` and ``dropped`` (:func:`provenance_from_arrays`,
:func:`provenance_to_arrays`); a gossip-only model's state
(``models.gossip.GossipState``) as ``infected``, ``spread_until`` and
``ring`` (:func:`gossip_state_from_arrays`,
:func:`gossip_state_to_arrays`).  A state's carry layout
(wide, or the ``compact_carry`` int16/int8 lanes) must be the one its
params name.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from scalecube_cluster_tpu_torch.models import swim

_STATE_FIELDS = ("status", "inc", "spread_until", "suspect_deadline",
                 "self_inc")
_LANE_FIELDS = ("inbox_ring", "flag_ring", "g_infected", "g_spread_until",
                "g_ring", "lhm", "epoch", "md", "md_spread")


def params_from_fields(fields: Mapping) -> swim.SwimParams:
    """``SwimParams`` from ``dataclasses.asdict`` of the reference's."""
    return swim.SwimParams(**dict(fields))


def world_from_arrays(arrays: Mapping, device="cuda") -> swim.SwimWorld:
    """``SwimWorld`` from the reference world's fields as numpy arrays
    (``faults`` as a mapping of the ``LinkFaults`` arrays; absent faults,
    seeds, gossip, join or push schedule mean none)."""
    device = swim.resolve_device(device)

    def t(values, dtype):
        return torch.tensor(np.asarray(values), dtype=dtype, device=device)

    def schedule(name):
        return t(arrays.get(name, np.zeros((0,), np.int32)), torch.int32)

    faults = swim.LinkFaults.none(device)
    if arrays.get("faults") is not None:
        faults = swim.LinkFaults(**{
            name: t(arrays["faults"][name], getattr(faults, name).dtype)
            for name in swim.LinkFaults.ARRAYS})
    world = swim.SwimWorld(
        down_from=t(arrays["down_from"], torch.int32),
        down_until=t(arrays["down_until"], torch.int32),
        leave_at=t(arrays["leave_at"], torch.int32),
        partition_of=t(arrays["partition_of"], torch.int8),
        partition_phase_rounds=int(np.asarray(arrays["partition_phase_rounds"])),
        faults=faults,
        seed_ids=schedule("seed_ids"),
        subject_ids=t(arrays["subject_ids"], torch.int32),
        slot_of_node=t(arrays["slot_of_node"], torch.int32),
        gossip_origin=schedule("gossip_origin"),
        gossip_spread_at=schedule("gossip_spread_at"),
        join_at=(t(arrays["join_at"], torch.int32) if "join_at" in arrays
                 else None),
        **{name: schedule(name) for name in swim.SwimWorld.PUSH_FIELDS},
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
    (keys with or without the ``state/`` prefix).  The carry must be the
    layout ``params`` names: the compact one under
    ``params.compact_carry``, else (and when ``params`` is None) the wide
    one.  The ring, user-gossip, ``lhm``, ``epoch`` and metadata lanes are
    taken as given (absent: fresh lanes of the shapes ``params`` gives,
    zero-size without params, so a checkpoint from before the epoch lane
    loads with zero epochs under open-world params); ``run`` checks them
    against its params."""
    device = swim.resolve_device(device)
    fields = {name[len("state/"):] if name.startswith("state/") else name:
              np.asarray(value) for name, value in arrays.items()}
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
    lanes = (swim.initial_lanes(params, device) if params is not None
             else swim.empty_lanes(*fields["status"].shape, device))
    lanes.update({name: torch.tensor(fields[name], device=device)
                  for name in _LANE_FIELDS if name in fields})
    return swim.SwimState(**{
        name: torch.tensor(fields[name], device=device)
        for name in _STATE_FIELDS}, **lanes)


def state_to_arrays(state: swim.SwimState) -> dict:
    """A port state as ``{"state/<field>": numpy array}``, every lane in
    its own dtype (the reference's ``checkpoint.state_to_arrays`` naming;
    its ``state_from_arrays`` reads them after the prefix is taken off)."""
    return {f"state/{f.name}": getattr(state, f.name).cpu().numpy()
            for f in dataclasses.fields(state)}


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


_TELEMETRY_FIELDS = ("lanes", "count", "dropped", "first_suspect",
                     "first_removed")


def telemetry_from_arrays(arrays: Mapping, device="cuda"):
    """A port ``telemetry.trace.TelemetryState`` from the reference's, as
    the numpy arrays ``lanes`` [capacity, 5], ``count``, ``dropped`` and
    ``first_suspect`` / ``first_removed`` [N, K] (all int32)."""
    from scalecube_cluster_tpu_torch.telemetry import trace as ttrace

    device = swim.resolve_device(device)
    missing = [f for f in _TELEMETRY_FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"telemetry arrays lack {missing}")

    def t(name):
        value = np.asarray(arrays[name])
        if value.dtype != np.int32:
            raise ValueError(f"telemetry field {name} is {value.dtype}, "
                             f"expected int32")
        return torch.tensor(value, device=device)

    return ttrace.TelemetryState(
        trace=ttrace.EventTrace(lanes=t("lanes"), count=t("count"),
                                dropped=t("dropped")),
        first_suspect=t("first_suspect"), first_removed=t("first_removed"))


def telemetry_to_arrays(tel) -> dict:
    """A port ``TelemetryState`` as the numpy arrays
    :func:`telemetry_from_arrays` reads (the reference's field names)."""
    return dict(lanes=tel.trace.lanes.cpu().numpy(),
                count=tel.trace.count.cpu().numpy(),
                dropped=tel.trace.dropped.cpu().numpy(),
                first_suspect=tel.first_suspect.cpu().numpy(),
                first_removed=tel.first_removed.cpu().numpy())


_PROVENANCE_FIELDS = ("lanes", "count", "dropped")


def provenance_from_arrays(arrays: Mapping, device="cuda"):
    """A port ``models.provenance.ProvenanceState`` from the reference's,
    as the numpy arrays ``lanes`` [capacity, 6], ``count`` and
    ``dropped`` (all int32)."""
    from scalecube_cluster_tpu_torch.models import provenance

    device = swim.resolve_device(device)
    missing = [f for f in _PROVENANCE_FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"provenance arrays lack {missing}")
    out = {}
    for name in _PROVENANCE_FIELDS:
        value = np.asarray(arrays[name])
        if value.dtype != np.int32:
            raise ValueError(f"provenance field {name} is {value.dtype}, "
                             f"expected int32")
        out[name] = torch.tensor(value, device=device)
    if out["lanes"].ndim != 2 or out["lanes"].shape[1] != 6:
        raise ValueError(f"provenance lanes are "
                         f"{tuple(out['lanes'].shape)}, expected "
                         f"[capacity, 6]")
    return provenance.ProvenanceState(**out)


def provenance_to_arrays(pv) -> dict:
    """A port ``ProvenanceState`` as the numpy arrays
    :func:`provenance_from_arrays` reads (the reference's field names)."""
    return {name: getattr(pv, name).cpu().numpy()
            for name in _PROVENANCE_FIELDS}


_GOSSIP_FIELDS = {"infected": np.bool_, "spread_until": np.int32,
                  "ring": np.bool_}


def gossip_state_from_arrays(arrays: Mapping, device="cuda"):
    """A port ``models.gossip.GossipState`` from the reference's, as the
    numpy arrays ``infected`` [N, G] bool, ``spread_until`` [N, G] int32
    and ``ring`` [D, N, G] bool: a reference gossip run resumes in the
    port."""
    from scalecube_cluster_tpu_torch.models import gossip

    device = swim.resolve_device(device)
    missing = [f for f in _GOSSIP_FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"gossip state arrays lack {missing}")
    out = {}
    for name, dtype in _GOSSIP_FIELDS.items():
        value = np.asarray(arrays[name])
        if value.dtype != dtype:
            raise ValueError(f"gossip state field {name} is {value.dtype}, "
                             f"expected {np.dtype(dtype)}")
        out[name] = torch.tensor(value, device=device)
    if out["ring"].shape[1:] != out["infected"].shape:
        raise ValueError(f"gossip ring {tuple(out['ring'].shape)} does not "
                         f"match infected {tuple(out['infected'].shape)}")
    return gossip.GossipState(**out)


def gossip_state_to_arrays(state) -> dict:
    """A port ``GossipState`` as the numpy arrays
    :func:`gossip_state_from_arrays` reads (the reference's field names)."""
    return {name: getattr(state, name).cpu().numpy()
            for name in _GOSSIP_FIELDS}
