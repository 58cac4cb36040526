"""Host-side metadata for the dense round: an (id, incarnation)-keyed
table.

Counterpart of ``scalecube_cluster_tpu/utils/metadata.py``, on the port's
``SwimState``.  The protocol never gossips metadata content: only the
owner's incarnation bump travels (through membership gossip), and
receivers then pull the metadata from the owner and emit an UPDATED
event.  This module is that host-side half: a table keyed by (node id,
incarnation) and the three protocol operations:

  - :meth:`TickMetadataStore.update`: the owner's ``updateMetadata``.
    It bumps the node's incarnation in the carry and opens its gossip
    window, so the bump spreads through the normal membership machinery,
    and registers the new version under the bumped incarnation;
  - :meth:`TickMetadataStore.view`: what an observer's fetch returns,
    resolved against the incarnation the observer has seen (a
    refutation bump without a metadata change resolves to the prior
    version);
  - :func:`updated_events`: the UPDATED events, (observer, subject,
    old_inc, new_inc) tuples diffed between two carries.

Every operation is host-side and O(rows touched), between runs (the
seam checkpoint and resume use).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from scalecube_cluster_tpu_torch import records
from scalecube_cluster_tpu_torch.models import swim


class TickMetadataStore:
    """(node_id, incarnation) -> metadata dict, resolved like the
    protocol's pull-on-bump."""

    def __init__(self):
        # node_id -> list of (incarnation, metadata) versions, sorted.
        self._versions: Dict[int, list] = {}

    def put(self, node_id: int, incarnation: int, metadata: dict) -> None:
        """Register ``metadata`` as ``node_id``'s content at
        ``incarnation`` (initial metadata at incarnation 0)."""
        versions = self._versions.setdefault(int(node_id), [])
        versions.append((int(incarnation), dict(metadata)))
        versions.sort(key=lambda iv: iv[0])

    def update(self, state: swim.SwimState, params: swim.SwimParams,
               world: swim.SwimWorld, node_id: int, metadata: dict,
               current_round: int) -> swim.SwimState:
        """The owner's ``updateMetadata``: ``self_inc[node] += 1`` (the
        round re-pins the node's own record from ``self_inc``) and the
        node's own spread window reopens, so the bump spreads; the new
        metadata registers under the bumped incarnation.  Returns the
        updated carry (new ``self_inc`` and ``spread_until`` tensors; the
        given state is not modified)."""
        node_id = int(node_id)
        slot = int(world.slot_of_node[node_id])
        if slot < 0:
            raise ValueError(
                f"node {node_id} is not a tracked subject — its record "
                f"(and so its incarnation bump) is not simulated")
        new_inc = int(state.self_inc[node_id]) + 1
        self.put(node_id, new_inc, metadata)
        spread = params.periods_to_spread + 1
        spread_val = (min(spread, 127) if params.compact_carry
                      else current_round + spread)
        self_inc = state.self_inc.clone()
        self_inc[node_id] += 1
        spread_until = state.spread_until.clone()
        spread_until[node_id, slot] = spread_val
        return dataclasses.replace(state, self_inc=self_inc,
                                   spread_until=spread_until)

    def resolve(self, node_id: int, seen_incarnation: int) -> Optional[dict]:
        """Metadata at the newest registered version <= what the observer
        has seen."""
        best = None
        for inc, md in self._versions.get(int(node_id), []):
            if inc > seen_incarnation:
                break
            best = md
        return best

    def view(self, state: swim.SwimState, params: swim.SwimParams,
             world: swim.SwimWorld, observer_id: int, subject_id: int,
             round_idx: Optional[int] = None) -> Optional[dict]:
        """What ``observer_id``'s fetch of ``subject_id``'s metadata
        returns now: None if the observer holds no live record of the
        subject (only members in the table are fetched).  ``round_idx``
        as for ``swim.node_snapshot`` (needed under the compact carry)."""
        if int(world.slot_of_node[subject_id]) < 0:
            raise ValueError(f"node {subject_id} is not a tracked subject")
        snap = swim.node_snapshot(state, params, world, observer_id,
                                  round_idx=round_idx)
        if subject_id in snap["alive_members"] + snap["suspected_members"]:
            seen = snap["record_incarnations"][subject_id]
        elif subject_id == observer_id:
            seen = snap["incarnation"]
        else:
            return None
        return self.resolve(subject_id, seen)


def updated_events(prev_state: swim.SwimState, state: swim.SwimState,
                   world: swim.SwimWorld, max_events: int = 10_000) -> list:
    """The UPDATED events between two wide carries: (observer_id,
    subject_id, old_inc, new_inc) wherever an observer's live record of
    a subject, live before too, moved to a higher incarnation (a record
    just learned is ADDED, not UPDATED, and a node's record of itself
    emits none), in row-major order, at most ``max_events``."""
    old_inc = prev_state.inc.cpu().numpy().astype(np.int64)
    new_inc = state.inc.cpu().numpy().astype(np.int64)
    new_status = state.status.cpu().numpy()
    old_status = prev_state.status.cpu().numpy()
    live = (new_status == records.ALIVE) | (new_status == records.SUSPECT)
    was_live = (old_status == records.ALIVE) | (old_status == records.SUSPECT)
    bumped = (new_inc > old_inc) & live & was_live
    subj = world.subject_ids.cpu().numpy()
    bumped[subj, np.arange(subj.shape[0])] = False
    obs, slot = np.nonzero(bumped)
    subjects = subj[slot]
    return [(int(o), int(s), int(old_inc[o, sl]), int(new_inc[o, sl]))
            for o, s, sl in zip(obs[:max_events], subjects[:max_events],
                                slot[:max_events])]
