"""The invariant monitor's open-world join codes, one round at a time.

Counterpart of two of the codes of ``scalecube_cluster_tpu/chaos/
monitor.py`` (its ``_check_cells``), evaluated on the host's request on
one round's post-merge state instead of inside a scan:

- ``NO_RESURRECTION``: a live observer holds a dead identity's record
  as live.  Two detectors.  Incarnation forensics: a live ALIVE/SUSPECT
  record of a joined slot carrying an incarnation above the slot's own
  current ``self_inc`` cannot describe the current occupant (with the
  epoch lane, only at cells claiming the current epoch).  Stale-epoch
  persistence (epoch lane only): past the join deadline, a live record
  attributed to an epoch below the slot's ground-truth one.
- ``JOIN_COMPLETENESS``: past the join deadline, an eligible observer
  (continuously alive since the join) does not hold the ground-truth
  alive joined member live, at its true epoch where the lane can say.

Also the deadline rule the reference's scenarios use for both codes
(``chaos/scenarios.Scenario.build``, :func:`join_deadlines`) and its
bound (:func:`completeness_bound`).  A round's counts, summed over every
round of a run, equal the reference monitor's ``code_counts`` for the
two codes.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from scalecube_cluster_tpu_torch import records
from scalecube_cluster_tpu_torch.models import swim

INT32_MAX = swim.INT32_MAX
NO_RESURRECTION = "NO_RESURRECTION"
JOIN_COMPLETENESS = "JOIN_COMPLETENESS"


def completeness_bound(params: swim.SwimParams, n: int) -> int:
    """Rounds within which a permanent crash must be DEAD in every
    eligible view, and a join live in every eligible view: detection
    slack, the suspicion timeout, dissemination and anti-entropy slack
    (the reference's ``chaos/scenarios.completeness_bound``)."""
    log2n = math.ceil(math.log2(n + 1))
    return (params.suspicion_rounds + 24 * max(1, params.ping_every)
            + 4 * log2n + 2 * max(1, params.sync_every) + 16)


def join_deadlines(params: swim.SwimParams, world: swim.SwimWorld,
                   disruption_end: int = 0) -> Tuple[torch.Tensor, bool]:
    """``(join_known_by [K] int32, check_joins)``: each joined subject's
    deadline, ``max(join round, disruption_end) + completeness_bound``
    (INT32_MAX where no join is scheduled), and whether the codes apply
    at all (the plane on and some join scheduled).  ``disruption_end``:
    the last round of the scenario's network disruptions (0 for none).
    The reference's rule also drops every deadline under a permanent
    disruption and adds a scenario's extra slack; no caller here has
    either."""
    bound = completeness_bound(params, params.n_members)
    join_at = world.join_at[world.subject_ids.long()].to(torch.int64)
    checkable = join_at < INT32_MAX
    deadline = torch.clamp(torch.clamp(join_at, min=disruption_end) + bound,
                           max=INT32_MAX)
    known_by = torch.where(checkable, deadline, INT32_MAX).to(torch.int32)
    return known_by, bool(params.open_world and bool(checkable.any()))


def join_codes(state: swim.SwimState, params: swim.SwimParams,
               world: swim.SwimWorld, join_known_by: torch.Tensor,
               round_idx: int) -> Dict[str, torch.Tensor]:
    """The two codes' violating cells after round ``round_idx``
    (``state`` the round's output, any carry layout), as int32 device
    counts; zero where no join is checkable."""
    n, k = state.status.shape
    device = state.status.device
    zero = torch.zeros((), dtype=torch.int32, device=device)
    if not params.open_world or not bool(
            (join_known_by < INT32_MAX).any()):
        return {NO_RESURRECTION: zero, JOIN_COMPLETENESS: zero}
    subjects = world.subject_ids.long()
    node_ids = torch.arange(n, dtype=torch.int32, device=device)
    alive = world.alive_at(round_idx)
    obs_alive = alive[:, None]
    subj_alive = alive[subjects][None, :]
    is_self = world.subject_ids[None, :] == node_ids[:, None]
    status, inc = state.status, state.inc.to(torch.int32)
    live_rec = (status == records.ALIVE) | (status == records.SUSPECT)
    join_due = join_known_by[None, :] <= round_idx
    join_at = world.join_at[subjects]
    joined_col = (join_at < INT32_MAX)[None, :]
    ghost_inc = (obs_alive & ~is_self & joined_col & live_rec
                 & (inc > state.self_inc[subjects][None, :]))
    has_epoch = state.epoch.shape[1] > 0
    if has_epoch:
        epoch = state.epoch.to(torch.int32)
        true_ep = world.epoch_at(round_idx)[subjects][None, :]
        v_res = (ghost_inc & (epoch == true_ep)) | (
            join_due & obs_alive & ~is_self & live_rec & (epoch < true_ep))
        known = live_rec & (epoch == true_ep)
    else:
        v_res = ghost_inc
        known = live_rec
    disturbed = ((world.down_from[:, None] <= round_idx)
                 & (world.down_until[:, None] > join_at[None, :]))
    v_jc = (join_due & joined_col & subj_alive & obs_alive & ~disturbed
            & ~is_self & ~known)
    return {NO_RESURRECTION: v_res.sum(dtype=torch.int32),
            JOIN_COMPLETENESS: v_jc.sum(dtype=torch.int32)}
