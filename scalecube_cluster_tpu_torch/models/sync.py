"""The SYNC anti-entropy plane: the periodic full-table exchange that
re-converges a healed partition.

Counterpart of ``scalecube_cluster_tpu/models/sync.py``
(MembershipProtocolImpl.java:298-331,346-367, doSync -> onSync ->
SYNC_ACK).  Every ``sync_interval`` rounds (``SwimParams.sync_interval``;
0, the default, leaves the plane out of the round) one shared offset
``s`` in [1, N) pairs the members: each live member sends its syncable
row (its table minus tombstones) to both ``(i + s) mod N`` and
``(i - s) mod N``, so each pair ``{i, i + s}`` swaps tables in full
duplex.  The exchange is delivered like every other channel (liveness,
partition walls, per-link loss, the contact gate where seeds are set)
but in the same round, never through the delay ring, and merges through
the ordinary inbox gate, where a stored tombstone reopens for an
arriving ALIVE: that is how a healed half re-admits the members it
declared dead.

The offset and the two drop uniforms a member come from the round's
draws (``ops/prng``: ``ae_offset``, ``ae_drop_u``), not from a key.
:func:`divergent_cells` and :func:`divergence_probe` measure table
agreement, the plane's convergence observable.
"""

from __future__ import annotations

import torch

from scalecube_cluster_tpu_torch import records

INT32_MIN = -2**31

# This plane's row of models/compose.plane_registry.
PLANE = dict(
    name="sync", kind="in-tick", knobs=("sync_interval", "sync_every"),
    lanes=(),
    doc="anti-entropy full-table exchange for partition heal "
        "(sync_interval > 0 arms it; sync_every is the reference's "
        "per-round push channel)",
)


def due(round_idx: int, sync_interval: int) -> bool:
    """Is ``round_idx`` an exchange round?  Fires at round 0 too (on a
    converged table the exchange is a no-op).  ``sync_interval`` > 0."""
    return round_idx % sync_interval == 0


def exchange_targets(node_ids: torch.Tensor, s: int,
                     n_members: int) -> torch.Tensor:
    """[N, 2] partner ids: column 0 ``(i + s) mod N`` (the SYNC),
    column 1 ``(i - s) mod N`` (the partner's reply direction)."""
    return torch.stack([(node_ids + s) % n_members,
                        (node_ids - s) % n_members], dim=1)


def sent_count(ae_due: bool, alive_here: torch.Tensor) -> torch.Tensor:
    """``messages_anti_entropy`` of one round: two messages per live
    member on exchange rounds, counted before partition walls, loss and
    the contact gate (the reference's send-attempt convention), as an
    int32 device scalar."""
    live = alive_here.sum(dtype=torch.int32)
    return 2 * live if ae_due else torch.zeros_like(live)


def divergent_cells(status: torch.Tensor, inc: torch.Tensor,
                    alive_rows: torch.Tensor):
    """``(cell_mask [N, K] bool, divergent_cols [K] bool)``: live
    observers whose packed (status, incarnation) record differs from
    their column's maximum over live observers, and the columns holding
    any.  Frozen rows are left out (unreachable state).  Leading batch
    dimensions ([B, N, K] planes, [B, N] liveness) carry through."""
    key = records.merge_key(status, inc.to(torch.int32))
    live = alive_rows.bool()[..., :, None]
    col_max = torch.where(live, key, INT32_MIN).amax(dim=-2)
    cell_mask = live & (key != col_max[..., None, :])
    return cell_mask, cell_mask.any(dim=-2)


def divergence_probe(state, params, world, n_rounds: int) -> torch.Tensor:
    """Divergent-column count (int32 device scalar) of a carry after
    ``n_rounds`` rounds, in either carry layout: the compact carry's
    int16 incarnations widen (its other lanes are not read); liveness
    is the world's at cursor ``n_rounds``."""
    _, cols = divergent_cells(state.status, state.inc,
                              world.alive_at(int(n_rounds)))
    return cols.sum(dtype=torch.int32)
