"""The metadata KV plane: versioned per-member config, disseminated like
membership.

Counterpart of ``scalecube_cluster_tpu/models/metadata.py`` on one
device (the reference's ``MetadataStoreImpl``: a small KV map per member,
here shipped as payload on the round's existing channels instead of
fetched by RPC).  ``SwimParams.metadata_keys`` (M; 0, the default, leaves
the plane out of the round) sizes two lanes:

  ``md``        [N, K, M] int32: observer i's belief of subject k's M
                cells, one packed word each (full view: column k is node
                k);
  ``md_spread`` [N, K] int32: the absolute round until which row (i, k)
                is hot for piggyback gossip.

A word is ``(epoch & 0x7F) << 24 | version << 10 | value`` (0 = unset,
sign bit clear): a 10-bit value, a 14-bit per-(slot, epoch) version
saturating at 16383, the low 7 bits of the identity epoch.  Within one
(slot, epoch) the word is monotone in (version, value), so the merge is
a plain max (last writer wins) and the payload rides the max-folds of
both delivery modes unchanged.

Hot rows (``round < md_spread``) ride the gossip channels, the refute
push and the SYNC channel, the full table the anti-entropy pair; each
with the membership key's own gates and drops, so the plane takes no
draws.  Delivery is same-round only (never through the delay ring).
:func:`merge` gates on the receiver's post-merge identity belief (a word
of another epoch is dropped, a stale local cell zeroed), pins a member's
own cells, and takes the max.  :func:`divergent_count` is the
``metadata_divergent`` metric, :func:`divergence_probe` and
:func:`member_converged` the host-side convergence probes.
"""

from __future__ import annotations

from typing import Optional

import torch

# The packed word (module docstring): 31 bits, the sign bit clear so the
# scatter fill (-1) stays below every real word.
MD_VALUE_BITS = 10
MD_VERSION_BITS = 14
MD_EPOCH_BITS = 7
MD_VALUE_MAX = (1 << MD_VALUE_BITS) - 1
MD_VERSION_MAX = (1 << MD_VERSION_BITS) - 1
MD_EPOCH_MASK = (1 << MD_EPOCH_BITS) - 1

# The plane's row in the reference's plane inventory (an in-tick plane,
# compiled into the round by its knob, with two carry lanes).
PLANE = dict(
    name="metadata", kind="in-tick", knobs=("metadata_keys",),
    lanes=("md", "md_spread"),
    doc="per-member versioned KV (config) lane: LWW merge per "
        "(slot, epoch) identity, hot rows on piggyback gossip, full "
        "table on the anti-entropy exchange (metadata_keys > 0 arms "
        "it)",
)


def pack_word(epoch, version, value) -> torch.Tensor:
    """One md word from (epoch, version, value) int32 tensors or ints;
    the epoch is masked to its low bits, the others are the caller's to
    clamp."""
    def i32(x):
        return torch.as_tensor(x).to(torch.int32)

    return (((i32(epoch) & MD_EPOCH_MASK)
             << (MD_VERSION_BITS + MD_VALUE_BITS))
            | (i32(version) << MD_VALUE_BITS) | i32(value))


def word_epoch(word: torch.Tensor) -> torch.Tensor:
    return (word >> (MD_VERSION_BITS + MD_VALUE_BITS)) & MD_EPOCH_MASK


def word_version(word: torch.Tensor) -> torch.Tensor:
    return (word >> MD_VALUE_BITS) & MD_VERSION_MAX


def word_value(word: torch.Tensor) -> torch.Tensor:
    return word & MD_VALUE_MAX


def initial_lanes(params, device) -> dict:
    """The plane's lanes of a fresh state: empty tables [N, K, M] and
    closed windows [N, K]; zero-size ([N, 0, 0], [N, 0]) when off."""
    n, m = params.n_members, params.metadata_keys
    k = params.n_subjects if m else 0
    return dict(md=torch.zeros((n, k, m), dtype=torch.int32, device=device),
                md_spread=torch.zeros((n, k), dtype=torch.int32,
                                      device=device))


def inject_pushes(md: torch.Tensor, md_spread: torch.Tensor, round_idx: int,
                  params, pushes, own_epoch: Optional[torch.Tensor],
                  alive_here: torch.Tensor):
    """Apply this round's config pushes: ``pushes`` is the round's
    ``(node, key, value)`` host tuples in schedule order
    (``SwimWorld.push_rows``).  A push is an owner-local write: the node's
    own cell ``key`` takes ``value`` at version ``stored + 1``
    (saturating) under its ground-truth epoch (``own_epoch`` [N], None
    for epoch 0), and its own row opens a gossip window; a crashed node
    (``alive_here`` [N] false) does neither.  A key at or past
    ``metadata_keys`` writes no cell but opens the window, as in the
    reference.  The gate stays on the device (no host sync).  Returns
    new ``(md, md_spread)``; the inputs are not modified."""
    md, md_spread = md.clone(), md_spread.clone()
    m = md.shape[2]
    window = round_idx + 1 + params.periods_to_spread
    for node, key, value in pushes:
        live = alive_here[node]
        if key < m:
            old = md[node, node, key]
            version = torch.clamp(word_version(old) + 1, max=MD_VERSION_MAX)
            ep = 0 if own_epoch is None else own_epoch[node]
            md[node, node, key] = torch.where(
                live, pack_word(ep, version, value), old)
        md_spread[node, node] = torch.where(live, window,
                                            md_spread[node, node])
    return md, md_spread


def hot_payload(md: torch.Tensor, md_spread: torch.Tensor,
                round_idx: int) -> torch.Tensor:
    """[N, K*M] gossip payload: the hot rows, 0 elsewhere (the sender's
    own gates are the channel's)."""
    n, k, m = md.shape
    hot = (round_idx < md_spread)[:, :, None]
    return torch.where(hot, md, 0).reshape(n, k * m)


def full_payload(md: torch.Tensor) -> torch.Tensor:
    """[N, K*M] anti-entropy payload: the full table (a view)."""
    n, k, m = md.shape
    return md.reshape(n, k * m)


def merge(md: torch.Tensor, md_spread: torch.Tensor,
          arrivals: torch.Tensor, round_idx: int, params,
          is_self: torch.Tensor, epoch_belief: Optional[torch.Tensor],
          frozen_rows: torch.Tensor):
    """Fold one round's delivered words (``arrivals`` [N, K*M], the
    max-fold; a scatter fill of -1 clamps to unset) into the lanes, the
    reference's gates in order: (1) with the epoch guard on, a word whose
    epoch differs from the receiver's post-merge belief
    (``epoch_belief`` [N, K]) is dropped and a local cell of another
    epoch zeroed; (2) a member takes no word about its own cells
    (``is_self`` [N, K]); (3) the max.  A row that improved opens a
    gossip window; frozen rows (``frozen_rows`` [N]) keep their lanes.
    Returns ``(md, md_spread)``."""
    n, k, m = md.shape
    arr = torch.clamp(arrivals.reshape(n, k, m), min=0)
    if params.epoch_bits and epoch_belief is not None:
        belief = (epoch_belief.to(torch.int32) & MD_EPOCH_MASK)[:, :, None]
        arr = torch.where((arr != 0) & (word_epoch(arr) == belief), arr, 0)
        md = torch.where((md != 0) & (word_epoch(md) != belief), 0, md)
    arr = torch.where(is_self[:, :, None], 0, arr)
    new_md = torch.maximum(md, arr)
    improved = (new_md != md).any(dim=2)
    new_spread = torch.where(improved,
                             round_idx + 1 + params.periods_to_spread,
                             md_spread)
    frozen = frozen_rows[:, None]
    return (torch.where(frozen[:, :, None], md, new_md),
            torch.where(frozen, md_spread, new_spread))


def owner_words(md: torch.Tensor) -> torch.Tensor:
    """[N, M] the ground-truth table: each owner's words about itself
    (the diagonal; full view, one device)."""
    return torch.diagonal(md, dim1=0, dim2=1).T


def divergent_count(md: torch.Tensor, alive: torch.Tensor,
                    alive_here: torch.Tensor) -> torch.Tensor:
    """int32 scalar: the (live observer, live owner, key) cells whose word
    differs from the owner's own; 0 iff every live table agrees with
    every live owner (the ``metadata_divergent`` metric)."""
    cell = ((md != owner_words(md)[None, :, :])
            & alive_here[:, None, None] & alive[None, :, None])
    return cell.sum(dtype=torch.int32)


def divergence_probe(state, params, world, n_rounds: int) -> torch.Tensor:
    """Divergent-cell count (int32 device scalar) of a carry after
    ``n_rounds`` rounds, liveness the world's at cursor ``n_rounds``."""
    alive = world.alive_at(int(n_rounds))
    return divergent_count(state.md, alive, alive)


def member_converged(state, params, world, n_rounds: int) -> torch.Tensor:
    """[N] bool: members whose whole table agrees with every live owner's
    own words at cursor ``n_rounds``; a dead observer counts as
    converged."""
    alive = world.alive_at(int(n_rounds))
    mismatch = ((state.md != owner_words(state.md)[None, :, :])
                & alive[None, :, None])
    return ~(mismatch.any(dim=2).any(dim=1) & alive)
