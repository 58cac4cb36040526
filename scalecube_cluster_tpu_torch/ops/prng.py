"""Per-round randomness of the shift round, behind one seam.

The reference draws every round's randomness from ``jax.random`` keys
folded with the round index (``scalecube_cluster_tpu/ops/prng.py``).
Here a round's randomness is one :class:`RoundDraws`, and the tick takes
it from any callable ``round_idx -> RoundDraws``.

:class:`TorchDraws` is the port's own source: a CPU ``torch.Generator``
for the channel shifts (host ints, so slicing needs no device sync) and
a device generator for the float32 uniforms, both seeded from a mix of
``(seed, round_idx)`` — a resume at ``start_round`` redraws exactly the
rounds it replays.

The port's own draws differ from the reference's for the same seed
(``torch.Generator`` is not threefry).  Parity with the JAX package is
held by feeding both sides the same draws: the tests rebuild a
``RoundDraws`` from a JAX key with the reference's own ``jax.random``
calls and pass it to ``models.swim.run(..., draws=...)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class DrawFacts:
    """The static facts that decide which draws a round takes.

    ``delayed``: some hop delay is not statically zero (the world has
    link-fault rules, or ``mean_delay_ms != 0``; the reference's
    ``link_eval`` then returns a delay array, not ``None``), so every FD
    chain samples per-hop losses and delays instead of one collapsed
    Bernoulli.  ``delay_bins``: delayed and the ring is on
    (``max_delay_rounds > 0``), so each delivery channel bins its
    messages.  ``n_seeds``: the seed count when the contact gate is on
    (full view with seeds), else 0."""

    delayed: bool
    delay_bins: bool
    n_seeds: int

    @staticmethod
    def of(params, world=None) -> "DrawFacts":
        n_rules = 0 if world is None else world.faults.n_rules
        n_seeds = 0 if world is None else int(world.seed_ids.shape[0])
        delayed = n_rules > 0 or params.mean_delay_ms != 0.0
        return DrawFacts(
            delayed=delayed,
            delay_bins=delayed and params.max_delay_rounds > 0,
            n_seeds=n_seeds if params.full_view else 0)


@dataclasses.dataclass
class RoundDraws:
    """Exactly the randomness one round consumes.

    ``shifts``   ``1 + R + F + 1`` host ints in [1, N): the FD target,
                 R ping-req proxies, F gossip channels, the SYNC channel.
    ``drop_u``   [N, F + 1] float32: per-receiver gossip/SYNC drop draws.
    ``u_refute`` [N] float32: the refute push's drop draw.

    The FD chains, collapsed (``DrawFacts.delayed`` false):

    ``u_direct`` [N] float32: the direct-ping chain draw.
    ``u_proxy``  [R, N] float32: one chain draw per proxy.

    or delayed (``delayed`` true; the reference draws one ``uniform(key,
    (*shape, n_hops + n_hops))``, loss uniforms first):

    ``chain_u_direct`` / ``chain_e_direct`` [N, 2] float32: per-hop loss
                 uniforms and unit exponentials of the ping round trip.
    ``chain_u_proxy`` / ``chain_e_proxy`` [R, N, 4] float32: the same
                 for each proxy chain's four hops.

    Delay bins (``delay_bins``): unit exponentials ``e_gossip`` [F, N],
    ``e_sync`` [N] and ``e_refute`` [N], one a message.

    Seed anti-entropy (``n_seeds`` = S > 0): ``seed_sel`` [N] int32 in
    [0, S), each member's seed, and the push and ack loss uniforms
    ``seed_push_u`` / ``seed_ack_u`` [S, N] float32.

    A unit exponential is ``-log1p(-u)`` of a uniform, computed once by
    the draw source, so that the CPU, the card and the reference read
    the same float32 values.  Fields a round does not take are None.
    """

    shifts: Tuple[int, ...]
    u_direct: Optional[torch.Tensor]
    u_proxy: Optional[torch.Tensor]
    drop_u: torch.Tensor
    u_refute: torch.Tensor
    chain_u_direct: Optional[torch.Tensor] = None
    chain_e_direct: Optional[torch.Tensor] = None
    chain_u_proxy: Optional[torch.Tensor] = None
    chain_e_proxy: Optional[torch.Tensor] = None
    e_gossip: Optional[torch.Tensor] = None
    e_sync: Optional[torch.Tensor] = None
    e_refute: Optional[torch.Tensor] = None
    seed_sel: Optional[torch.Tensor] = None
    seed_push_u: Optional[torch.Tensor] = None
    seed_ack_u: Optional[torch.Tensor] = None

    def to(self, device) -> "RoundDraws":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def unit_exponential(u: torch.Tensor) -> torch.Tensor:
    """``-log1p(-u)``: an Exp(1) draw from a uniform in [0, 1)."""
    return -torch.log1p(-u)


def round_seed(seed: int, round_idx: int) -> int:
    """SplitMix64 of ``(seed, round_idx)`` — the per-round generator seed
    (63 bits, as ``manual_seed`` takes)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(round_idx) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


class TorchDraws:
    """The port's :class:`RoundDraws` source for ``(seed, device)``;
    ``params`` (a ``models.swim.SwimParams``) fixes the shapes and, with
    ``world`` (a ``models.swim.SwimWorld``; None = no rules, no seeds),
    which fields a round takes (:class:`DrawFacts`)."""

    def __init__(self, seed: int, device, params, world=None):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.n = params.n_members
        self.r = params.ping_req_members
        self.f = params.fanout
        self.facts = DrawFacts.of(params, world)
        self._host = torch.Generator()
        self._dev = torch.Generator(device=self.device)

    def __call__(self, round_idx: int) -> RoundDraws:
        s = round_seed(self.seed, round_idx)
        self._host.manual_seed(s)
        self._dev.manual_seed(s)
        n, r, f, facts = self.n, self.r, self.f, self.facts
        n_shifts = 1 + r + f + 1
        shifts = torch.randint(1, n, (n_shifts,), generator=self._host)

        def uniform(*shape):
            return torch.rand(shape, generator=self._dev, device=self.device,
                              dtype=torch.float32)

        chains = dict(u_direct=None, u_proxy=None)
        if facts.delayed:
            chains.update(
                chain_u_direct=uniform(n, 2),
                chain_e_direct=unit_exponential(uniform(n, 2)),
                chain_u_proxy=uniform(r, n, 4),
                chain_e_proxy=unit_exponential(uniform(r, n, 4)))
        else:
            chains.update(u_direct=uniform(n), u_proxy=uniform(r, n))
        draws = RoundDraws(shifts=tuple(shifts.tolist()),
                           drop_u=uniform(n, f + 1), u_refute=uniform(n),
                           **chains)
        if facts.delay_bins:
            draws.e_gossip = unit_exponential(uniform(f, n))
            draws.e_sync = unit_exponential(uniform(n))
            draws.e_refute = unit_exponential(uniform(n))
        if facts.n_seeds:
            draws.seed_sel = torch.randint(
                0, facts.n_seeds, (n,), generator=self._dev,
                device=self.device, dtype=torch.int32)
            draws.seed_push_u = uniform(facts.n_seeds, n)
            draws.seed_ack_u = uniform(facts.n_seeds, n)
        return draws
