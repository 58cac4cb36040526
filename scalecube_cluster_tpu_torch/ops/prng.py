"""Per-round randomness of the round, behind one seam.

The reference draws every round's randomness from ``jax.random`` keys
folded with the round index (``scalecube_cluster_tpu/ops/prng.py``).
Here a round's randomness is one :class:`RoundDraws` (shift delivery)
or :class:`ScatterDraws` (scatter delivery), and the tick takes it from
any callable ``round_idx -> draws``.

:class:`TorchDraws` is the port's own source: a CPU ``torch.Generator``
for the channel shifts (host ints, so slicing needs no device sync) and
a device generator for the float32 uniforms and the scatter targets,
both seeded from a mix of ``(seed, round_idx)`` — a resume at
``start_round`` redraws exactly the rounds it replays.

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

    ``delivery``: ``"shift"`` (:class:`RoundDraws`) or ``"scatter"``
    (:class:`ScatterDraws`).  ``known_only``: the scatter probe picks
    its target among the subjects its row holds live (Gumbel noise over
    [N, K]) rather than uniformly over the members.
    ``delayed``: some hop delay is not statically zero (the world has
    link-fault rules, or ``mean_delay_ms != 0``; the reference's
    ``link_eval`` then returns a delay array, not ``None``), so every FD
    chain samples per-hop losses and delays instead of one collapsed
    Bernoulli.  ``delay_bins``: delayed and the ring is on
    (``max_delay_rounds > 0``), so each delivery channel bins its
    messages.  ``n_seeds``: the seed count when the contact gate is on
    (full view with seeds), else 0.  ``sync_plane``: the anti-entropy
    exchange is on (``sync_interval > 0``).  ``lifeguard``: the health
    plane is on (``lhm_max > 0``)."""

    delivery: str
    known_only: bool
    delayed: bool
    delay_bins: bool
    n_seeds: int
    sync_plane: bool = False
    lifeguard: bool = False

    @staticmethod
    def of(params, world=None) -> "DrawFacts":
        n_rules = 0 if world is None else world.faults.n_rules
        n_seeds = 0 if world is None else int(world.seed_ids.shape[0])
        delayed = n_rules > 0 or params.mean_delay_ms != 0.0
        return DrawFacts(
            delivery=params.delivery,
            known_only=(params.delivery == "scatter"
                        and bool(params.ping_known_only)),
            delayed=delayed,
            delay_bins=delayed and params.max_delay_rounds > 0,
            n_seeds=n_seeds if params.full_view else 0,
            sync_plane=params.sync_interval > 0,
            lifeguard=params.lhm_max > 0)


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

    The anti-entropy exchange (``sync_plane``): ``ae_offset``, its
    shared partner offset, a host int in [1, N), and ``ae_drop_u`` [2,
    N] float32, the loss uniforms of its two directions.  Lifeguard
    (``lifeguard``): ``lhm_gate_u`` [N] float32, the probe gate's
    uniforms.

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
    ae_offset: Optional[int] = None
    ae_drop_u: Optional[torch.Tensor] = None
    lhm_gate_u: Optional[torch.Tensor] = None

    DELIVERY = "shift"

    @staticmethod
    def fields_for(facts: DrawFacts) -> Tuple[Tuple[str, ...],
                                              Tuple[str, ...]]:
        """(the optional fields a round under ``facts`` takes, the ones
        it must not carry)."""
        chains = (("chain_u_direct", "chain_e_direct", "chain_u_proxy",
                   "chain_e_proxy"), ("u_direct", "u_proxy"))
        need, other = chains if facts.delayed else chains[::-1]
        if facts.delay_bins:
            need += ("e_gossip", "e_sync", "e_refute")
        if facts.n_seeds:
            need += ("seed_sel", "seed_push_u", "seed_ack_u")
        return _plane_fields(facts, need, other)

    def to(self, device) -> "RoundDraws":
        return _draws_to(self, device)


@dataclasses.dataclass
class ScatterDraws:
    """Exactly the randomness one scatter round consumes (the reference's
    eight per-round keys, ``models/swim.py:2684-2871``).  Targets are the
    raw draws in [0, N - 1); :func:`targets_excluding_self` shifts them
    past the sender.

    ``ping_t``      [N] int32: the focal probe's uniform target draw, or
    ``ping_gumbel`` [N, K] float32: the known-only probe's Gumbel noise
                    (``DrawFacts.known_only``), for :func:`choose_eligible`.
    ``proxies``     [N, R] int32: the ping-req proxies.
    ``gossip_t``    [N, F] int32: the gossip targets.
    ``gossip_drop_u`` [N, F] float32: the gossip loss draws.
    ``sync_t``      [N] int32: the SYNC target.
    ``sync_drop_u`` [N] float32: the SYNC loss draw.

    The FD chains, collapsed: ``u_direct`` [N] and ``proxy_u`` [N, R]
    float32 (one uniform a chain); or delayed: ``chain_u_direct`` /
    ``chain_e_direct`` [N, 2] as in :class:`RoundDraws`, and
    ``proxy_chain_u`` / ``proxy_chain_e`` [N, R, 4] (the reference's one
    ``uniform(key, (N, R, 8))``, loss uniforms first).

    Delay bins: unit exponentials ``gossip_e`` [N, F] and ``e_sync``
    [N].  Seed anti-entropy: ``seed_sel`` / ``seed_push_u`` /
    ``seed_ack_u`` as in :class:`RoundDraws`.  The anti-entropy
    exchange: ``ae_offset`` as in :class:`RoundDraws` and ``ae_drop_u``
    [N, 2] float32 (sender-indexed, one column a direction); Lifeguard:
    ``lhm_gate_u`` [N].  There are no channel shifts and no refute
    draw: the refute push redirects the SYNC target.  Fields a round
    does not take are None."""

    proxies: torch.Tensor
    gossip_t: torch.Tensor
    gossip_drop_u: torch.Tensor
    sync_t: torch.Tensor
    sync_drop_u: torch.Tensor
    ping_t: Optional[torch.Tensor] = None
    ping_gumbel: Optional[torch.Tensor] = None
    u_direct: Optional[torch.Tensor] = None
    proxy_u: Optional[torch.Tensor] = None
    chain_u_direct: Optional[torch.Tensor] = None
    chain_e_direct: Optional[torch.Tensor] = None
    proxy_chain_u: Optional[torch.Tensor] = None
    proxy_chain_e: Optional[torch.Tensor] = None
    gossip_e: Optional[torch.Tensor] = None
    e_sync: Optional[torch.Tensor] = None
    seed_sel: Optional[torch.Tensor] = None
    seed_push_u: Optional[torch.Tensor] = None
    seed_ack_u: Optional[torch.Tensor] = None
    ae_offset: Optional[int] = None
    ae_drop_u: Optional[torch.Tensor] = None
    lhm_gate_u: Optional[torch.Tensor] = None

    DELIVERY = "scatter"

    @staticmethod
    def fields_for(facts: DrawFacts) -> Tuple[Tuple[str, ...],
                                              Tuple[str, ...]]:
        """(the optional fields a round under ``facts`` takes, the ones
        it must not carry)."""
        chains = (("chain_u_direct", "chain_e_direct", "proxy_chain_u",
                   "proxy_chain_e"), ("u_direct", "proxy_u"))
        need, other = chains if facts.delayed else chains[::-1]
        pings = ("ping_gumbel", "ping_t")
        need += pings[:1] if facts.known_only else pings[1:]
        other += pings[1:] if facts.known_only else pings[:1]
        if facts.delay_bins:
            need += ("gossip_e", "e_sync")
        if facts.n_seeds:
            need += ("seed_sel", "seed_push_u", "seed_ack_u")
        return _plane_fields(facts, need, other)

    def to(self, device) -> "ScatterDraws":
        return _draws_to(self, device)


def _plane_fields(facts: DrawFacts, need, other):
    """``(need, other)`` with the planes' draws added to the side their
    facts put them on."""
    for on, names in ((facts.sync_plane, ("ae_offset", "ae_drop_u")),
                      (facts.lifeguard, ("lhm_gate_u",))):
        if on:
            need += names
        else:
            other += names
    return need, other


def _draws_to(draws, device):
    return dataclasses.replace(draws, **{
        f.name: getattr(draws, f.name).to(device)
        for f in dataclasses.fields(draws)
        if isinstance(getattr(draws, f.name), torch.Tensor)})


def targets_excluding_self(draws: torch.Tensor,
                           sender_ids: torch.Tensor) -> torch.Tensor:
    """Uniform targets other than the sender from raw draws in [0, N - 1)
    ([N, F] against [N] sender ids): a draw at or above the sender's id
    moves up by one, as the reference's ``targets_excluding_self``."""
    sender = sender_ids[:, None].to(draws.dtype)
    return torch.where(draws >= sender, draws + 1, draws)


def choose_eligible(gumbel: torch.Tensor, eligible: torch.Tensor):
    """One index among ``eligible`` [N, K] entries a row, uniformly, by
    the Gumbel argmax (the reference's ``choose_eligible``): returns
    ``(index int64 [N], any_eligible [N])``.  The first maximum wins in
    both argmaxes, and a row with no eligible entry gives index 0."""
    scores = torch.where(eligible, gumbel,
                         torch.full((), float("-inf"), dtype=gumbel.dtype,
                                    device=gumbel.device))
    return scores.argmax(dim=-1), eligible.any(dim=-1)


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
    """The port's draw source for ``(seed, device)``: a :class:`RoundDraws`
    or :class:`ScatterDraws` a round, as ``params.delivery`` says.
    ``params`` (a ``models.swim.SwimParams``) fixes the shapes and, with
    ``world`` (a ``models.swim.SwimWorld``; None = no rules, no seeds),
    which fields a round takes (:class:`DrawFacts`)."""

    def __init__(self, seed: int, device, params, world=None):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.n = params.n_members
        self.k = params.n_subjects
        self.r = params.ping_req_members
        self.f = params.fanout
        self.facts = DrawFacts.of(params, world)
        self._host = torch.Generator()
        self._dev = torch.Generator(device=self.device)

    def _uniform(self, *shape) -> torch.Tensor:
        return torch.rand(shape, generator=self._dev, device=self.device,
                          dtype=torch.float32)

    def _seeds(self, draws) -> None:
        n, facts = self.n, self.facts
        if facts.n_seeds:
            draws.seed_sel = torch.randint(
                0, facts.n_seeds, (n,), generator=self._dev,
                device=self.device, dtype=torch.int32)
            draws.seed_push_u = self._uniform(facts.n_seeds, n)
            draws.seed_ack_u = self._uniform(facts.n_seeds, n)

    def _planes(self, draws, drop_shape) -> None:
        """The planes' draws, taken after every other draw of the round
        (so a plane that is off leaves the other draws as they were)."""
        if self.facts.sync_plane:
            draws.ae_offset = int(torch.randint(1, self.n, (1,),
                                                generator=self._host))
            draws.ae_drop_u = self._uniform(*drop_shape)
        if self.facts.lifeguard:
            draws.lhm_gate_u = self._uniform(self.n)

    def __call__(self, round_idx: int):
        s = round_seed(self.seed, round_idx)
        self._host.manual_seed(s)
        self._dev.manual_seed(s)
        if self.facts.delivery == "scatter":
            return self._scatter()
        n, r, f, facts = self.n, self.r, self.f, self.facts
        uniform = self._uniform
        n_shifts = 1 + r + f + 1
        shifts = torch.randint(1, n, (n_shifts,), generator=self._host)
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
        self._seeds(draws)
        self._planes(draws, (2, n))
        return draws

    def _scatter(self) -> ScatterDraws:
        n, k, r, f, facts = self.n, self.k, self.r, self.f, self.facts
        uniform = self._uniform

        def targets(*shape):
            return torch.randint(0, n - 1, shape, generator=self._dev,
                                 device=self.device, dtype=torch.int32)

        draws = ScatterDraws(proxies=targets(n, r), gossip_t=targets(n, f),
                             gossip_drop_u=uniform(n, f), sync_t=targets(n),
                             sync_drop_u=uniform(n))
        if facts.known_only:
            # Gumbel(0, 1) noise, the uniform kept off 0 (as jax.random's).
            tiny = torch.finfo(torch.float32).tiny
            draws.ping_gumbel = -torch.log(-torch.log(
                uniform(n, k).clamp_(min=tiny)))
        else:
            draws.ping_t = targets(n)
        if facts.delayed:
            draws.chain_u_direct = uniform(n, 2)
            draws.chain_e_direct = unit_exponential(uniform(n, 2))
            draws.proxy_chain_u = uniform(n, r, 4)
            draws.proxy_chain_e = unit_exponential(uniform(n, r, 4))
        else:
            draws.u_direct = uniform(n)
            draws.proxy_u = uniform(n, r)
        if facts.delay_bins:
            draws.gossip_e = unit_exponential(uniform(n, f))
            draws.e_sync = unit_exponential(uniform(n))
        self._seeds(draws)
        self._planes(draws, (n, 2))
        return draws
