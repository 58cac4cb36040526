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
from typing import Tuple

import torch

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass
class RoundDraws:
    """Exactly the randomness one main-path round consumes.

    ``shifts``   ``1 + R + F + 1`` host ints in [1, N): the FD target,
                 R ping-req proxies, F gossip channels, the SYNC channel.
    ``u_direct`` [N] float32: the direct-ping chain draw.
    ``u_proxy``  [R, N] float32: one chain draw per proxy.
    ``drop_u``   [N, F + 1] float32: per-receiver gossip/SYNC drop draws.
    ``u_refute`` [N] float32: the refute push's drop draw.
    """

    shifts: Tuple[int, ...]
    u_direct: torch.Tensor
    u_proxy: torch.Tensor
    drop_u: torch.Tensor
    u_refute: torch.Tensor

    def to(self, device) -> "RoundDraws":
        return RoundDraws(
            shifts=self.shifts,
            u_direct=self.u_direct.to(device),
            u_proxy=self.u_proxy.to(device),
            drop_u=self.drop_u.to(device),
            u_refute=self.u_refute.to(device),
        )


def round_seed(seed: int, round_idx: int) -> int:
    """SplitMix64 of ``(seed, round_idx)`` — the per-round generator seed
    (63 bits, as ``manual_seed`` takes)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(round_idx) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


class TorchDraws:
    """The port's :class:`RoundDraws` source for ``(seed, device)``;
    ``params`` (a ``models.swim.SwimParams``) fixes the shapes."""

    def __init__(self, seed: int, device, params):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.n = params.n_members
        self.r = params.ping_req_members
        self.f = params.fanout
        self._host = torch.Generator()
        self._dev = torch.Generator(device=self.device)

    def __call__(self, round_idx: int) -> RoundDraws:
        s = round_seed(self.seed, round_idx)
        self._host.manual_seed(s)
        self._dev.manual_seed(s)
        n_shifts = 1 + self.r + self.f + 1
        shifts = torch.randint(1, self.n, (n_shifts,), generator=self._host)

        def uniform(*shape):
            return torch.rand(shape, generator=self._dev, device=self.device,
                              dtype=torch.float32)

        return RoundDraws(
            shifts=tuple(shifts.tolist()),
            u_direct=uniform(self.n),
            u_proxy=uniform(self.r, self.n),
            drop_u=uniform(self.n, self.f + 1),
            u_refute=uniform(self.n),
        )
