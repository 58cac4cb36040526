"""The rollout's rollback arm (``chip_smoke.rollout_gated``'s breach
branch) against the bench's (``bench.py:1921-1948``), replayed on the JAX
package by ``tests/torch_rollout_reference.reference_gated``: at the
bench's N = 48 under the breach geometry (``chip_smoke.rollout_world(...,
breach=True)``), the port on the reference's world and draws ends in the
reference's state on every lane, with its converged rounds,
``converged``, ``p99``, ``rolled_back``, ``failed_stage`` and divergence
probe.  Exact, no tolerance.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from scalecube_cluster_tpu.models import metadata as jmetadata  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    assert_state_equal, jax_draws, one_torch_thread, port_params,
    port_world)
from tests.torch_rollout_reference import SEED, reference_gated  # noqa: E402

pytestmark = pytest.mark.torchport

N = chip_smoke.ROLLOUT_BENCH_N


@functools.lru_cache(maxsize=None)
def _both():
    """The reference's gated arm under the breach geometry and the port's
    on the reference's world and draws."""
    jstate, want, (_, jparams, jworld, _) = reference_gated(
        N, chip_smoke.ROLLOUT_BREACH_ROUNDS)
    _, geo = chip_smoke.rollout_world(N, "cpu", breach=True)
    state, got = chip_smoke.rollout_gated(
        port_params(jparams), port_world(jworld), geo, "cpu",
        draws=jax_draws(jax.random.key(SEED), jparams, jworld))
    return jstate, want, state, got, geo


def test_rollback_matches_the_bench_branch():
    """The first breach rolls stage 0 back and runs to the horizon: the
    final state equals the reference's on every lane, and so do the
    converged rounds, ``converged`` (false), ``p99`` (None),
    ``rolled_back``, ``failed_stage`` (0) and the divergence probe."""
    jstate, want, state, got, _ = _both()
    assert_state_equal(jstate, state)
    for key, value in want.items():
        assert got[key] == value, key
    assert (got["rolled_back"], got["failed_stage"], got["converged"],
            got["p99"]) == (True, 0, False, None)
    assert got["final_div"] == 0


def test_every_live_table_holds_the_rollback_value():
    """``rollback_held`` is true, and the reference's final state agrees:
    every table alive at the horizon's last round holds the rollback
    value for each of stage 0's owners.  The later stages' owners hold
    the rollout's value: the bench's rollback adds pushes to the world
    and leaves the later stages' own pushes in it."""
    jstate, _, _, got, geo = _both()
    rollout, horizon = geo["rollout"], geo["horizon"]
    assert got["rollback_held"] is True
    world, _ = chip_smoke.rollout_world(N, "cpu", breach=True)
    alive = world.alive_at(horizon - 1).numpy()
    md = np.asarray(jstate.md)[:, :, rollout.key] & jmetadata.MD_VALUE_MAX
    owners = list(rollout.stage_members(0))
    assert ((md[:, owners] == rollout.rollback_value)
            | ~alive[:, None]).all()
    later = [m for s in range(1, rollout.n_stages)
             for m in rollout.stage_members(s)]
    assert ((md[:, later] == rollout.value) | ~alive[:, None]).all()


def test_breach_geometry():
    """``breach=True`` moves only stage 0's deadlines, to their clock
    start plus ``ROLLOUT_BREACH_ROUNDS``; the other pushes and the world
    are the gated arm's."""
    world, geo = chip_smoke.rollout_world(N, "cpu")
    b_world, b_geo = chip_smoke.rollout_world(N, "cpu", breach=True)
    stage0 = geo["rollout"].stage_round(0)
    assert len(geo["pushes"]) == len(b_geo["pushes"]) > 0
    for p, q in zip(geo["pushes"], b_geo["pushes"]):
        if p["push_round"] == stage0:
            assert q == dict(p, deadline=p["clock_from"]
                             + chip_smoke.ROLLOUT_BREACH_ROUNDS)
        else:
            assert q == p
    for name in ("down_from", "down_until"):
        assert torch.equal(getattr(world, name), getattr(b_world, name))
