"""The port's K-tiled full-view round (``SwimParams.k_block``) against the
JAX package's own ``k_block`` runs, and against the port's unblocked
round.

Whole runs at full view 48 x 48 with ``k_block=16`` (three column
blocks), loss 0.2, 40 rounds: the four scenarios of
``tests/test_blocked_tick.py`` (a crash and revive, a graceful leave, a
sender blocked to everyone, a two-phase partition) in the wide and
compact layouts, one ``int16_wire`` and one compact + ``wire24`` run,
and a run with user gossips and the aggregate metrics.  Both sides get
the reference's own draws; every state lane and every stacked metric
must be equal, and the port's unblocked run with the same draws gives
the same.  Then a blocked checkpoint resume, the validation errors, the
seed-gated refusal, ``swim_tick`` leaving its input untouched, and
``node_snapshot`` of the final wide and compact states against the
reference's.

Cost: seven reference programs (the worlds of a params share one: every
world carries a two-phase partition schedule, and the blocked link is
its own program since a rule changes the draws), each sent to a compile
thread as soon as it is lowered, with most XLA optimizations off (no
delay sums here, so no FMA to keep).
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu_torch.models import swim  # noqa: E402
from tests.test_swim_model import fast_config  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    STATE_FIELDS, assert_metrics_equal, assert_state_equal, jax_draws,
    one_torch_thread, port_params, port_world)

pytestmark = pytest.mark.torchport

N, KB, ROUNDS = 48, 16, 40
SCENARIOS = ("crash_revive", "leave", "link_block", "partition")
# name -> (params overrides, scenario)
CASES = {
    **{f"{scenario}-{layout}": (dict(compact_carry=layout == "compact"),
                                scenario)
       for scenario in SCENARIOS for layout in ("wide", "compact")},
    "crash_revive-int16_wire": (dict(int16_wire=True), "crash_revive"),
    "crash_revive-compact_wire24": (dict(compact_carry=True, wire24=True),
                                    "crash_revive"),
    "gossip-aggregate": (dict(n_user_gossips=2, per_subject_metrics=False),
                         "gossip"),
}


@pytest.fixture(autouse=True, scope="module")
def quick_reference_compiles():
    previous = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", previous)


def _jparams(k_block=KB, **overrides):
    # suspicion_mult=1 brings SUSPECT -> DEAD inside the run.
    return jswim.SwimParams.from_config(
        fast_config().replace(suspicion_mult=1), n_members=N,
        loss_probability=0.2, delivery="shift", k_block=k_block, **overrides)


def _jworld(params, scenario):
    split = (np.arange(N) >= N // 2).astype(np.int8)
    phases = np.stack([split if scenario == "partition" else
                       np.zeros(N, np.int8), np.zeros(N, np.int8)])
    w = jswim.SwimWorld.healthy(params).with_partition_schedule(
        phases, phase_rounds=12)
    if scenario == "crash_revive":
        w = w.with_crash(3, at_round=2, until_round=20)
    if scenario == "leave":
        w = w.with_leave(7, at_round=8)
    if scenario == "link_block":
        w = w.with_block(1, (0, N), until_round=20)
    if scenario == "gossip":
        w = (w.with_crash(5, at_round=3).with_spread(0, 1, 0)
             .with_spread(1, 20, 10))
    return w


def _program_key(case):
    overrides, scenario = CASES[case]
    return tuple(sorted(overrides.items())) + (scenario == "link_block",)


@functools.lru_cache(maxsize=None)
def _reference_programs():
    """JAX's blocked ``run`` over ROUNDS rounds, one program per params
    and rule count, lowered one after another and compiled in the
    background three at a time."""
    compiling = {}
    with ThreadPoolExecutor(3) as pool:
        for case, (overrides, scenario) in CASES.items():
            key = _program_key(case)
            if key in compiling:
                continue
            params = _jparams(**overrides)
            world = _jworld(params, scenario)
            compiling[key] = pool.submit(jswim.run.lower(
                jax.random.key(0), params, world, ROUNDS,
                state=jswim.initial_state(params, world),
                start_round=0).compile)
        return {key: job.result() for key, job in compiling.items()}


@functools.lru_cache(maxsize=None)
def _draws(link_rule):
    """The reference's draws, built once a draw kind (a rule switches the
    FD chains to per-hop draws) and kept per round."""
    params = _jparams()
    world = _jworld(params, "link_block" if link_rule else "leave")
    return functools.lru_cache(maxsize=None)(
        jax_draws(jax.random.key(0), params, world))


def _case(case):
    overrides, scenario = CASES[case]
    jparams = _jparams(**overrides)
    jworld = _jworld(jparams, scenario)
    return jparams, jworld, _draws(scenario == "link_block")


@pytest.mark.parametrize("case", sorted(CASES))
def test_blocked_run_matches_reference(case):
    jparams, jworld, draws = _case(case)
    jstate, jmetrics = _reference_programs()[_program_key(case)](
        jax.random.key(0), jworld, state=jswim.initial_state(jparams, jworld),
        start_round=0)
    params, world = port_params(jparams), port_world(jworld)
    assert params.k_block == KB
    state, metrics = swim.run(0, params, world, ROUNDS, draws=draws,
                              device="cpu")
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, metrics)
    # The port's unblocked round gives the same, bit for bit.
    flat, flat_metrics = swim.run(0, dataclasses.replace(params, k_block=0),
                                  world, ROUNDS, draws=draws, device="cpu")
    for name in STATE_FIELDS:
        assert torch.equal(getattr(flat, name), getattr(state, name)), name
    for name, value in flat_metrics.items():
        assert torch.equal(value, metrics[name]), name
    dead = metrics["dead"] if metrics["dead"].dim() == 1 else \
        metrics["dead"].sum(dim=1)
    assert int(dead.max()) > 0
    if case.startswith("gossip"):
        assert int(metrics["user_gossip_infected"][-1].min()) > N // 2


def test_blocked_checkpoint_resume_matches_reference():
    """A compact blocked run stopped at round 17 and resumed from its
    state (the carry never leaves its stored layout) ends where the
    reference's unbroken run does."""
    jparams, jworld, draws = _case("crash_revive-compact")
    jstate, jmetrics = _reference_programs()[_program_key(
        "crash_revive-compact")](jax.random.key(0), jworld,
                                 state=jswim.initial_state(jparams, jworld),
                                 start_round=0)
    params, world = port_params(jparams), port_world(jworld)
    half, m_a = swim.run(0, params, world, 17, draws=draws, device="cpu")
    state, m_b = swim.run(0, params, world, ROUNDS - 17, state=half,
                          start_round=17, draws=draws, device="cpu")
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, {name: torch.cat([m_a[name], m_b[name]])
                                    for name in m_a})


def test_swim_tick_leaves_its_input_untouched():
    """The blocked round writes a fresh output carry; stepping it with
    ``swim_tick`` gives ``run``'s states and keeps each input as it was."""
    params = port_params(_jparams(compact_carry=True))
    world = swim.SwimWorld.healthy(params, device="cpu").with_crash(
        3, at_round=1)
    draws = _draws(False)
    want, want_metrics = swim.run(0, params, world, 6, draws=draws,
                                  device="cpu")
    state = swim.initial_state(params, world, device="cpu")
    for round_idx in range(6):
        before = {name: getattr(state, name).clone() for name in STATE_FIELDS}
        state_next, metrics = swim.swim_tick(state, round_idx, params, world,
                                             draws(round_idx))
        for name, value in before.items():
            assert torch.equal(getattr(state, name), value), name
        state = state_next
    for name in STATE_FIELDS:
        assert torch.equal(getattr(state, name), getattr(want, name)), name
    assert all(torch.equal(value, want_metrics[name][-1])
               for name, value in metrics.items())


@pytest.mark.parametrize("overrides,error,match", [
    (dict(k_block=7), ValueError, "divide"),
    (dict(n_subjects=8, ping_known_only=False, k_block=4), ValueError,
     "full-view"),
    (dict(delivery="scatter", k_block=16), ValueError, "full-view"),
    (dict(k_block=16, max_delay_rounds=2), ValueError, "capacity"),
    (dict(k_block=16, link_counters=True), ValueError, "capacity"),
])
def test_blocked_validation_errors(overrides, error, match):
    """The reference's k_block constraints, raised as it raises them."""
    base = dataclasses.asdict(_jparams(k_block=0))
    with pytest.raises(error, match=match):
        jswim.SwimParams(**dict(base, **overrides))
    with pytest.raises(error, match=match):
        swim.SwimParams(**dict(base, **overrides))


def test_blocked_refuses_seed_gated_contacts():
    params = port_params(_jparams())
    world = swim.SwimWorld.healthy(params, device="cpu").with_seeds([0])
    state = swim.initial_state(params, world, device="cpu")
    with pytest.raises(NotImplementedError, match="seed-gated"):
        swim.swim_tick(state, 0, params, world,
                       swim.prng.TorchDraws(0, "cpu", params, world)(0))


@pytest.mark.parametrize("layout", ["wide", "compact"])
def test_node_snapshot_matches_reference(layout):
    """``node_snapshot`` of the blocked run's final state equals the
    reference's digest of its own final state, key for key, for the
    revived node, a node that watched it and the blocked sender."""
    case = f"crash_revive-{layout}"
    jparams, jworld, draws = _case(case)
    jstate, _ = _reference_programs()[_program_key(case)](
        jax.random.key(0), jworld, state=jswim.initial_state(jparams, jworld),
        start_round=0)
    params, world = port_params(jparams), port_world(jworld)
    state, _ = swim.run(0, params, world, ROUNDS, draws=draws, device="cpu")
    for node in (0, 3, 47):
        want = jswim.node_snapshot(jstate, jparams, jworld, node,
                                   round_idx=ROUNDS)
        got = swim.node_snapshot(state, params, world, node,
                                 round_idx=ROUNDS)
        assert got == want, node


def test_node_snapshot_of_compact_state_needs_round_idx():
    params = port_params(_jparams(compact_carry=True))
    world = swim.SwimWorld.healthy(params, device="cpu")
    state = swim.initial_state(params, world, device="cpu")
    with pytest.raises(ValueError, match="round_idx"):
        swim.node_snapshot(state, params, world, 0)
    snap = swim.node_snapshot(state, params, world, 0, round_idx=0)
    assert snap["alive_members"] == list(range(1, N))
    assert snap["pending_suspicion_timers"] == {}
