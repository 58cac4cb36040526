"""The port's dead-member suppression window
(``SwimParams.dead_suppress_rounds``) against the JAX package.

The merge gate's rule (``ops/delivery.merge_inbox(..., suppress=)``) on
the reference's unit planes and on seeded planes in the three wire
formats; then the headline of ``tests/test_dead_suppression.py:125-160``,
the mid-suspicion heal (scatter, n = 16, ``sync_interval=8``, a split of
48 rounds), in both arms: without the window (``supp`` 0) the subjects
burn incarnations without end and the tables stay divergent; with 64 the
burn stops inside the window and the anti-entropy exchange re-converges
the tables.  Both sides on the reference's own draws, every state lane
and stacked metric compared exactly, round by round (the reference's
three segments in steps of 4 rounds).  A shift run and a ``k_block``
compact run with the window on do the same in the other tick bodies.

Cost: four reference programs, each sent to a compile thread as soon as
it is lowered, with most XLA optimizations off (no delay sums, so no FMA
to keep).
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu.ops import delivery as jdelivery  # noqa: E402
from scalecube_cluster_tpu_torch import records  # noqa: E402
from scalecube_cluster_tpu_torch.models import swim  # noqa: E402
from scalecube_cluster_tpu_torch.models import sync  # noqa: E402
from scalecube_cluster_tpu_torch.ops import delivery  # noqa: E402
from tests.test_swim_model import fast_config  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    assert_metrics_equal, assert_state_equal, jax_draws, one_torch_thread,
    port_params, port_world)

pytestmark = pytest.mark.torchport

N, SPLIT, STEP = 16, 48, 4
# name -> (params overrides, rounds); each runs in steps of STEP rounds.
RUNS = {
    "heal-supp0": (dict(delivery="scatter", dead_suppress_rounds=0),
                   SPLIT + 0 + 40 + 120),
    "heal-supp64": (dict(delivery="scatter", dead_suppress_rounds=64),
                    SPLIT + 64 + 40 + 120),
    "shift": (dict(delivery="shift", dead_suppress_rounds=64,
                   loss_probability=0.05), 160),
    "k_block-compact": (dict(delivery="shift", dead_suppress_rounds=64,
                             k_block=4, compact_carry=True,
                             loss_probability=0.05), 160),
}


@pytest.fixture(autouse=True, scope="module")
def quick_reference_compiles():
    previous = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", previous)


# --------------------------------------------------------------------------
# The merge gate
# --------------------------------------------------------------------------


def test_suppressed_gate_unit_planes():
    """The reference's unit pin: a suppressed tombstone DEAD@5 rejects
    ALIVE@5, ALIVE@9 and DEAD@5 and takes DEAD@6; unsuppressed it
    reopens for ALIVE at any incarnation."""
    status = torch.full((1, 4), records.DEAD, dtype=torch.int8)
    inc = torch.full((1, 4), 5, dtype=torch.int32)
    inbox = records.merge_key(torch.tensor([[0, 0, 2, 2]], dtype=torch.int8),
                              torch.tensor([[5, 9, 5, 6]]))
    flags = torch.tensor([[True, True, False, False]])
    st, ic, changed = delivery.merge_inbox(
        status, inc, inbox, flags, suppress=torch.ones((1, 4), dtype=bool))
    assert st.tolist() == [[2, 2, 2, 2]] and ic.tolist() == [[5, 5, 5, 6]]
    assert changed.tolist() == [[False, False, False, True]]
    st, _, _ = delivery.merge_inbox(status, inc, inbox, flags,
                                    suppress=torch.zeros((1, 4), dtype=bool))
    assert st.tolist()[0][:2] == [0, 0]


@pytest.mark.parametrize("fmt", sorted(delivery.WIRE_FORMATS))
def test_suppressed_gate_matches_reference(fmt):
    f = delivery.WIRE_FORMATS[fmt]
    rng = np.random.default_rng(11)
    shape = (64, 16)
    status = rng.integers(0, 4, shape).astype(np.int8)
    inc = rng.integers(0, 6, shape).astype(np.int32)
    win = delivery.pack_record(torch.from_numpy(rng.integers(0, 4, shape)),
                               torch.from_numpy(inc + rng.integers(-1, 2,
                                                                   shape)
                                                .clip(0)), fmt=f)
    win = torch.where(torch.from_numpy(rng.random(shape) < 0.15), -1, win)
    flags = rng.random(shape) < 0.5
    suppress = (status == 2) & (rng.random(shape) < 0.5)
    got = delivery.merge_inbox(torch.from_numpy(status),
                               torch.from_numpy(inc), win,
                               torch.from_numpy(flags), fmt=f,
                               suppress=torch.from_numpy(suppress))
    want = jdelivery.merge_inbox(
        jnp.asarray(status), jnp.asarray(inc), jnp.asarray(win.numpy()),
        jnp.asarray(flags), fmt=jdelivery.WIRE_FORMATS[fmt],
        suppress=jnp.asarray(suppress))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------------------
# Whole runs
# --------------------------------------------------------------------------


def _jparams(overrides):
    return jswim.SwimParams.from_config(
        fast_config(), n_members=N, sync_interval=8, **overrides)


def _jworld(params):
    """The mid-suspicion heal: one split phase of SPLIT rounds (shorter
    than the quiesce bound), then healed."""
    world = jswim.SwimWorld.healthy(params)
    part = np.zeros((8, N), np.int8)
    part[0, :N // 2] = 1
    return world.with_partition_schedule(part, SPLIT)


@functools.lru_cache(maxsize=None)
def _programs():
    """The reference's ``run`` over STEP rounds for every case."""
    compiling = {}
    with ThreadPoolExecutor(3) as pool:
        for name, (overrides, _) in RUNS.items():
            params = _jparams(overrides)
            world = _jworld(params)
            compiling[name] = pool.submit(jswim.run.lower(
                jax.random.key(1), params, world, STEP,
                state=jswim.initial_state(params, world),
                start_round=0).compile)
        return {name: job.result() for name, job in compiling.items()}


def _run_both(case):
    """The case's run on both sides in steps of STEP rounds, compared
    after every step; returns the port's params, world and its states
    at every step's cursor."""
    overrides, rounds = RUNS[case]
    jparams = _jparams(overrides)
    jworld = _jworld(jparams)
    params, world = port_params(jparams), port_world(jworld)
    draws = jax_draws(jax.random.key(1), jparams)
    program = _programs()[case]
    jstate = jswim.initial_state(jparams, jworld)
    state = swim.initial_state(params, world, device="cpu")
    states = {0: state}
    for start in range(0, rounds, STEP):
        jstate, jmetrics = program(jax.random.key(1), jworld, state=jstate,
                                   start_round=start)
        state, metrics = swim.run(0, params, world, STEP, state=state,
                                  start_round=start, draws=draws,
                                  device="cpu")
        assert_state_equal(jstate, state)
        assert_metrics_equal(jmetrics, metrics)
        states[start + STEP] = state
    return params, world, states


@pytest.mark.parametrize("supp,terminates", [(0, False), (64, True)])
def test_mid_suspicion_heal_matches_reference(supp, terminates):
    """The reference's headline pin, bit-exact to the round: settle
    through the heal and the window, then two segments of 60 rounds."""
    params, world, states = _run_both(f"heal-supp{supp}")
    r = SPLIT + supp + 40
    inc0, inc1, inc2 = (int(states[c].self_inc.sum())
                        for c in (r, r + 60, r + 120))
    div = int(sync.divergence_probe(states[r + 120], params, world, r + 120))
    if terminates:
        assert inc1 == inc0 and inc2 == inc1, (inc0, inc1, inc2)
        assert div == 0
        # Windows were armed and lie within the window's length.
        dl, _ = swim._wide_timer_fields(states[SPLIT + 16], params,
                                        SPLIT + 16)
        held = dl[(states[SPLIT + 16].status == records.DEAD)
                  & (dl != swim.INT32_MAX)]
        assert held.numel() > 0 and int(held.max()) <= SPLIT + 16 + supp
    else:
        assert inc1 > inc0 and inc2 > inc1, (inc0, inc1, inc2)
        assert div > 0


@pytest.mark.parametrize("case", ["shift", "k_block-compact"])
def test_window_in_the_other_tick_bodies(case):
    params, world, states = _run_both(case)
    last = max(states)
    assert int(sync.divergence_probe(states[last], params, world, last)) == 0
