"""The port's per-sender wire counters (``SwimParams.link_counters``:
``sent_by_node`` / ``lost_by_node`` [N] a round) against the JAX
package's, in both delivery modes.

One whole run a mode, full view 32 x 32 from a seeded cold start (seeds
0 and 1: the joiner <-> seed exchange), loss 0.1, a 50 ms mean delay
into a three-slot delay ring, node 5 crashed over rounds 6-20, node 2
blocked to everyone over rounds 4-12 and a two-phase partition, 30
rounds with the reference's own draws: every metric (the counters
included) and every state lane must be equal.  The two programs compile
at XLA's default optimizations (the delay sums are FMAs there), in two
threads.  Then the reference file's deterministic checks
(``tests/test_link_counters.py``) on the port's own draws: the
steady-state schedule and a crashed sender's silence.
"""

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
    assert_metrics_equal, assert_state_equal, jax_draws, one_torch_thread,
    port_params, port_world)

pytestmark = pytest.mark.torchport

N, ROUNDS = 32, 30
MODES = ("scatter", "shift")


def _jparams(delivery):
    return jswim.SwimParams.from_config(
        fast_config(), n_members=N, loss_probability=0.1,
        mean_delay_ms=50.0, max_delay_rounds=2, delivery=delivery,
        link_counters=True)


def _jworld(params):
    split = (np.arange(N) >= N // 2).astype(np.int8)
    return (jswim.SwimWorld.healthy(params).with_seeds([0, 1])
            .with_crash(5, at_round=6, until_round=20)
            .with_block(2, (0, N), from_round=4, until_round=12)
            .with_partition_schedule(np.stack([np.zeros(N, np.int8), split]),
                                     phase_rounds=10))


@functools.lru_cache(maxsize=None)
def _reference_runs():
    """Both modes' reference runs (state, metrics), compiled in two
    threads."""
    def lowered(delivery):
        params = _jparams(delivery)
        world = _jworld(params)
        state = jswim.initial_state(params, world, warm=False)
        return jswim.run.lower(jax.random.key(0), params, world, ROUNDS,
                               state=state, start_round=0), world, state

    jobs = {}
    with ThreadPoolExecutor(2) as pool:
        for delivery in MODES:
            program, world, state = lowered(delivery)
            jobs[delivery] = (pool.submit(program.compile), world, state)
        return {delivery: job.result()(jax.random.key(0), world, state=state,
                                       start_round=0)
                for delivery, (job, world, state) in jobs.items()}


@pytest.mark.parametrize("delivery", MODES)
def test_counters_match_reference(delivery):
    jstate, jmetrics = _reference_runs()[delivery]
    jparams = _jparams(delivery)
    jworld = _jworld(jparams)
    params, world = port_params(jparams), port_world(jworld)
    state, metrics = swim.run(
        0, params, world, ROUNDS,
        state=swim.initial_state(params, world, warm=False, device="cpu"),
        draws=jax_draws(jax.random.key(0), jparams, jworld), device="cpu")
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, metrics)
    sent, lost = metrics["sent_by_node"], metrics["lost_by_node"]
    assert sent.shape == lost.shape == (ROUNDS, N)
    assert int(sent[6:20, 5].sum()) == 0 and int(lost[6:20, 5].sum()) == 0
    assert int(lost[4:12, 2].sum()) > 0          # the block drops its sends
    assert bool((lost <= sent).all())


def _port_counters(delivery, rounds, world_fn=None):
    params = swim.SwimParams.from_config(fast_config(), n_members=16,
                                         delivery=delivery,
                                         link_counters=True)
    world = swim.SwimWorld.healthy(params, device="cpu")
    if world_fn is not None:
        world = world_fn(world)
    _, m = swim.run(0, params, world, rounds, device="cpu")
    return params, m["sent_by_node"].numpy(), m["lost_by_node"].numpy()


@pytest.mark.parametrize("delivery", MODES)
def test_steady_state_schedule(delivery):
    """Warm lossless steady state: each live node sends exactly 1 PING per
    fd round and 1 SYNC per sync round, and loses nothing."""
    rounds = 24
    params, sent, lost = _port_counters(delivery, rounds)
    r = np.arange(rounds)
    expect = ((r % params.ping_every == 0).astype(int)
              + (r % params.sync_every == 0).astype(int))
    np.testing.assert_array_equal(sent, expect[:, None] * np.ones(16, int))
    assert lost.sum() == 0


@pytest.mark.parametrize("delivery", MODES)
def test_crashed_sender_sends_nothing(delivery):
    _, sent, lost = _port_counters(
        delivery, 30, lambda w: w.with_crash(5, at_round=8, until_round=20))
    assert sent[8:20, 5].sum() == 0
    assert sent[:8, 5].sum() > 0 and sent[20:, 5].sum() > 0
    assert lost[8:20, 5].sum() == 0
