"""The port's Lifeguard plane against the JAX package, whole runs: seven
configurations of the health plane (both delivery modes, ``k_block``,
the buddy push), and the network configuration with all three tick
planes on.  The runs and the reference's programs are
``tests/test_torch_lifeguard.py``'s.
"""

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
from tests.test_torch_lifeguard import (  # noqa: E402,F401
    LHM_MAX, ROUNDS, RUNS, _jparams, _jworld, _programs,
    quick_reference_compiles)

pytestmark = pytest.mark.torchport


@pytest.mark.parametrize("case", sorted(RUNS))
def test_run_matches_reference(case):
    jparams = _jparams(RUNS[case])
    jworld = _jworld(jparams)
    jstate, jmetrics = _programs()[case](
        jax.random.key(2), jworld, state=jswim.initial_state(jparams, jworld),
        start_round=0)
    state, metrics = swim.run(0, port_params(jparams), port_world(jworld),
                              ROUNDS, device="cpu",
                              draws=jax_draws(jax.random.key(2), jparams))
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, metrics)
    # The multipliers moved, within their bounds.
    assert int(state.lhm.max()) > 1 and int(state.lhm.min()) >= 1
    assert int(state.lhm.max()) <= LHM_MAX
    if "buddy" in case:
        # sync_every=0: only the buddy push lets a suspected member
        # refute.
        assert int(metrics["refutations"].sum()) > 0


def test_network_run_with_all_planes_matches_reference():
    """The network configuration with the three planes on: link rules (a
    brownout window and a blocked sender), a 40 ms mean delay, a 4-slot
    ring, user gossips, link counters, a partition healed by the
    anti-entropy exchange.  Compiled at XLA's default options."""
    jax.config.update("jax_disable_most_optimizations", False)
    n = 32
    jparams = jswim.SwimParams.from_config(
        fast_config(), n_members=n, delivery="shift", mean_delay_ms=40.0,
        max_delay_rounds=3, loss_probability=0.05, n_user_gossips=2,
        link_counters=True, sync_every=0, sync_interval=6, lhm_max=LHM_MAX,
        dead_suppress_rounds=40)
    part = np.zeros((4, n), np.int8)
    part[0, :n // 2] = 1
    jworld = (jswim.SwimWorld.healthy(jparams)
              .with_partition_schedule(part, 48)
              .with_link_fault((0, 8), (8, n), 0.4, delay_ms=300.0,
                               from_round=10, until_round=40)
              .with_block(9, (0, n), 20, 30).with_crash(3, at_round=5)
              .with_spread(0, 7, 3).with_spread(1, 20, 30))
    rounds = 80
    jstate, jmetrics = jswim.run(jax.random.key(4), jparams, jworld, rounds)
    state, metrics = swim.run(
        0, port_params(jparams), port_world(jworld), rounds, device="cpu",
        draws=jax_draws(jax.random.key(4), jparams, jworld))
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, metrics)
    assert int(metrics["messages_anti_entropy"].sum()) > 0
    assert int(state.lhm.max()) > 1
