"""The port's metadata KV plane against the JAX package, whole runs: the
config pushes in both delivery modes and every layout (delays and the
open world among them), and ``bench.py --rollout --smoke``'s scenario at
N = 24 in its gated and control arms.  The runs and the reference's
programs are ``tests/test_torch_metadata.py``'s.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu_torch.models import swim  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    assert_metrics_equal, assert_state_equal, jax_draws, one_torch_thread,
    port_params, port_world)
from tests.test_torch_metadata import (  # noqa: E402,F401
    PUSH_FILE, PUSH_RUNS, SMOKE_N, _cells, _probes_match, _reference_programs,
    _run_both, _setup)

pytestmark = pytest.mark.torchport


@pytest.mark.parametrize("run", list(PUSH_RUNS))
def test_pushes_match_reference(run):
    """The push world on both sides, every lane and metric exact: node 3's
    word and node 5's second one (version 2) reach every live observer,
    node 6 (crashed) and node 9 (a key past the plane) write nothing, and
    the crashed row holds nothing; the
    tables agree at the end (delayed runs: 40 rounds, the words still
    spreading)."""
    ref, port, metrics, rounds = _run_both(f"push:{run}")
    state = port[2]
    div = _probes_match(ref, port, rounds)
    assert not bool(state.md[:, 6].any()) and not bool(state.md[:, 9].any())
    assert int(metrics["metadata_divergent"].max()) > 0
    if "delay" in run:
        return
    live = [i for i in range(16) if i != 6]           # node 6 is frozen
    assert [_cells(state, 3)[j][i] for j in (0, 1) for i in live] == \
        [641] * 15 + [1] * 15
    assert [_cells(state, 5, key=1)[j][i] for j in (0, 1) for i in live] \
        == [17] * 15 + [2] * 15
    assert not bool(state.md[6].any())
    assert div == 0 and int(metrics["metadata_divergent"][-1]) == 0


@pytest.mark.parametrize("arm", ["gated", "control"])
def test_bench_smoke_rollout_matches_reference(arm):
    """``bench.py --rollout --smoke``'s scenario (N = 24) on the
    reference's world and draws, run through ``chip_smoke.rollout_gated``
    (the gated arm, polled every 2 rounds) or whole (the control): every
    lane and per-round metric equal to the reference's whole run; the
    gated arm converges every push inside its deadline with no divergent
    cell at the horizon, the control stays divergent.  The world is the
    reference scenario's as ``Scenario.build`` pads it (the per-hop FD
    chains run), and the port's DSL (``chip_smoke.rollout_world``) builds
    the same world and geometry."""
    import chip_smoke

    jparams, jworld, horizon = _setup(f"smoke:{arm}")
    params, world = port_params(jparams), port_world(jworld)
    dsl_world, geo = chip_smoke.rollout_world(SMOKE_N, "cpu", n_stages=2,
                                              stage_size=2)
    assert geo["horizon"] == horizon
    assert jworld.faults.n_rules == dsl_world.faults.n_rules == 8
    for name in swim.LinkFaults.ARRAYS:
        np.testing.assert_array_equal(getattr(dsl_world.faults, name).numpy(),
                                      getattr(world.faults, name).numpy())
    jstate, jmetrics = _reference_programs(PUSH_FILE)[f"smoke:{arm}"](
        jax.random.key(0), jworld, state=jswim.initial_state(jparams, jworld),
        start_round=0)
    draws = jax_draws(jax.random.key(0), jparams, jworld)
    if arm == "gated":
        state, summary = chip_smoke.rollout_gated(params, world, geo, "cpu",
                                                  draws=draws,
                                                  keep_metrics=True)
        metrics = summary["metrics"]
        assert summary["final_div"] == 0
        assert all(at <= p["deadline"] for at, p in
                   zip(summary["converged_at"], geo["pushes"]))
    else:
        state, metrics = swim.run(0, params, world, horizon, draws=draws,
                                  device="cpu")
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, metrics)
    div = _probes_match((jparams, jworld, jstate), (params, world, state),
                        horizon)
    assert (div == 0) == (arm == "gated")
