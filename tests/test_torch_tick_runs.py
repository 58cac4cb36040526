"""The port's SWIM round against the JAX package, whole runs: focal
shape with a crash and a revive, full view with a leave and a partition,
and the bench's shape, every state lane and metric equal on the
reference's draws.  The cases are ``tests/test_torch_tick.py``'s.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu_torch.models import swim  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402
    assert_metrics_equal, assert_state_equal, jax_draws, one_torch_thread,
    port_params, port_world)
from tests.test_torch_tick import (  # noqa: E402,F401
    CASES)

pytestmark = pytest.mark.torchport


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_matches_reference(case):
    jparams, jworld, rounds = CASES[case]()
    key = jax.random.key(0)
    jstate, jmetrics = jswim.run(key, jparams, jworld, rounds)
    state, metrics = swim.run(0, port_params(jparams), port_world(jworld),
                              rounds, draws=jax_draws(key, jparams),
                              device="cpu")
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, metrics)
    if case == "focal_crash_revive":
        # The window really holds both transitions it was built for.
        assert int(metrics["dead"][:, 3].max()) > 0
        assert int(metrics["refutations"].sum()) > 0
    if case == "full_view_leave_partition":
        assert int(metrics["dead"][:, 5].max()) > 0
