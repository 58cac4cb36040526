"""The port's K-tiled full-view round (``k_block``) against the JAX
package, whole runs under the compact carry (four worlds), the int16
wire, compact + ``wire24`` and aggregate user-gossip metrics (the port's
unblocked round equal to each), and a compact blocked run resumed from
its state.  The cases and the reference's programs are
``tests/test_torch_blocked.py``'s.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu_torch.models import swim  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    assert_metrics_equal, assert_state_equal, one_torch_thread, port_params,
    port_world)
from tests import test_torch_blocked as blocked  # noqa: E402
from tests.test_torch_blocked import (  # noqa: E402,F401
    ROUNDS, _case, _reference_program, quick_reference_compiles)

pytestmark = pytest.mark.torchport


@pytest.mark.parametrize("case", blocked.RUN_FILES[1])
def test_blocked_run_matches_reference(case):
    blocked.check_run(case)


def test_blocked_checkpoint_resume_matches_reference():
    """A compact blocked run stopped at round 17 and resumed from its
    state (the carry never leaves its stored layout) ends where the
    reference's unbroken run does."""
    jparams, jworld, draws = _case("crash_revive-compact")
    jstate, jmetrics = _reference_program("crash_revive-compact")(
        jax.random.key(0), jworld, state=jswim.initial_state(jparams, jworld),
        start_round=0)
    params, world = port_params(jparams), port_world(jworld)
    half, m_a = swim.run(0, params, world, 17, draws=draws, device="cpu")
    state, m_b = swim.run(0, params, world, ROUNDS - 17, state=half,
                          start_round=17, draws=draws, device="cpu")
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, {name: torch.cat([m_a[name], m_b[name]])
                                    for name in m_a})
