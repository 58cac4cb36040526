"""The port's K-tiled full-view round (``k_block``) against the JAX
package, whole runs in the wide layout (a crash with a revive, a leave, a
link block, a partition; the port's unblocked round equal to each), and
``node_snapshot`` of a blocked run's final state.  The cases and the
reference's programs are ``tests/test_torch_blocked.py``'s.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu_torch.models import swim  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    one_torch_thread, port_params, port_world)
from tests import test_torch_blocked as blocked  # noqa: E402
from tests.test_torch_blocked import (  # noqa: E402,F401
    ROUNDS, _case, _reference_program, quick_reference_compiles)

pytestmark = pytest.mark.torchport


@pytest.mark.parametrize("case", blocked.RUN_FILES[0])
def test_blocked_run_matches_reference(case):
    blocked.check_run(case)


@pytest.mark.parametrize("layout", ["wide", "compact"])
def test_node_snapshot_matches_reference(layout):
    """``node_snapshot`` of the blocked run's final state equals the
    reference's digest of its own final state, key for key, for the
    revived node, a node that watched it and the blocked sender."""
    case = f"crash_revive-{layout}"
    jparams, jworld, draws = _case(case)
    jstate, _ = _reference_program(case)(
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
