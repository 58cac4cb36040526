"""The port's open-world plane against the JAX package, whole runs: slot 3
crashed at round 5 and joined by a new identity at round 26, in the
shift, scatter and ``k_block`` bodies and every layout, with delays and
seeds, and the naive arm; every state lane and metric exact after 60
rounds on the reference's draws.  The runs and the reference's programs
are ``tests/test_torch_open_world.py``'s.
"""

import pytest

torch = pytest.importorskip("torch")

from scalecube_cluster_tpu_torch import records  # noqa: E402
from tests.torch_port_helpers import one_torch_thread  # noqa: E402,F401
from tests.test_torch_open_world import (  # noqa: E402,F401
    RUNS, SLOT, _run_both)

pytestmark = pytest.mark.torchport


@pytest.mark.parametrize("name", list(RUNS))
def test_crash_join_run_matches_reference(name):
    """Slot 3 crashed at round 5 and joined by a new identity at round
    26: both sides on the reference's draws, every state lane and metric
    exact after 60 rounds.  Guarded, every live observer has admitted the
    new identity (epoch 1) by then; the naive arm runs without a lane."""
    (jparams, jworld, jstate), (params, world, state) = _run_both(
        name, tuple(RUNS))
    if name == "naive":
        assert state.epoch.shape[1] == 0
        return
    col = SLOT if params.full_view else int(
        world.slot_of_node[SLOT])
    assert bool((state.epoch[:, col] == 1).all())
    if name == "scatter-seeds":
        assert int((state.status[SLOT] == records.ALIVE).sum()) >= 14
