"""The port's SYNC anti-entropy plane against the JAX package, whole runs:
the quiesced heal in the shift, scatter and ``k_block`` bodies (wide and
compact), and the focal heal converging only with the plane.  The cases
and the reference's programs are ``tests/test_torch_sync_plane.py``'s.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu.models import sync as jsync  # noqa: E402
from scalecube_cluster_tpu_torch.models import swim  # noqa: E402
from scalecube_cluster_tpu_torch.models import sync  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    assert_metrics_equal, assert_state_equal, jax_draws, one_torch_thread,
    port_params, port_world)
from tests.test_torch_sync_plane import (  # noqa: E402,F401
    FOCAL_K, FOCAL_N, FOCAL_ROUNDS, FOCAL_SPLIT, HEAL, HEAL_CASES, SEGMENT,
    SPLIT, _draws, _heal_params, _heal_programs, _split_world,
    quick_reference_compiles)

pytestmark = pytest.mark.torchport


@pytest.mark.parametrize("case", sorted(HEAL_CASES))
def test_quiesced_heal_matches_reference(case):
    """The quiesced heal with the plane on, segment by segment: states,
    metrics and the divergence probe equal at every cursor, and the
    healed table converges with no incarnation burnt."""
    jparams = _heal_params(HEAL_CASES[case])
    jworld = _split_world(jparams, SPLIT)
    params, world = port_params(jparams), port_world(jworld)
    program = _heal_programs()[case]
    draws = _draws(jparams.delivery)
    jstate = jswim.initial_state(jparams, jworld)
    state = swim.initial_state(params, world, device="cpu")
    probes = []
    for start in range(0, SPLIT + HEAL, SEGMENT):
        jstate, jmetrics = program(jax.random.key(1), jworld, state=jstate,
                                   start_round=start)
        state, metrics = swim.run(0, params, world, SEGMENT, state=state,
                                  start_round=start, draws=draws,
                                  device="cpu")
        assert_state_equal(jstate, state)
        assert_metrics_equal(jmetrics, metrics)
        cursor = start + SEGMENT
        got = sync.divergence_probe(state, params, world, cursor)
        assert got.dtype == torch.int32 and got.dim() == 0
        assert int(got) == int(jsync.divergence_probe(jstate, jparams,
                                                      jworld, cursor))
        probes.append(int(got))
    assert max(probes[:SPLIT // SEGMENT]) > 0
    assert probes[-1] == 0
    assert bool((state.status == 0).all()) and int(state.self_inc.max()) == 0
    assert int(metrics["messages_anti_entropy"].sum()) > 0


def test_focal_heal_converges_only_with_plane():
    """The focal heal (64 x 8, subjects at ``arange(8) * 8``), the plane
    on against the reference, round by round; the gossip-only control
    (the same world and draws) stays divergent."""
    subject_ids = jnp.arange(FOCAL_K, dtype=jnp.int32) * (FOCAL_N // FOCAL_K)
    runs = {}
    for interval in (8, 0):
        jparams = _heal_params(dict(delivery="shift"), n=FOCAL_N, k=FOCAL_K,
                               sync_interval=interval)
        jworld = _split_world(jparams, FOCAL_SPLIT, subject_ids)
        params, world = port_params(jparams), port_world(jworld)
        state, metrics = swim.run(
            0, params, world, FOCAL_ROUNDS, device="cpu",
            draws=jax_draws(jax.random.key(5), jparams))
        runs[interval] = int(sync.divergence_probe(state, params, world,
                                                   FOCAL_ROUNDS))
        if interval:
            jstate, jmetrics = jswim.run(jax.random.key(5), jparams, jworld,
                                         FOCAL_ROUNDS)
            assert_state_equal(jstate, state)
            assert_metrics_equal(jmetrics, metrics)
            assert runs[interval] == int(jsync.divergence_probe(
                jstate, jparams, jworld, FOCAL_ROUNDS))
    assert runs[8] == 0 and runs[0] > 0
