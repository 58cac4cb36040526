"""The port's network model against the JAX package, whole runs: the
brownout (link rules, delays and the ring) in three layouts, loss-only
rules without the ring, the seeded cold start, and a delayed seeded
checkpoint of the reference resumed by the port.  The configurations
and the reference's programs are ``tests/test_torch_faults.py``'s.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu.utils import checkpoint  # noqa: E402
from scalecube_cluster_tpu_torch import interop  # noqa: E402
from scalecube_cluster_tpu_torch.models import swim  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402
    STATE_FIELDS, assert_metrics_equal, assert_state_equal, one_torch_thread,
    port_params, port_world)
from tests.test_torch_faults import (  # noqa: E402,F401
    CONFIGS, ROUNDS, _jax_run, _port_run)

pytestmark = pytest.mark.torchport


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_network_run_matches_reference(name):
    jparams, jworld, warm = CONFIGS[name]()
    assert_state_equal(
        jswim.initial_state(jparams, jworld, warm=warm),
        swim.initial_state(port_params(jparams), port_world(jworld),
                           warm=warm, device="cpu"))
    jstate, jmetrics = _jax_run(name)
    state, metrics = _port_run(name)
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, metrics)
    # The window holds what the configuration was built for.
    if name.startswith("brownout"):
        assert int((state.inbox_ring >= 0).sum()) > 0
        assert int(metrics["suspect"][:, 3].max()) > 0
        assert int(metrics["user_gossip_infected"][-1].min()) > 8
    if name == "loss_only_rules_no_ring":
        assert state.inbox_ring.shape[0] == 0
        assert int(metrics["suspect"][:, 3].max()) > 0
    if name == "seeded_cold_start":
        assert int(metrics["absent"][0].sum()) > 100
        assert int(metrics["absent"][-1].sum()) == 0


def test_port_resumes_a_delayed_seeded_checkpoint(tmp_path):
    """A JAX seeded cold start with a delay ring and a block,
    checkpointed at round ROUNDS with messages in flight, resumes in the
    port (its ring lanes from the checkpoint, its world carried over)
    and matches JAX's own continuation."""
    name = "seeded_cold_start"
    half, _ = _jax_run(name)
    path = str(tmp_path / "delayed.npz")
    checkpoint.save(path, half, ROUNDS, key=jax.random.key(0),
                    meta={"run": name})
    jparams, _, _ = CONFIGS[name]()
    state, next_round, _, meta = interop.load_jax_checkpoint(
        path, device="cpu", params=port_params(jparams))
    assert (next_round, meta) == (ROUNDS, {"run": name})
    assert state.inbox_ring.shape == (3, 16, 16)
    assert int((state.inbox_ring >= 0).sum()) > 0
    want, want_metrics = _jax_run(name, state=half, start_round=ROUNDS)
    got, metrics = _port_run(name, state=state, start_round=ROUNDS)
    assert_state_equal(want, got)
    assert_metrics_equal(want_metrics, metrics)
    assert set(STATE_FIELDS) == {f.name for f in dataclasses.fields(got)}
