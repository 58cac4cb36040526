"""The port's open-world plane against the JAX package: the churn storm at
n = 24 through ``run_monitored`` in the guard and naive arms (the join
codes and deadlines), JOIN_COMPLETENESS tripping before a join is
known, and ``node_snapshot``'s ``record_epochs`` after three whole runs.
The worlds and the reference's programs are
``tests/test_torch_open_world.py``'s.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu_torch.chaos import monitor  # noqa: E402
from scalecube_cluster_tpu_torch.models import swim  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    assert_metrics_equal, assert_monitor_equal, assert_state_equal, jax_draws,
    one_torch_thread, port_monitor_spec, port_params, port_world)
from tests.test_torch_open_world import (  # noqa: E402,F401
    INT32_MAX, ROUNDS, SLOT, SNAPSHOT_RUNS, STORMS, _reference_programs,
    _run_both, _storm)

pytestmark = pytest.mark.torchport


@pytest.mark.parametrize("name", SNAPSHOT_RUNS)
def test_node_snapshot_record_epochs(name):
    """``node_snapshot`` of the joiner's and another row equals the
    reference's: ``record_epochs`` with the guard on, none without."""
    (jparams, jworld, jstate), (params, world, state) = _run_both(
        name, SNAPSHOT_RUNS)
    for node in (0, SLOT):
        want = jswim.node_snapshot(jstate, jparams, jworld, node,
                                   round_idx=ROUNDS)
        got = swim.node_snapshot(state, params, world, node,
                                 round_idx=ROUNDS)
        assert got == want
        assert ("record_epochs" in got) == (name != "naive")


@pytest.mark.parametrize("guard", [True, False])
def test_join_codes_match_reference_monitor(guard):
    """The churn storm at n = 24 (scares, three crash waves, nine joins
    mid-suspicion) in both arms: the port's ``run_monitored`` equals the
    reference's (state, metrics, every monitor lane, count, dropped, code
    counts and first rounds, the verdict), and the join deadlines follow
    the reference's rule.  The guard holds both join codes at zero; the
    naive arm resurrects."""
    scen, jparams, jworld, spec = _storm(guard)
    jstate, mon, jmetrics = _reference_programs(STORMS)[("storm", guard)](
        jax.random.key(0), jworld, spec)
    params, world = port_params(jparams), port_world(jworld)
    disruptions = [d for d in (op.disruption(scen.n_members, scen.horizon)
                               for op in scen.ops) if d is not None]
    known_by, check = monitor.join_deadlines(
        params, world, disruption_end=max(d[1] for d in disruptions))
    np.testing.assert_array_equal(known_by.numpy(),
                                  np.asarray(spec.join_known_by))
    assert check == spec.check_joins
    draws = jax_draws(jax.random.key(0), jparams, jworld)
    state, port_mon, metrics = monitor.run_monitored(
        0, params, world, port_monitor_spec(spec), scen.horizon,
        draws=draws, device="cpu")
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, metrics)
    assert_monitor_equal(mon, port_mon)
    codes = monitor.verdict(port_mon)["codes"]
    totals = {name: codes[name]["violations"]
              for name in ("NO_RESURRECTION", "JOIN_COMPLETENESS")}
    if guard:
        assert set(totals.values()) == {0}
    else:
        assert totals["NO_RESURRECTION"] > 0


def test_join_completeness_trips_before_a_join_is_known():
    """The guard arm's storm under a spec whose join deadlines fall one
    round after each join: eligible observers cannot know a joiner yet,
    so JOIN_COMPLETENESS trips, and the port's ``run_monitored`` (the
    same reference program, the spec being data) equals the reference's
    monitor field for field."""
    scen, jparams, jworld, spec = _storm(True)
    join_at = np.asarray(jworld.join_at)[np.asarray(jworld.subject_ids)]
    early = np.where(join_at < INT32_MAX, join_at + 1, INT32_MAX)
    spec = dataclasses.replace(spec,
                               join_known_by=jnp.asarray(early, jnp.int32))
    jstate, mon, jmetrics = _reference_programs(STORMS)[("storm", True)](
        jax.random.key(0), jworld, spec)
    params, world = port_params(jparams), port_world(jworld)
    state, port_mon, metrics = monitor.run_monitored(
        0, params, world, port_monitor_spec(spec), scen.horizon,
        draws=jax_draws(jax.random.key(0), jparams, jworld), device="cpu")
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, metrics)
    assert_monitor_equal(mon, port_mon)
    code = monitor.InvariantCode.JOIN_COMPLETENESS
    assert int(port_mon.code_counts[code]) > 0
    assert {v.code for v in monitor.decode_violations(port_mon)} >= {code}
