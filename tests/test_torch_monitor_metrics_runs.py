"""The port's health-metrics registry and invariant monitor against the
JAX package: ``run_metered`` in two resumed chunks (shift wide with the
SYNC plane; scatter compact + ``wire24`` with Lifeguard and the open
world), and ``check_round`` directly on a direct regression, a DEAD
winner, saturated cells and both self lanes, a code no longer fresh, and
overflow one row below, at and past capacity.  The settings and the
reference's programs are ``tests/test_torch_monitor_metrics.py``'s.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from scalecube_cluster_tpu_torch.chaos import monitor  # noqa: E402
from scalecube_cluster_tpu_torch.models import swim  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    assert_monitor_equal, one_torch_thread, port_monitor_spec, port_params,
    port_world)
from tests.test_torch_monitor_metrics import (  # noqa: E402,F401
    CAPACITY, CHECK_CASES, METERED, MONITORED, SPEC, _check_inputs, _copy,
    _knobs, _metered_both, _monitor_spec, _port_state, _program, _world)

pytestmark = pytest.mark.torchport


@pytest.mark.parametrize("name", sorted(METERED))
def test_run_metered_matches_reference(name):
    """State, metrics, counters, gauges and histograms equal the
    reference's after each chunk (the second resumes the registry); the
    registry saw what its scenario was built for."""
    rows, _ = _metered_both(name)
    total = {k: rows[0]["counters"][k] + rows[1]["counters"][k]
             for k in SPEC.counters}
    assert total["suspicions_started"] > 0
    assert total["live_observer_rounds"] > 0
    hist = rows[0]["histograms"]["suspicion_lifetime_rounds"]["counts"]
    assert sum(hist) + sum(rows[1]["histograms"][
        "suspicion_lifetime_rounds"]["counts"]) > 0
    if "lifeguard" in name:
        assert rows[1]["gauges"]["lhm"] >= 1.0
        assert total["joins_admitted"] == 1
    else:
        assert rows[1]["gauges"]["lhm"] == 0.0


@pytest.mark.parametrize("case", CHECK_CASES)
def test_check_round_matches_reference(case):
    """``check_round`` on synthetic rounds: a direct regression (and its
    legal DEAD twin), a code no longer fresh (counted, not recorded),
    saturated and negative cells with both self lanes, and a record one
    row below, at and past the capacity."""
    prev, new, jmon0 = _check_inputs(case)
    jworld, kn = _world(MONITORED), _knobs(MONITORED)
    jspec = _monitor_spec(MONITORED)
    jmon = _program("check_round")(_copy(jmon0), jspec, kn, jnp.int32(7),
                                      prev, new, jworld)
    mon = monitor.check_round(
        monitor.MonitorState.from_arrays(jmon0.to_arrays(), device="cpu"),
        port_monitor_spec(jspec), port_params(MONITORED),
        swim.Knobs.from_params(port_params(MONITORED)), 7,
        _port_state(prev), _port_state(new), port_world(jworld))
    assert_monitor_equal(jmon, mon)
    reg = int(mon.code_counts[monitor.InvariantCode.INC_REGRESSION])
    if case == "regression":
        assert [(e.round, e.observer, e.subject, e.detail)
                for e in monitor.decode_violations(mon)] == [(7, 2, 5, 1)]
    elif case == "dead_winner":
        assert int(mon.code_counts.sum()) == 0
    elif case == "not_fresh":
        assert reg == 4 and int(mon.count) == 0
    elif case == "saturated":
        codes = {(e.code.name, e.observer, e.subject)
                 for e in monitor.decode_violations(mon)}
        assert {("WIRE_SATURATION", 1, 6), ("WIRE_SATURATION", 9, 2),
                ("INC_REGRESSION", 5, 5), ("WIRE_SATURATION", 11, 11)} \
            <= codes
    else:
        extra = int(case.split(":")[1])
        assert int(mon.count) == min(CAPACITY, CAPACITY + extra)
        assert int(mon.dropped) == max(0, extra)
