"""The port's composed runner against the JAX package on whole runs:
``run_composed`` with the trace alone equals ``run_traced``, knob
overrides run as the reference's, and ``models/fd.run`` (gossip and
SYNC silenced) equals the reference's, from a planted state too.  The
runs and the reference's programs are ``tests/test_torch_trace.py``'s.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scalecube_cluster_tpu.models import fd as jfd  # noqa: E402
from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu_torch import interop  # noqa: E402
from scalecube_cluster_tpu_torch.models import compose, fd, swim  # noqa: E402
from scalecube_cluster_tpu_torch.telemetry import trace  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    assert_metrics_equal, assert_state_equal, one_torch_thread, port_params,
    port_world)
from tests.test_torch_trace import (  # noqa: E402,F401
    CRASH, FD_ROUNDS, ROUNDS, _args, _draws, _fd_crash, _fd_planted,
    _reference, _traced_both)

pytestmark = pytest.mark.torchport


def test_run_composed_trace_only_equals_run_traced():
    """``run_composed`` with the trace alone is ``run_traced``; the
    reference's default stack without a monitor spec raises its
    ``ValueError``, and so does the provenance plane without its knob;
    with the knob on it runs beside the trace, which stays
    ``run_traced``'s."""
    _, (params, world, state, tel) = _traced_both("traced:shift-wide")
    draws = _draws("traced:shift-wide")
    final, results, _ = compose.run_composed(
        0, params, world, ROUNDS, with_metrics=False, with_monitor=False,
        draws=draws, device="cpu")
    assert set(results) == {"trace"}
    assert torch.equal(final.status, state.status)
    assert trace.decode_events(results["trace"]) == trace.decode_events(tel)
    with pytest.raises(ValueError, match="monitor_spec"):
        compose.run_composed(0, params, world, 2, device="cpu")
    with pytest.raises(ValueError, match="provenance=True"):
        compose.run_composed(0, params, world, 2, with_metrics=False,
                             with_monitor=False, with_provenance=True,
                             device="cpu")
    armed, results, _ = compose.run_composed(
        0, dataclasses.replace(params, provenance=True), world, ROUNDS,
        with_metrics=False, with_monitor=False, with_provenance=True,
        draws=draws, device="cpu")
    assert list(results) == ["trace", "provenance"]
    assert torch.equal(armed.status, state.status)
    assert trace.decode_events(results["trace"]) == trace.decode_events(tel)
    assert int(results["provenance"].count) > 0
    none = compose.build_stack(False, False, False)
    assert none == ()


def test_knob_runs_match_reference():
    """``run(knobs=...)`` equals the reference's with the same knobs:
    float32-inexact ``loss_probability`` and ``ping_timeout_ms`` through
    a delayed run with Lifeguard on (the chain budgets compare summed
    delays), and a ``suspicion_rounds`` past 32,765 under the compact
    carry (stored as no timer, so nothing turns DEAD)."""
    cases = (("traced:scatter-int16_wire-delayed",
              dict(loss_probability=0.1, ping_timeout_ms=133.3)),
             ("traced:shift-compact-join", dict(suspicion_rounds=40_000)))
    for name, over in cases:
        _, jparams, jworld, rounds, _, _, _ = _args(name)
        jstate, _, jmetrics = _reference(
            name, jswim.Knobs.for_params(jparams, **over))
        params = port_params(jparams)
        state, metrics = swim.run(
            0, params, port_world(jworld), rounds, draws=_draws(name),
            knobs=swim.Knobs.for_params(params, **over), device="cpu")
        assert_state_equal(jstate, state)
        assert_metrics_equal(jmetrics, metrics)
        if "suspicion_rounds" in over:
            assert int(metrics["suspect"].sum()) > 0
            assert int(metrics["dead"][:, CRASH].sum()) == 0


def test_fd_run_matches_reference():
    """``fd.run`` (gossip and SYNC silenced) equals the reference's on
    tests/test_fd_model.py's crash scenario (scatter, shortened) and its
    planted suspicion (no leak to another observer)."""
    jparams, jworld = _fd_crash()
    jstate, jmetrics = _reference("fd:", jfd.fd_only_knobs(jparams))
    state, metrics = fd.run(0, port_params(jparams), port_world(jworld),
                            FD_ROUNDS, draws=_draws("fd:"), device="cpu")
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, metrics)
    assert int(metrics["suspect"][:, 0].max()) > 0
    assert int(metrics["messages_gossip"].sum()) == 0
    assert fd.fd_only_knobs(port_params(jparams)) == dataclasses.replace(
        swim.Knobs.from_params(port_params(jparams)), sync_every=0,
        fanout=0)

    jparams, jworld, jplanted, jknobs = _fd_planted()
    planted = interop.state_from_arrays(
        {f.name: np.asarray(getattr(jplanted, f.name))
         for f in dataclasses.fields(jplanted)}, device="cpu")
    jstate, jmetrics = _reference("fd:", jknobs, world=jworld,
                                  state=jplanted)
    params = port_params(jparams)
    knobs = dataclasses.replace(fd.fd_only_knobs(params), ping_every=0,
                                suspicion_rounds=2**30)
    state, metrics = swim.run(0, params, port_world(jworld), FD_ROUNDS,
                              state=planted, draws=_draws("fd:"),
                              knobs=knobs, device="cpu")
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, metrics)
    assert int(metrics["suspect"][:, 0].max()) == 1
