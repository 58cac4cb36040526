"""The port's batched runner (``models/compose.composed_batch_scan``) and
the ``shift_key`` of ``run`` against the JAX package.

- ``composed_batch_scan`` with the trace, monitor and metrics planes at
  N = 16, B = 3 rows of different worlds, knobs and specs (one row
  weakened and red, one lossy), on the reference's draws: every state
  lane, metric, trace lane, monitor field and registry value equal to
  the reference's ``composed_batch_scan``;
- B = 1 equals ``composed_scan``; each row equals its serial run (the
  provenance plane folding row by row too); a batch resumed halfway
  equals an unbroken one;
- ``run(..., shift_key=)`` equals the reference's on the reference's
  draws (the shifts and the anti-entropy offset from the shift key), and
  the port's own draws take only those from the shift seed;
- ``batch_shard_unsupported_reason`` is the reference's text.

Cost: two reference programs at N = 16, compiled in threads at XLA's
backend optimizations off (no delay sums).
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scalecube_cluster_tpu.chaos import monitor as jmonitor  # noqa: E402
from scalecube_cluster_tpu.models import compose as jcompose  # noqa: E402
from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu.telemetry import metrics as jmetrics  # noqa: E402
from scalecube_cluster_tpu.telemetry import trace as jtrace  # noqa: E402
from scalecube_cluster_tpu_torch.chaos import monitor  # noqa: E402
from scalecube_cluster_tpu_torch.models import compose, swim  # noqa: E402
from scalecube_cluster_tpu_torch.ops import prng  # noqa: E402
from scalecube_cluster_tpu_torch.telemetry import metrics  # noqa: E402
from scalecube_cluster_tpu_torch.telemetry import trace  # noqa: E402
from tests.test_swim_model import fast_config  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    assert_metrics_equal, assert_monitor_equal, assert_registry_equal,
    assert_state_equal, jax_draws, one_torch_thread, port_monitor_spec,
    port_params, port_world)

pytestmark = pytest.mark.torchport

QUICK = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}
INT32_MAX = 2**31 - 1
N, ROUNDS, B = 16, 48, 3
TRACE_CAP, MON_CAP = 64, 16
SPEC = jmetrics.MetricsSpec.default()
PARAMS = jswim.SwimParams.from_config(fast_config(), n_members=N,
                                      delivery="shift", sync_interval=8)
# Row b: node CRASHED[b] crashed at round 5 + b; its knob overrides.
CRASHED = (3, 7, 11)
KNOBS = (dict(), dict(suspicion_rounds=1 << 20), dict(loss_probability=0.25))
SHIFT_KEY = 99


def _world(params, b):
    world = jswim.SwimWorld.healthy(params).with_crash(CRASHED[b], 5 + b)
    return world.with_partition_schedule(np.zeros((2, N), np.int8), 10)


def _knobs(params, b):
    kn = jswim.Knobs.from_params(params)
    return dataclasses.replace(kn, **{k: jnp.asarray(v, getattr(kn, k).dtype)
                                      for k, v in KNOBS[b].items()})


def _spec(b):
    """Row b's spec: a pristine network promised, node CRASHED[b]
    removed 40 rounds after its crash (the weakened row cannot keep
    it)."""
    cb = np.full((N,), INT32_MAX, np.int32)
    cb[CRASHED[b]] = 45 + b
    return jmonitor.MonitorSpec(complete_by=jnp.asarray(cb),
                                check_false_suspicion=True)


def _stack(*rows):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *rows)


def _row(tree, i):
    return jax.tree.map(lambda x: x[i], tree)


def _reference_planes(specs):
    return (jtrace.TracePlane(capacity=TRACE_CAP),
            jmonitor.MonitorPlane(specs, capacity=MON_CAP),
            jmetrics.MetricsPlane(SPEC, chaos_from="monitor"))


def _port_planes(specs):
    return (trace.TracePlane(capacity=TRACE_CAP),
            monitor.MonitorPlane(specs, capacity=MON_CAP),
            metrics.MetricsPlane(SPEC, chaos_from="monitor"))


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's batched stack over the three rows and its
    ``run`` with a shift key, compiled in threads."""
    keys = jnp.stack([jax.random.key(10 + b) for b in range(B)])
    worlds = _stack(*[_world(PARAMS, b) for b in range(B)])
    knobs = _stack(*[_knobs(PARAMS, b) for b in range(B)])
    specs = _stack(*[_spec(b) for b in range(B)])

    @jax.jit
    def batched(keys, worlds, knobs, specs):
        return jcompose.composed_batch_scan(
            keys, PARAMS, worlds, ROUNDS, planes=_reference_planes(specs),
            knobs=knobs)

    world0 = _world(PARAMS, 0)
    with ThreadPoolExecutor(2) as pool:
        jobs = dict(
            batched=pool.submit(batched.lower(keys, worlds, knobs, specs)
                                .compile, compiler_options=QUICK),
            run=pool.submit(jswim.run.lower(
                jax.random.key(0), PARAMS, world0, ROUNDS,
                shift_key=jax.random.key(SHIFT_KEY)).compile,
                compiler_options=QUICK))
        draws = [jax_draws(jax.random.key(10 + b), PARAMS,
                           _world(PARAMS, b)) for b in range(B)]
        draws[0](0)
        programs = {name: job.result() for name, job in jobs.items()}
    batch_out = programs["batched"](keys, worlds, knobs, specs)
    run_out = programs["run"](jax.random.key(0), world0,
                              shift_key=jax.random.key(SHIFT_KEY))
    return batch_out, run_out, draws


def _port_rows():
    params = port_params(PARAMS)
    worlds = [port_world(_world(PARAMS, b)) for b in range(B)]
    knobs = [swim.Knobs.for_params(params, **KNOBS[b]) for b in range(B)]
    specs = [port_monitor_spec(_spec(b)) for b in range(B)]
    return params, worlds, knobs, specs


def _assert_telemetry_equal(want, got):
    for name, w, g in (("lanes", want.trace.lanes, got.trace.lanes),
                       ("count", want.trace.count, got.trace.count),
                       ("dropped", want.trace.dropped, got.trace.dropped),
                       ("first_suspect", want.first_suspect,
                        got.first_suspect),
                       ("first_removed", want.first_removed,
                        got.first_removed)):
        np.testing.assert_array_equal(g.cpu().numpy(), np.asarray(w),
                                      err_msg=name)


def test_batch_scan_matches_reference():
    """Three rows of different worlds, knobs and specs through the
    trace, monitor and metrics planes: every output equals the
    reference's batched scan, row by row; the first row green, the
    weakened one red with COMPLETENESS, the lossy one with
    FALSE_SUSPICION."""
    (jstates, jres, jm), _, draws = _reference()
    params, worlds, knobs, specs = _port_rows()
    states, res, m = compose.composed_batch_scan(
        [10 + b for b in range(B)], params, worlds, ROUNDS,
        planes=_port_planes(specs), knobs=knobs, draws=draws, device="cpu")
    assert list(res) == ["trace", "monitor", "metrics"]
    assert_metrics_equal(jm, m)
    greens = []
    for b in range(B):
        assert_state_equal(_row(jstates, b), compose.row_of(states, b))
        _assert_telemetry_equal(_row(jres["trace"], b),
                                compose.row_of(res["trace"], b))
        row_mon = compose.row_of(res["monitor"], b)
        assert_monitor_equal(_row(jres["monitor"], b), row_mon)
        assert_registry_equal(_row(jres["metrics"], b),
                              compose.row_of(res["metrics"], b))
        greens.append(monitor.verdict(row_mon)["green"])
    assert greens == [True, False, False]


def _own_rows(params, n_rows=B):
    worlds = [swim.SwimWorld.healthy(params, device="cpu").with_crash(
        CRASHED[b], 5 + b) for b in range(n_rows)]
    knobs = [swim.Knobs.for_params(params, **KNOBS[b])
             for b in range(n_rows)]
    specs = [port_monitor_spec(_spec(b)) for b in range(n_rows)]
    return worlds, knobs, specs


def _stack_equal(got, want):
    """Every tensor of two results of one structure equal."""
    if isinstance(want, torch.Tensor):
        assert torch.equal(got, want)
    elif dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            _stack_equal(getattr(got, f.name), getattr(want, f.name))
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _stack_equal(got[k], want[k])


def test_batch_of_one_equals_composed_scan():
    """B = 1 gives ``composed_scan``'s state, planes and metrics, each
    with a leading 1."""
    params = port_params(PARAMS)
    worlds, knobs, specs = _own_rows(params, 1)
    states, res, m = compose.composed_batch_scan(
        [5], params, worlds, ROUNDS, planes=_port_planes(specs[:1]),
        knobs=knobs, device="cpu")
    state, res1, m1 = compose.composed_scan(
        5, params, worlds[0], ROUNDS, planes=_port_planes(specs[0]),
        knobs=knobs[0], device="cpu")
    _stack_equal(compose.row_of(states, 0), state)
    _stack_equal(compose.row_of(m, 0), m1)
    for name in res1:
        _stack_equal(compose.row_of(res[name], 0), res1[name])


def test_rows_equal_their_serial_runs_with_row_folded_planes():
    """Each row equals its own serial run, with the provenance plane
    (folded row by row) beside the batched trace and monitor."""
    params = port_params(jswim.SwimParams.from_config(
        fast_config(), n_members=N, provenance=True))
    worlds, knobs, specs = _own_rows(params)

    def planes(spec):
        from scalecube_cluster_tpu_torch.models import provenance

        return _port_planes(spec) + (provenance.ProvenancePlane(64),)

    states, res, m = compose.composed_batch_scan(
        [1, 2, 3], params, worlds, ROUNDS, planes=planes(specs),
        knobs=knobs, device="cpu")
    for b in range(B):
        state, res1, m1 = compose.composed_scan(
            1 + b, params, worlds[b], ROUNDS, planes=planes(specs[b]),
            knobs=knobs[b], device="cpu")
        _stack_equal(compose.row_of(states, b), state)
        _stack_equal(compose.row_of(m, b), m1)
        for name in res1:
            _stack_equal(compose.row_of(res[name], b), res1[name])
    assert int(res["provenance"].count.sum()) > 0


def test_resumed_batch_equals_unbroken():
    """A batch run in two halves, the second resuming the first's states,
    trace and monitor, equals one unbroken batch."""
    params = port_params(PARAMS)
    worlds, knobs, specs = _own_rows(params)
    seeds = [4, 5, 6]

    def planes(tel=None, mon=None):
        return (trace.TracePlane(TRACE_CAP, telemetry=tel),
                monitor.MonitorPlane(specs, MON_CAP, monitor=mon))

    whole, res, m = compose.composed_batch_scan(
        seeds, params, worlds, ROUNDS, planes=planes(), knobs=knobs,
        device="cpu")
    half = ROUNDS // 2
    mid, res_a, m_a = compose.composed_batch_scan(
        seeds, params, worlds, half, planes=planes(), knobs=knobs,
        device="cpu")
    end, res_b, m_b = compose.composed_batch_scan(
        seeds, params, worlds, ROUNDS - half,
        planes=planes(res_a["trace"], res_a["monitor"]), states=mid,
        start_round=half, knobs=knobs, device="cpu")
    _stack_equal(end, whole)
    _stack_equal(res_b, res)
    _stack_equal({k: torch.cat([m_a[k], m_b[k]], dim=1) for k in m}, m)


def test_run_with_shift_key_matches_reference():
    """``run`` with a shift key on the reference's draws built with it
    (the shifts and the anti-entropy offset from the shift key) equals
    the reference's ``run(..., shift_key=)``."""
    _, (jstate, jm), _ = _reference()
    draws = jax_draws(jax.random.key(0), PARAMS, _world(PARAMS, 0),
                      shift_key=jax.random.key(SHIFT_KEY))
    state, m = swim.run(0, port_params(PARAMS), port_world(_world(PARAMS, 0)),
                        ROUNDS, draws=draws, device="cpu")
    assert_state_equal(jstate, state)
    assert_metrics_equal(jm, m)


def test_own_draws_take_only_the_shifts_from_the_shift_seed():
    """``TorchDraws(seed, shift_seed=s)`` takes the channel shifts and the
    anti-entropy offset from ``s`` and every other draw from ``seed``;
    ``run(..., shift_key=seed)`` is ``run(...)``; a shift key with draws
    given raises."""
    params = port_params(PARAMS)
    world = swim.SwimWorld.healthy(params, device="cpu")
    own = prng.TorchDraws(5, "cpu", params, world)
    shared = prng.TorchDraws(5, "cpu", params, world, shift_seed=SHIFT_KEY)
    other = prng.TorchDraws(SHIFT_KEY, "cpu", params, world)
    for r in (0, 7):
        a, b, c = own(r), shared(r), other(r)
        assert b.shifts == c.shifts and b.ae_offset == c.ae_offset
        assert b.shifts != a.shifts
        for name in ("drop_u", "u_refute", "u_direct", "ae_drop_u"):
            assert torch.equal(getattr(b, name), getattr(a, name)), name
    s1, m1 = swim.run(5, params, world, 20, device="cpu")
    s2, m2 = swim.run(5, params, world, 20, shift_key=5, device="cpu")
    _stack_equal(s2, s1)
    _stack_equal(m2, m1)
    with pytest.raises(ValueError, match="shift_key"):
        swim.run(5, params, world, 1, draws=own, shift_key=1, device="cpu")


def test_batch_shard_reason_and_argument_checks():
    """The reference's declared reason, word for word; mismatched batch
    lengths raise."""
    params = port_params(PARAMS)
    assert compose.batch_shard_unsupported_reason(params) == \
        jcompose.batch_shard_unsupported_reason(PARAMS)
    world = swim.SwimWorld.healthy(params, device="cpu")
    with pytest.raises(ValueError, match="same B"):
        compose.composed_batch_scan([1, 2], params, [world], 1, device="cpu")
