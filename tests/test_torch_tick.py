"""The PyTorch port's whole round against the JAX package.

JAX ``swim.run(key, ...)`` and the port's ``run(..., draws=jax_draws(key))``
run the same params and world; every ``SwimState`` field and every
stacked per-round metric must be equal.  Exact equality is the right
tolerance: state and metrics are integers, and the only float
operations (``u < p_chain``, ``drop_u >= loss``) compare identical
float32 draws with float32 probabilities built in the reference's order
(models/swim.py:1684-1687).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from scalecube_cluster_tpu.config import ClusterConfig  # noqa: E402
from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu_torch.models import swim  # noqa: E402
from scalecube_cluster_tpu_torch.ops import prng  # noqa: E402
from tests.test_swim_model import fast_config  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402
    assert_metrics_equal, assert_state_equal, jax_draws, one_torch_thread,
    port_params, port_world)

pytestmark = pytest.mark.torchport


def _focal_crash_revive():
    # SUSPECT -> DEAD (60-round timers) while node 3 is down, then its
    # revival at 80 refutes the hot death notice.
    params = jswim.SwimParams.from_config(
        fast_config(), n_members=512, n_subjects=16, loss_probability=0.05,
        delivery="shift")
    world = jswim.SwimWorld.healthy(params).with_crash(
        3, at_round=5, until_round=80)
    return params, world, 120


def _full_view_leave_partition():
    params = jswim.SwimParams.from_config(
        fast_config(), n_members=96, loss_probability=0.02, delivery="shift")
    split = (np.arange(96) >= 48).astype(np.int8)
    world = (jswim.SwimWorld.healthy(params).with_leave(5, at_round=20)
             .with_partition_schedule(np.stack([split, np.zeros(96, np.int8)]),
                                      phase_rounds=25))
    return params, world, 90


def _bench_shape():
    # bench.py's workload shape at N=2048: LAN defaults, loss 0.02, crash 3@10.
    params = jswim.SwimParams.from_config(
        ClusterConfig.default(), n_members=2048, n_subjects=16,
        loss_probability=0.02, delivery="shift")
    world = jswim.SwimWorld.healthy(params).with_crash(3, at_round=10)
    return params, world, 60


CASES = {
    "focal_crash_revive": _focal_crash_revive,
    "full_view_leave_partition": _full_view_leave_partition,
    "bench_shape": _bench_shape,
}


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


def _small():
    params = swim.SwimParams.from_config(
        fast_config(), n_members=64, n_subjects=8, loss_probability=0.1,
        delivery="shift")
    world = swim.SwimWorld.healthy(params, device="cpu").with_crash(
        2, at_round=3, until_round=40)
    return params, world


def test_resume_redraws_the_same_rounds():
    """TorchDraws is a function of (seed, round): a run split at round 25
    equals the unbroken run, state and metrics."""
    params, world = _small()
    whole, m_whole = swim.run(7, params, world, 50, device="cpu")
    half, m_a = swim.run(7, params, world, 25, device="cpu")
    rest, m_b = swim.run(7, params, world, 25, state=half, start_round=25,
                         device="cpu")
    for name in ("status", "inc", "spread_until", "suspect_deadline",
                 "self_inc"):
        assert torch.equal(getattr(whole, name), getattr(rest, name)), name
    for name, value in m_whole.items():
        assert torch.equal(value, torch.cat([m_a[name], m_b[name]])), name


def test_torch_draws_shapes_and_ranges():
    params, _ = _small()
    d = prng.TorchDraws(3, "cpu", params)(11)
    n, r, f = params.n_members, params.ping_req_members, params.fanout
    assert len(d.shifts) == 1 + r + f + 1
    assert all(1 <= s < n for s in d.shifts)
    assert d.u_direct.shape == (n,) and d.u_proxy.shape == (r, n)
    assert d.drop_u.shape == (n, f + 1) and d.u_refute.shape == (n,)
    for u in (d.u_direct, d.u_proxy, d.drop_u, d.u_refute):
        assert u.dtype == torch.float32
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    again = prng.TorchDraws(3, "cpu", params)(11)
    assert again.shifts == d.shifts and torch.equal(again.drop_u, d.drop_u)
    assert prng.TorchDraws(4, "cpu", params)(11).shifts != d.shifts


# The knob the port refused until its plane was ported (provenance, the
# last one): its case now builds in every tick body.
UNPORTED = [("provenance", True)]
PLANES = [("sync_interval", 8), ("lhm_max", 4), ("dead_suppress_rounds", 8)]


@pytest.mark.parametrize("knob,value", UNPORTED, ids=[k for k, _ in UNPORTED])
def test_unported_knob_raises_naming_it(knob, value):
    """The formerly unported knob builds in shift, scatter and
    ``k_block``, as the reference's does; with a delay ring both raise
    the reference's ``ValueError`` naming it."""
    for overrides in (dict(delivery="shift"), dict(delivery="scatter"),
                      dict(delivery="shift", k_block=16)):
        params = swim.SwimParams.from_config(fast_config(), n_members=64,
                                             **overrides, **{knob: value})
        assert getattr(params, knob) == value
        jparams = jswim.SwimParams.from_config(fast_config(), n_members=64,
                                               **overrides, **{knob: value})
        assert port_params(jparams) == params
    for side in (swim, jswim):
        with pytest.raises(ValueError, match=knob):
            side.SwimParams.from_config(fast_config(), n_members=64,
                                        max_delay_rounds=2, **{knob: value})


UNPORTED_PLANES = [("metrics", dict(with_monitor=False)),
                   ("monitor", dict(with_metrics=False)),
                   ("provenance", dict(with_metrics=False, with_monitor=False,
                                       with_provenance=True))]


@pytest.mark.parametrize("plane,flags", UNPORTED_PLANES,
                         ids=[p for p, _ in UNPORTED_PLANES])
def test_unported_observer_plane_raises_naming_it(plane, flags):
    """The observer planes the port once refused (metrics, monitor, then
    provenance, the last) run a round beside the trace and give their
    slices (the monitor with the reference's passive spec, provenance
    with its knob on, and without it the reference's ``ValueError``
    naming the knob before any round runs)."""
    from scalecube_cluster_tpu_torch.chaos import monitor
    from scalecube_cluster_tpu_torch.models import compose

    params = swim.SwimParams.from_config(fast_config(), n_members=16,
                                         delivery="shift")
    world = swim.SwimWorld.healthy(params, device="cpu")
    if plane == "provenance":
        with pytest.raises(ValueError, match="provenance=True"):
            compose.run_composed(0, params, world, 1, device="cpu", **flags)
        params = dataclasses.replace(params, provenance=True)
    spec = monitor.MonitorSpec.passive(params, device="cpu")
    _, results, _ = compose.run_composed(0, params, world, 1,
                                         monitor_spec=spec, device="cpu",
                                         **flags)
    assert list(results) == ["trace", plane]


# run(..., 0)'s metric families: the default set, then each optional one.
ZERO_ROUND_PARAMS = {
    "default": {}, "aggregate": dict(per_subject_metrics=False),
    "link_counters": dict(link_counters=True),
    "user_gossips": dict(n_user_gossips=2),
    "metadata": dict(metadata_keys=1, sync_interval=4),
}


@pytest.mark.parametrize("traced", [False, True], ids=["run", "run_traced"])
@pytest.mark.parametrize("case", list(ZERO_ROUND_PARAMS))
def test_zero_round_run_returns_every_metric(case, traced):
    """A zero-round ``run`` (and ``run_traced``) gives the reference's
    metric keys, each with a leading 0 and the reference's trailing shape
    and dtype (``ClusterConfig.default_local()`` at N = 8), and the state
    it was given; the trace comes back empty."""
    from scalecube_cluster_tpu.telemetry import trace as jtrace

    jparams = jswim.SwimParams.from_config(
        ClusterConfig.default_local(), n_members=8,
        **ZERO_ROUND_PARAMS[case])
    jworld = jswim.SwimWorld.healthy(jparams)
    key = jax.random.key(0)
    if traced:
        _, jtel, want = jax.eval_shape(
            lambda: jswim.run_traced(key, jparams, jworld, 0,
                                     trace_capacity=16))
    else:
        _, want = jax.eval_shape(lambda: jswim.run(key, jparams, jworld, 0))
    params, world = port_params(jparams), port_world(jworld)
    state = swim.initial_state(params, world, device="cpu")
    if traced:
        final, tel, got = swim.run_traced(0, params, world, 0,
                                          trace_capacity=16, state=state,
                                          device="cpu")
        assert (int(tel.trace.count), int(tel.trace.dropped)) == (0, 0)
        assert tuple(tel.trace.lanes.shape) == tuple(jtel.trace.lanes.shape)
        assert bool((tel.first_suspect == jtrace.INT32_MAX).all())
    else:
        final, got = swim.run(0, params, world, 0, state=state,
                              device="cpu")
    assert list(got) == list(swim.metric_shapes(params))
    assert set(got) == set(want)
    for name, spec in want.items():
        assert tuple(got[name].shape) == tuple(spec.shape), name
        assert got[name].dtype == getattr(torch, str(spec.dtype)), name
    assert torch.equal(final.status, state.status)


# The tick bodies and layouts every ported plane constructs in, with the
# open-world plane's epoch field width in each.
SETTINGS = ((dict(delivery="shift"), 6), (dict(delivery="scatter"), 6),
            (dict(delivery="shift", k_block=16), 6),
            (dict(delivery="shift", int16_wire=True), 2),
            (dict(delivery="shift", compact_carry=True), 2),
            (dict(delivery="shift", compact_carry=True, wire24=True), 4))


@pytest.mark.parametrize("guard", [True, False])
def test_open_world_constructs_in_every_setting(guard):
    """``open_world`` constructs in the six tick/layout settings, with
    the format's epoch field (6 wide, 2 on the int16 wire, 4 under
    wire24) and none under ``epoch_guard=False``, as in the
    reference."""
    for overrides, bits in SETTINGS:
        params = swim.SwimParams.from_config(fast_config(), n_members=64,
                                             open_world=True,
                                             epoch_guard=guard, **overrides)
        want = jswim.SwimParams.from_config(fast_config(), n_members=64,
                                            open_world=True,
                                            epoch_guard=guard, **overrides)
        assert params.open_world
        assert params.epoch_bits == want.epoch_bits == (bits if guard else 0)


# The settings the metadata plane runs beside, each on its own.
METADATA_BESIDE = {"alone": {}, "open_world": dict(open_world=True),
                   "sync_interval": dict(sync_interval=8),
                   "lhm_max": dict(lhm_max=4),
                   "dead_suppress_rounds": dict(dead_suppress_rounds=8),
                   "delays": dict(mean_delay_ms=50.0, max_delay_rounds=2)}


@pytest.mark.parametrize("beside", list(METADATA_BESIDE))
def test_metadata_keys_constructs_in_every_setting(beside):
    """``metadata_keys`` constructs in shift and scatter in the four
    layouts beside each plane, as the reference's does, and ``k_block``
    and focal shapes raise the reference's ``ValueError``."""
    extra = METADATA_BESIDE[beside]
    for overrides, _ in SETTINGS:
        kwargs = dict(overrides, metadata_keys=2, **extra)
        if "k_block" in overrides:
            for params_cls in (swim.SwimParams, jswim.SwimParams):
                with pytest.raises(ValueError, match="k_block"):
                    params_cls.from_config(fast_config(), n_members=64,
                                           **kwargs)
            continue
        params = swim.SwimParams.from_config(fast_config(), n_members=64,
                                             **kwargs)
        want = jswim.SwimParams.from_config(fast_config(), n_members=64,
                                            **kwargs)
        assert params.metadata_keys == 2
        assert dataclasses.asdict(params) == dataclasses.asdict(want)
    with pytest.raises(ValueError, match="full view"):
        swim.SwimParams.from_config(fast_config(), n_members=64,
                                    n_subjects=8, metadata_keys=2, **extra)


@pytest.mark.parametrize("knob,value", PLANES, ids=[k for k, _ in PLANES])
def test_plane_knob_constructs_and_rejects_a_negative_value(knob, value):
    """The three ported planes' knobs construct in every tick body and
    layout, and a negative value raises ``ValueError`` naming the knob,
    as in the reference."""
    for overrides, _ in SETTINGS:
        params = swim.SwimParams.from_config(fast_config(), n_members=64,
                                             **overrides, **{knob: value})
        assert getattr(params, knob) == value
    with pytest.raises(ValueError, match=knob):
        swim.SwimParams.from_config(fast_config(), n_members=64,
                                    delivery="shift", **{knob: -1})


@pytest.mark.parametrize("n_subjects", [None, 8])
def test_default_params_are_scatter_and_construct(n_subjects):
    """Default-argument params (scatter delivery, the reference's default)
    construct in full view and focal, as the reference's do."""
    params = swim.SwimParams.from_config(fast_config(), n_members=64,
                                         n_subjects=n_subjects)
    want = jswim.SwimParams.from_config(fast_config(), n_members=64,
                                        n_subjects=n_subjects)
    assert params.delivery == want.delivery == "scatter"
    assert params.fused_wire and params.ping_known_only == params.full_view
    assert dataclasses.asdict(params) == dataclasses.asdict(want)


@pytest.mark.parametrize("n_subjects,known_only",
                         [(8, True), (None, False)])
def test_ping_known_only_mismatch_is_scatter_only(n_subjects, known_only):
    """``ping_known_only != full_view`` is accepted under scatter and still
    raises under shift, as in the reference."""
    params = swim.SwimParams.from_config(
        fast_config(), n_members=64, n_subjects=n_subjects,
        ping_known_only=known_only)
    assert params.ping_known_only == known_only != params.full_view
    with pytest.raises(ValueError, match="ping_known_only == full_view"):
        swim.SwimParams.from_config(
            fast_config(), n_members=64, n_subjects=n_subjects,
            ping_known_only=known_only, delivery="shift")


def test_wire24_raises_and_rounds_per_step_is_accepted():
    # wire24 is the compact carry's rung: without compact_carry it raises,
    # as in the reference.
    with pytest.raises(ValueError, match="wire24"):
        swim.SwimParams.from_config(fast_config(), n_members=64,
                                    delivery="shift", wire24=True)
    p1, world = _small()
    p4 = dataclasses.replace(p1, rounds_per_step=4)
    s1, m1 = swim.run(1, p1, world, 12, device="cpu")
    s4, m4 = swim.run(1, p4, world, 12, device="cpu")
    assert torch.equal(s1.status, s4.status)
    assert all(torch.equal(m1[k], m4[k]) for k in m1)


def test_world_rejects_seeds_and_link_faults():
    """Seeds and link-fault rules are accepted now: each lands in the
    world as the reference stores it; out-of-range seeds and bad rules
    still raise."""
    _, world = _small()
    seeded = world.with_seeds([0, 5])
    assert seeded.seed_ids.tolist() == [0, 5]
    assert seeded.seed_ids.dtype == torch.int32
    with pytest.raises(ValueError, match="with_seeds"):
        world.with_seeds([64])
    faulty = world.with_link_fault(0, 1, loss=0.5).with_block((2, 4), 7, 3, 9)
    assert faulty.faults.n_rules == 2 and world.faults.n_rules == 0
    assert faulty.faults.loss.tolist() == [0.5, 1.0]
    assert faulty.faults.src_hi.tolist() == [1, 4]
    assert faulty.faults.until_round.tolist() == [2**31 - 1, 9]
    with pytest.raises(ValueError, match="probability"):
        world.with_link_fault(0, 1, loss=1.5)
    with pytest.raises(ValueError, match="distinct"):
        dataclasses.replace(world, subject_ids=torch.tensor(
            [0, 0, 1, 2, 3, 4, 5, 6], dtype=torch.int32))


@pytest.mark.parametrize("warm", [True, False])
@pytest.mark.parametrize("k", [8, None])
def test_initial_state_matches_reference(warm, k):
    jparams = jswim.SwimParams.from_config(
        fast_config(), n_members=40, n_subjects=k, delivery="shift")
    jworld = jswim.SwimWorld.healthy(
        jparams, subject_ids=None if k is None else
        jax.numpy.asarray([5, 0, 39, 7, 12, 3, 30, 21], jax.numpy.int32))
    assert_state_equal(
        jswim.initial_state(jparams, jworld, warm=warm),
        swim.initial_state(port_params(jparams), port_world(jworld),
                           warm=warm, device="cpu"))


def test_aggregate_metrics_are_the_per_subject_sums():
    """per_subject_metrics=False reports each [K] column metric summed,
    from the same run."""
    params, world = _small()
    agg = dataclasses.replace(params, per_subject_metrics=False)
    _, per = swim.run(2, params, world, 30, device="cpu")
    _, tot = swim.run(2, agg, world, 30, device="cpu")
    assert set(per) == set(tot)
    for name, value in per.items():
        want = value.sum(dim=1, dtype=torch.int32) if value.dim() == 2 \
            else value
        assert tot[name].dtype == torch.int32
        assert torch.equal(tot[name], want), name
