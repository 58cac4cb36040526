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


UNPORTED = [
    ("delivery", "scatter"), ("compact_carry", True), ("int16_wire", True),
    ("max_delay_rounds", 2), ("mean_delay_ms", 50.0), ("k_block", 8),
    ("n_user_gossips", 1), ("sync_interval", 8), ("lhm_max", 4),
    ("dead_suppress_rounds", 8), ("open_world", True), ("metadata_keys", 2),
    ("provenance", True), ("link_counters", True),
]


@pytest.mark.parametrize("knob,value", UNPORTED, ids=[k for k, _ in UNPORTED])
def test_unported_knob_raises_naming_it(knob, value):
    overrides = {"delivery": "shift", knob: value}
    with pytest.raises(NotImplementedError, match=knob):
        swim.SwimParams.from_config(fast_config(), n_members=64,
                                    **overrides)


def test_wire24_raises_and_rounds_per_step_is_accepted():
    with pytest.raises(NotImplementedError, match="wire24"):
        swim.SwimParams.from_config(fast_config(), n_members=64,
                                    delivery="shift", wire24=True)
    p1, world = _small()
    p4 = dataclasses.replace(p1, rounds_per_step=4)
    s1, m1 = swim.run(1, p1, world, 12, device="cpu")
    s4, m4 = swim.run(1, p4, world, 12, device="cpu")
    assert torch.equal(s1.status, s4.status)
    assert all(torch.equal(m1[k], m4[k]) for k in m1)


def test_world_rejects_seeds_and_link_faults():
    _, world = _small()
    with pytest.raises(NotImplementedError, match="seed"):
        world.with_seeds([0])
    with pytest.raises(NotImplementedError, match="LinkFaults"):
        world.with_link_fault(0, 1, loss=0.5)
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
