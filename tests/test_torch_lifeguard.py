"""The port's Lifeguard health plane (``models/lifeguard.py``,
``models/fd.py``, ``SwimParams.lhm_max``) against the JAX package.

``swim_math.ceil_log2_tensor``, the LHA Suspicion schedule, the LHA
Probe budgets and gate and the multiplier's transition on seeded inputs;
then whole runs with ``lhm_max=8`` under loss, both sides on the
reference's own draws (``jax_draws`` rebuilds the gate's uniforms from
the reference's fold), every state lane (``lhm`` among them) and stacked
metric compared exactly: shift and scatter, focal and full view; the
buddy push with ``sync_every=0``; a ``k_block`` run; and the network
configuration (link rules, delays, the ring, user gossips) with all
three planes on, where the per-row budgets meet the delay sums
(``_fma32``) and the anti-entropy exchange bypasses the ring.  The plane
on in a healthy world gives the plane-off run, as the reference pins
(``tests/test_lifeguard.py:91-117``), and the draws with the planes off
are the earlier stream's, pinned to recorded values.

Cost: seven reference programs compiled with most XLA optimizations off
(three at a time), and the network program at XLA's default options
(its delay sum is an FMA there).
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scalecube_cluster_tpu import swim_math as jswim_math  # noqa: E402
from scalecube_cluster_tpu.models import fd as jfd  # noqa: E402
from scalecube_cluster_tpu.models import lifeguard as jlifeguard  # noqa: E402
from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu_torch import swim_math  # noqa: E402
from scalecube_cluster_tpu_torch.config import ClusterConfig  # noqa: E402
from scalecube_cluster_tpu_torch.models import fd  # noqa: E402
from scalecube_cluster_tpu_torch.models import lifeguard  # noqa: E402
from scalecube_cluster_tpu_torch.models import swim  # noqa: E402
from scalecube_cluster_tpu_torch.ops import prng  # noqa: E402
from tests.test_swim_model import fast_config  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    STATE_FIELDS, assert_metrics_equal, assert_state_equal, jax_draws,
    one_torch_thread, port_params, port_world)

pytestmark = pytest.mark.torchport

ROUNDS, LHM_MAX = 60, 8
# name -> params overrides (loss 0.15: probes fail, multipliers climb).
RUNS = {
    "shift-full_view": dict(delivery="shift"),
    "shift-focal": dict(delivery="shift", n_subjects=8),
    "scatter-full_view": dict(delivery="scatter"),
    "scatter-focal": dict(delivery="scatter", n_subjects=8),
    "shift-buddy": dict(delivery="shift", sync_every=0),
    "scatter-buddy": dict(delivery="scatter", sync_every=0),
    "k_block-compact": dict(delivery="shift", k_block=8, compact_carry=True),
}


@pytest.fixture(autouse=True, scope="module")
def quick_reference_compiles():
    previous = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", previous)


# --------------------------------------------------------------------------
# The plane's functions
# --------------------------------------------------------------------------


def test_ceil_log2_tensor_matches_reference():
    powers = [1 << b for b in range(31)]
    values = np.unique(np.clip(np.array(
        list(range(5000)) + [p + d for p in powers for d in (-1, 0, 1)]
        + [2**31 - 1], np.int64), 0, 2**31 - 1)).astype(np.int32)
    got = swim_math.ceil_log2_tensor(torch.from_numpy(values))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jswim_math.ceil_log2_jnp(jnp.asarray(values))))
    assert int(swim_math.ceil_log2_tensor(torch.tensor(1000))) == 10


@pytest.mark.parametrize("seed", [0, 1])
def test_schedule_budgets_gate_and_update_match_reference(seed):
    rng = np.random.default_rng(seed)
    n = 200
    jparams = jswim.SwimParams.from_config(fast_config(), n_members=n,
                                           delivery="shift", lhm_max=LHM_MAX)
    params = port_params(jparams)
    lhm = rng.integers(1, LHM_MAX + 1, n).astype(np.int32)
    t_lhm = torch.from_numpy(lhm)
    for base in (1, 36, 500):
        for n_live in (0, 1, 3, 17, 100, 199, 200):
            got = lifeguard.suspicion_deadline_rounds(
                base, t_lhm, torch.tensor(n_live, dtype=torch.int32), n)
            want = jlifeguard.suspicion_deadline_rounds(
                jnp.int32(base), jnp.asarray(lhm), jnp.int32(n_live), n)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for timeout in (None, 37.5, 0.0):
        got = fd.effective_probe_budgets(params, t_lhm, timeout)
        want = jfd.effective_probe_budgets(
            jparams, jnp.asarray(lhm),
            None if timeout is None else jnp.float32(timeout))
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    key = jax.random.key(seed)
    u = jax.random.uniform(jax.random.fold_in(key, 0x11F6), (n,))
    np.testing.assert_array_equal(
        lifeguard.probe_gate(torch.from_numpy(np.array(u)), t_lhm).numpy(),
        np.asarray(jlifeguard.probe_gate(key, jnp.asarray(lhm), n)))
    fail, clean, refuted, alive = (rng.random((4, n)) < 0.4)
    for cap in (1, 3, LHM_MAX):
        got = lifeguard.update(t_lhm, *(torch.from_numpy(x) for x in
                                        (fail, clean, refuted, alive)), cap)
        want = jlifeguard.update(jnp.asarray(lhm), jnp.asarray(fail),
                                 jnp.asarray(clean), jnp.asarray(refuted),
                                 jnp.asarray(alive), cap)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert lifeguard.initial_lhm(params, "cpu").tolist() == [1] * n
    assert lifeguard.lha_probe_setup(port_params(jswim.SwimParams.from_config(
        fast_config(), n_members=n, delivery="shift")), t_lhm, None,
        50.0) == (None, None, None)


# --------------------------------------------------------------------------
# Whole runs
# --------------------------------------------------------------------------


def _jparams(overrides):
    overrides = dict(overrides)
    n_subjects = overrides.pop("n_subjects", None)
    return jswim.SwimParams.from_config(
        fast_config(), n_members=24 if n_subjects is None else 48,
        n_subjects=n_subjects, loss_probability=0.15, lhm_max=LHM_MAX,
        **overrides)


def _jworld(params):
    return jswim.SwimWorld.healthy(params).with_crash(3, at_round=4)


@functools.lru_cache(maxsize=None)
def _programs():
    compiling = {}
    with ThreadPoolExecutor(3) as pool:
        for name, overrides in RUNS.items():
            params = _jparams(overrides)
            world = _jworld(params)
            compiling[name] = pool.submit(jswim.run.lower(
                jax.random.key(2), params, world, ROUNDS,
                state=jswim.initial_state(params, world),
                start_round=0).compile)
        return {name: job.result() for name, job in compiling.items()}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_run_matches_reference(case):
    jparams = _jparams(RUNS[case])
    jworld = _jworld(jparams)
    jstate, jmetrics = _programs()[case](
        jax.random.key(2), jworld, state=jswim.initial_state(jparams, jworld),
        start_round=0)
    state, metrics = swim.run(0, port_params(jparams), port_world(jworld),
                              ROUNDS, device="cpu",
                              draws=jax_draws(jax.random.key(2), jparams))
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, metrics)
    # The multipliers moved, within their bounds.
    assert int(state.lhm.max()) > 1 and int(state.lhm.min()) >= 1
    assert int(state.lhm.max()) <= LHM_MAX
    if "buddy" in case:
        # sync_every=0: only the buddy push lets a suspected member
        # refute.
        assert int(metrics["refutations"].sum()) > 0


def test_network_run_with_all_planes_matches_reference():
    """The network configuration with the three planes on: link rules (a
    brownout window and a blocked sender), a 40 ms mean delay, a 4-slot
    ring, user gossips, link counters, a partition healed by the
    anti-entropy exchange.  Compiled at XLA's default options."""
    jax.config.update("jax_disable_most_optimizations", False)
    n = 32
    jparams = jswim.SwimParams.from_config(
        fast_config(), n_members=n, delivery="shift", mean_delay_ms=40.0,
        max_delay_rounds=3, loss_probability=0.05, n_user_gossips=2,
        link_counters=True, sync_every=0, sync_interval=6, lhm_max=LHM_MAX,
        dead_suppress_rounds=40)
    part = np.zeros((4, n), np.int8)
    part[0, :n // 2] = 1
    jworld = (jswim.SwimWorld.healthy(jparams)
              .with_partition_schedule(part, 48)
              .with_link_fault((0, 8), (8, n), 0.4, delay_ms=300.0,
                               from_round=10, until_round=40)
              .with_block(9, (0, n), 20, 30).with_crash(3, at_round=5)
              .with_spread(0, 7, 3).with_spread(1, 20, 30))
    rounds = 80
    jstate, jmetrics = jswim.run(jax.random.key(4), jparams, jworld, rounds)
    state, metrics = swim.run(
        0, port_params(jparams), port_world(jworld), rounds, device="cpu",
        draws=jax_draws(jax.random.key(4), jparams, jworld))
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, metrics)
    assert int(metrics["messages_anti_entropy"].sum()) > 0
    assert int(state.lhm.max()) > 1


@pytest.mark.parametrize("delivery", ["shift", "scatter"])
def test_plane_on_in_a_healthy_world_is_plane_off(delivery):
    """Every multiplier stays 1: the gate always passes and the budgets
    and deadlines are the base ones, so the plane-on run (the port's own
    draws) gives the plane-off run's lanes and metrics."""
    off = swim.SwimParams.from_config(fast_config(), n_members=48,
                                      n_subjects=8, delivery=delivery)
    on = swim.SwimParams(**{**off.__dict__, "lhm_max": LHM_MAX})
    world = swim.SwimWorld.healthy(off, device="cpu")
    s_off, m_off = swim.run(3, off, world, 30, device="cpu")
    s_on, m_on = swim.run(3, on, world, 30, device="cpu")
    for name in STATE_FIELDS:
        if name != "lhm":
            assert torch.equal(getattr(s_off, name), getattr(s_on, name))
    assert s_off.lhm.numel() == 0 and bool((s_on.lhm == 1).all())
    assert set(m_on) == set(m_off)
    for name, value in m_off.items():
        assert torch.equal(value, m_on[name]), name


# One round of ``TorchDraws(3, "cpu", params)(11)`` at 64 x 8 (LAN
# defaults, loss 0.05), recorded before the planes' draws existed: the
# shifts, the first three values and the float64 sum of each field.
PINNED = {
    "shift": dict(
        shifts=(34, 38, 38, 39, 35, 63, 23, 61),
        u_direct=([0.728165864944458, 0.9075391292572021,
                   0.9361950755119324], 31.69012486934662),
        u_proxy=([0.08507108688354492, 0.8464990258216858,
                  0.7495593428611755], 88.44876980781555),
        drop_u=([0.09206843376159668, 0.9223840832710266,
                 0.49977588653564453], 131.39267826080322),
        u_refute=([0.7059881091117859, 0.18228459358215332,
                   0.2445756196975708], 30.495177090168)),
    "scatter": dict(
        proxies=([33, 37, 37], 6397.0),
        gossip_t=([51, 35, 3], 5688.0),
        gossip_drop_u=([0.6466845870018005, 0.31675195693969727,
                        0.29623985290527344], 99.14120322465897),
        sync_t=([23, 1, 62], 2092.0),
        sync_drop_u=([0.025697946548461914, 0.4376349449157715,
                      0.3457412123680115], 31.548596382141113),
        ping_t=([29, 15, 1], 2030.0),
        u_direct=([0.6085699200630188, 0.8105458617210388,
                   0.9745106101036072], 35.84050703048706),
        proxy_u=([0.21536785364151, 0.018458962440490723,
                  0.03629547357559204], 92.11843007802963)),
}


@pytest.mark.parametrize("delivery", sorted(PINNED))
def test_draws_with_planes_off_keep_the_earlier_stream(delivery):
    """The planes' draws come after every other draw of the round: with
    them off the stream is the recorded one, and with them on every
    earlier field is unchanged."""
    params = swim.SwimParams.from_config(
        ClusterConfig.default(), n_members=64, n_subjects=8,
        delivery=delivery, loss_probability=0.05)
    on = swim.SwimParams(**{**params.__dict__, "sync_interval": 8,
                            "lhm_max": LHM_MAX, "dead_suppress_rounds": 8})
    off_draws = prng.TorchDraws(3, "cpu", params)(11)
    on_draws = prng.TorchDraws(3, "cpu", on)(11)
    for name, pinned in PINNED[delivery].items():
        value = getattr(off_draws, name)
        if name == "shifts":
            assert value == pinned and on_draws.shifts == pinned
            continue
        head, total = pinned
        flat = value.reshape(-1)[:3]
        assert (flat.tolist() == head and float(value.double().sum()) == total
                ), name
        assert torch.equal(getattr(on_draws, name), value), name
    assert off_draws.ae_offset is None and off_draws.lhm_gate_u is None
    assert on_draws.lhm_gate_u.shape == (64,)
    assert tuple(on_draws.ae_drop_u.shape) == ((2, 64) if delivery == "shift"
                                               else (64, 2))
