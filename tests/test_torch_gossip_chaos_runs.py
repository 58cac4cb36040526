"""The port's gossip-only simulator (``models/gossip.py``) and its chaos
campaign runner (``chaos/campaign.run_scenario``) run against the JAX
package on the CPU, bit for bit.

- ``gossip.run`` on the reference's own draws (``jax_gossip_draws``) at
  N = 64, G = 4, 40 rounds: lossless, loss 0.1, and loss 0.1 with a mean
  delay of one round and a 4-slot ring; every state lane and metric, and
  ``dissemination_rounds``; the reference's state after 20 rounds resumed
  in the port (``interop.gossip_state_from_arrays``) for the other 20;
- ``run_scenario`` at n = 16 on the reference's draws: a pristine
  ``mild`` scenario (a crash and a config push) and a ``severe`` one
  (loss 0.05, a rolling partition, a churn storm, a brownout, a config
  push); verdict, counters and the whole monitor equal to the
  reference's ``run_scenario``;
- the mild scenario under ``weakened_knobs``: red with COMPLETENESS on
  both sides, the monitor equal;
- ``tests/test_gossip_model.py``'s statistical checks on the port's own
  draws (``GossipTorchDraws``).

Cost: five reference programs (three small gossip scans, two monitored
scenario runs), lowered one after another and compiled in the
background; the file holds few test items so that the test runner hands
it out late.
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from scalecube_cluster_tpu import swim_math as jswim_math  # noqa: E402
from scalecube_cluster_tpu.chaos import campaign as jcampaign  # noqa: E402
from scalecube_cluster_tpu.chaos import monitor as jmonitor  # noqa: E402
from scalecube_cluster_tpu.chaos import scenarios as jscenarios  # noqa: E402
from scalecube_cluster_tpu.config import ClusterConfig as JConfig  # noqa: E402
from scalecube_cluster_tpu.models import gossip as jgossip  # noqa: E402
from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu_torch import interop, swim_math  # noqa: E402
from scalecube_cluster_tpu_torch.chaos import campaign, monitor  # noqa: E402
from scalecube_cluster_tpu_torch.chaos import scenarios  # noqa: E402
from scalecube_cluster_tpu_torch.config import ClusterConfig  # noqa: E402
from scalecube_cluster_tpu_torch.models import gossip  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    assert_monitor_equal, jax_draws, jax_gossip_draws, one_torch_thread)

pytestmark = pytest.mark.torchport

QUICK = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}
GOSSIP_N, GOSSIP_G, GOSSIP_ROUNDS, GOSSIP_SEED = 64, 4, 40, 5
# (loss, mean delay ms, ring depth): one mean delay is one gossip round.
GOSSIP_RUNS = {"lossless": (0.0, 0.0, 0), "loss": (0.1, 0.0, 0),
               "delayed": (0.1, 200.0, 3)}
SCENARIOS = {"mild": (5, "mild"), "severe": (1, "severe")}
SCENARIO_N = 16


def _gossip_params(name):
    loss, mean, depth = GOSSIP_RUNS[name]
    return jgossip.GossipSimParams.from_config(
        JConfig.default(), GOSSIP_N, GOSSIP_G, loss, mean, depth)


def _scenario(name):
    seed, severity = SCENARIOS[name]
    scen = jscenarios.generate_scenario(seed, n=SCENARIO_N,
                                        severity=severity)
    params = jcampaign.campaign_params(scen)
    world, spec = scen.build(params)
    return seed, scen, params, world, spec


@functools.lru_cache(maxsize=None)
def _programs():
    """The reference's gossip scans (full, and the first half for the
    resume) and monitored scenario runs, lowered one after another and
    compiled in the background; the draws' programs are built meanwhile.
    The gossip scans keep XLA's default optimizations (the delay bins'
    product and division are compared bit for bit)."""
    key = jax.random.key(GOSSIP_SEED)
    jobs = {}
    with ThreadPoolExecutor(4) as pool:
        for name in GOSSIP_RUNS:
            params = _gossip_params(name)
            for rounds in (GOSSIP_ROUNDS, GOSSIP_ROUNDS // 2):
                jobs[name, rounds] = pool.submit(jgossip.run.lower(
                    key, params, rounds,
                    state=jgossip.initial_state(params)).compile)
        for name in SCENARIOS:
            seed, scen, params, world, spec = _scenario(name)
            jobs[name] = pool.submit(jmonitor.run_monitored.lower(
                jax.random.key(seed), params, world, spec, scen.horizon,
                knobs=jswim.Knobs.from_params(params)).compile,
                compiler_options=QUICK)
        return {name: job.result() for name, job in jobs.items()}


@pytest.mark.parametrize("name", list(GOSSIP_RUNS))
def test_gossip_run_matches_reference(name):
    """Every lane and metric of 40 rounds, ``dissemination_rounds``, and
    the reference's state at round 20 resumed by the port."""
    jparams = _gossip_params(name)
    params = gossip.GossipSimParams(**dataclasses.asdict(jparams))
    assert params == gossip.GossipSimParams.from_config(
        ClusterConfig.default(), GOSSIP_N, GOSSIP_G, *GOSSIP_RUNS[name])
    key = jax.random.key(GOSSIP_SEED)
    programs = _programs()
    jstate, jmetrics = programs[name, GOSSIP_ROUNDS](
        key, state=jgossip.initial_state(jparams))
    draws = jax_gossip_draws(key, jparams, GOSSIP_ROUNDS)
    state, metrics = gossip.run(0, params, GOSSIP_ROUNDS, draws=draws,
                                device="cpu")
    for lane in ("infected", "spread_until", "ring"):
        want = np.asarray(getattr(jstate, lane))
        got = getattr(state, lane).numpy()
        assert got.dtype == want.dtype, lane
        np.testing.assert_array_equal(got, want, err_msg=lane)
    assert set(metrics) == set(jmetrics)
    for metric, value in jmetrics.items():
        assert metrics[metric].dtype == torch.int32
        np.testing.assert_array_equal(metrics[metric].numpy(),
                                      np.asarray(value), err_msg=metric)
    rounds = gossip.dissemination_rounds(metrics, GOSSIP_N)
    np.testing.assert_array_equal(
        rounds.numpy(),
        np.asarray(jgossip.dissemination_rounds(jmetrics, GOSSIP_N)))
    assert (rounds >= 0).all()

    # The reference's half-way state, continued by the port: its ring and
    # spread windows carry over; the rounds run on from 20.
    half = GOSSIP_ROUNDS // 2
    jhalf, _ = programs[name, half](key, state=jgossip.initial_state(jparams))
    resumed = interop.gossip_state_from_arrays(
        {lane: np.asarray(getattr(jhalf, lane))
         for lane in ("infected", "spread_until", "ring")}, device="cpu")
    assert bool(resumed.ring.any()) == (name == "delayed")
    for r in range(half, GOSSIP_ROUNDS):
        resumed, _ = gossip.gossip_tick(resumed, r, draws(r), params)
    for lane, value in interop.gossip_state_to_arrays(resumed).items():
        np.testing.assert_array_equal(value, np.asarray(getattr(jstate, lane)),
                                      err_msg=lane)


def _port_verdict(name, knobs=None):
    seed, scen, jparams, jworld, _ = _scenario(name)
    port_scen = scenarios.generate_scenario(seed, n=SCENARIO_N,
                                            severity=scen.severity)
    assert repr(port_scen) == repr(scen)
    return seed, scen, port_scen, campaign.run_scenario(
        port_scen, seed=seed, knobs=knobs, device="cpu",
        draws=jax_draws(jax.random.key(seed), jparams, jworld))


def _reference_run(name, knobs):
    seed, scen, jparams, jworld, spec = _scenario(name)
    _, jmon, jmetrics = _programs()[name](
        jax.random.key(seed), jworld, spec, knobs=knobs(jparams))
    return jmon, jmetrics


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_run_scenario_matches_reference(name):
    """``run_scenario`` on the reference's draws: the verdict, the
    counters, the repro line and the whole monitor equal the reference's
    ``run_scenario``'s (its monitored run of the scenario's params, world
    and spec)."""
    seed, scen, port_scen, v = _port_verdict(name)
    jmon, jmetrics = _reference_run(name, jswim.Knobs.from_params)
    want = jcampaign.ScenarioVerdict(
        scenario=scen, green=jmonitor.verdict(jmon)["green"],
        verdict=jmonitor.verdict(jmon), seed=seed, delivery="shift",
        counters={k: int(np.asarray(jmetrics[k]).sum())
                  for k in campaign._COUNTER_KEYS if k in jmetrics})
    assert v.verdict == want.verdict
    assert (v.green, v.counters, v.seed, v.delivery) == (
        want.green, want.counters, want.seed, want.delivery)
    assert v.repro() == want.repro() and v.to_json() == want.to_json()
    _, _, jparams, jworld, jspec = _scenario(name)
    params = campaign.campaign_params(port_scen)
    world, spec = port_scen.build(params, device="cpu")
    _, mon, _ = monitor.run_monitored(
        seed, params, world, spec, scen.horizon, device="cpu",
        draws=jax_draws(jax.random.key(seed), jparams, jworld))
    assert_monitor_equal(jmon, mon)
    if name == "mild":
        assert v.green and port_scen.build(
            campaign.campaign_params(port_scen), device="cpu")[1] \
            .check_false_suspicion


def test_weakened_run_is_red_with_completeness():
    """The mild scenario under ``weakened_knobs`` (suspicion timers at
    2^20 rounds): red with COMPLETENESS on both sides, monitors equal."""
    seed, scen, port_scen, v = _port_verdict(
        "mild", lambda p: campaign.weakened_knobs(None, p))
    jmon, _ = _reference_run(
        "mild", lambda p: jcampaign.weakened_knobs(scen, p))
    want = jmonitor.verdict(jmon)
    assert not v.green and v.verdict == want
    assert v.verdict["codes"]["COMPLETENESS"]["violations"] > 0
    assert want["codes"]["COMPLETENESS"]["violations"] > 0


def test_gossip_statistics_on_port_draws():
    """``tests/test_gossip_model.py``'s checks on the port's own draws:
    full dissemination within the sweep window at n in (2, 3, 5, 10,
    50), under 10 % and 25 % loss, the analytic time and convergence
    probability, the message bound, no double delivery, the spread
    stopping after the window, determinism and seed dependence."""
    def make(n, loss=0.0, n_gossips=1):
        return gossip.GossipSimParams.from_config(
            ClusterConfig.default(), n_members=n, n_gossips=n_gossips,
            loss_probability=loss)

    def run(seed, params, rounds):
        return gossip.run(seed, params, rounds, device="cpu")[1]

    for n in (2, 3, 5, 10, 50):
        metrics = run(0, make(n), swim_math.gossip_periods_to_sweep(3, n))
        assert int(gossip.dissemination_rounds(metrics, n)[0]) >= 0, n
    predicted = swim_math.gossip_periods_to_spread(3, 128)
    measured = int(gossip.dissemination_rounds(
        run(1, make(128), 4 * predicted), 128)[0])
    assert 0 < measured <= predicted, (measured, predicted)
    sweep50 = swim_math.gossip_periods_to_sweep(3, 50)
    for loss in (0.10, 0.25):
        rounds = gossip.dissemination_rounds(
            run(2, make(50, loss, 4), sweep50), 50)
        assert (rounds >= 0).all(), (loss, rounds)
    rounds = gossip.dissemination_rounds(
        run(3, make(64, 0.25, 64), swim_math.gossip_periods_to_sweep(3, 64)),
        64)
    predicted = swim_math.gossip_convergence_probability(3, 3, 64, 0.25)
    assert predicted == jswim_math.gossip_convergence_probability(
        3, 3, 64, 0.25)
    assert float((rounds >= 0).float().mean()) >= predicted - 0.05
    total = int(run(4, make(50), sweep50)["messages_sent"].sum())
    assert total <= swim_math.max_messages_per_gossip_total(3, 3, 50)
    newly = run(5, make(32, n_gossips=3),
                swim_math.gossip_periods_to_sweep(3, 32))["newly_infected"]
    assert (newly.sum(dim=0) <= 31).all()
    sweep16 = swim_math.gossip_periods_to_sweep(3, 16)
    sent = run(6, make(16), 3 * sweep16)["messages_sent"][:, 0]
    stopped_at = int(torch.argmax((sent == 0).to(torch.int32)))
    assert sent[-1] == 0 and (sent[stopped_at:] == 0).all()
    a = run(7, make(20, n_gossips=2), 30)["infected_count"]
    assert torch.equal(a, run(7, make(20, n_gossips=2), 30)["infected_count"])
    b, c = (run(seed, make(20, 0.3, 2), 30)["infected_count"]
            for seed in (8, 9))
    assert not torch.equal(b, c)
