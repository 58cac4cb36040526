"""The port's chaos DSL (``chaos/scenarios.py``), its campaign runner's
host side (``chaos/campaign.py``) and the analytic model
(``swim_math.py``) against the JAX package, on the host alone: no
reference program is compiled.

- ``Scenario.build``: the world (every schedule, the link-fault rules
  with their match-nothing padding) and the ``MonitorSpec`` equal the
  reference's for the 21 scenarios of ``bench.py --chaos``'s campaign
  (``generate_campaign(100, 21, 32)``), one scenario a severity at
  n = 16, the first tier of ``generate_fuzz_campaign``, the named
  scenarios (``asymmetric_degradation``, the alarm and blame drills,
  ``churn_growth_scenario``, ``quiesced_heal_scenario``) and ``bench.py
  --rollout``'s scenario at 24, 48 and 16,384 members; the generators
  give equal scenarios (pure in their arguments);
- the bounds, ``campaign_params``, ``StagedRollout``'s gate and rollback,
  the generators' ``ValueError``s, ``repro()``, ``to_json`` and
  ``summary``, the unported entry points' ``NotImplementedError``;
- every ``swim_math`` function equal to the reference's;
- a port campaign's journal (a one-scenario ``run_campaign`` on the CPU)
  read by the reference's ``telemetry.sink.read_records``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scalecube_cluster_tpu import swim_math as jswim_math  # noqa: E402
from scalecube_cluster_tpu.chaos import campaign as jcampaign  # noqa: E402
from scalecube_cluster_tpu.chaos import scenarios as jscenarios  # noqa: E402
from scalecube_cluster_tpu.telemetry import sink as jsink  # noqa: E402
from scalecube_cluster_tpu_torch import chaos, swim_math  # noqa: E402
from scalecube_cluster_tpu_torch.chaos import campaign  # noqa: E402
from scalecube_cluster_tpu_torch.chaos import scenarios  # noqa: E402
from scalecube_cluster_tpu_torch.models import swim  # noqa: E402
from scalecube_cluster_tpu_torch.telemetry import sink  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    one_torch_thread, port_params)
from tests.torch_rollout_reference import reference_rollout  # noqa: E402

pytestmark = pytest.mark.torchport

CAMPAIGN = jscenarios.generate_campaign(100, 21, 32)


def assert_world_equal(jworld, world):
    """Every field of a port world equals the reference world's, dtypes
    included (the link-fault rules and their padding too)."""
    for f in dataclasses.fields(jworld):
        want, got = getattr(jworld, f.name), getattr(world, f.name)
        if f.name == "faults":
            for name in swim.LinkFaults.ARRAYS:
                a = np.asarray(getattr(want, name))
                b = getattr(got, name).numpy()
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(b, a, err_msg=name)
        elif isinstance(got, torch.Tensor):
            a = np.asarray(want)
            assert a.dtype == got.numpy().dtype, f.name
            np.testing.assert_array_equal(got.numpy(), a, err_msg=f.name)
        else:
            assert got == int(np.asarray(want)), f.name


def assert_spec_equal(jspec, spec):
    for name in ("complete_by", "join_known_by"):
        a = np.asarray(getattr(jspec, name))
        b = getattr(spec, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert spec.agree_from == int(jspec.agree_from)
    for name in ("check_agreement", "check_false_suspicion", "check_joins"):
        assert getattr(spec, name) == getattr(jspec, name), name


def built_both(jscen, scen, jparams=None, params=None, **overrides):
    """Both sides' ``(params, world, spec)`` of one scenario (the campaign
    params unless given), compared."""
    assert repr(scen) == repr(jscen)
    if jparams is None:
        jparams = jcampaign.campaign_params(jscen, **overrides)
        params = campaign.campaign_params(scen, **overrides)
    assert dataclasses.asdict(params) == dataclasses.asdict(jparams)
    jworld, jspec = jscen.build(jparams)
    world, spec = scen.build(params, device="cpu")
    assert_world_equal(jworld, world)
    assert_spec_equal(jspec, spec)
    assert world.faults.n_rules % 8 == 0 and world.faults.n_rules >= 8
    return params, world, spec


@pytest.mark.parametrize("i", range(len(CAMPAIGN)))
def test_campaign_scenario_builds_as_the_reference(i):
    """``bench.py --chaos``'s campaign, scenario by scenario."""
    scen = scenarios.generate_campaign(100, 21, 32)[i]
    built_both(CAMPAIGN[i], scen)


@pytest.mark.parametrize("severity", scenarios.SEVERITIES)
def test_severity_at_sixteen_builds_as_the_reference(severity):
    built_both(jscenarios.generate_scenario(7, 16, severity),
               scenarios.generate_scenario(7, 16, severity))


def test_fuzz_campaign_first_tier_builds_as_the_reference():
    """``generate_fuzz_campaign(100, 4, 32)`` is ``generate_campaign(100,
    12, 32)`` on both sides; its first tier (the mild rows) builds as the
    reference's."""
    jfuzz = jscenarios.generate_fuzz_campaign(100, 4, n=32)
    fuzz = scenarios.generate_fuzz_campaign(100, 4, n=32)
    assert repr(fuzz) == repr(jfuzz)
    assert repr(fuzz) == repr(scenarios.generate_campaign(100, 12, 32))
    for jscen, scen in zip(jfuzz, fuzz):
        if scen.severity == scenarios.SEVERITIES[0]:
            built_both(jscen, scen)


def _named(name):
    """The named scenarios, reference and port, with the params the
    benches build them under (None: the campaign's)."""
    if name == "lifeguard":
        args = (11, 48)
        return (jscenarios.asymmetric_degradation(*args),
                scenarios.asymmetric_degradation(*args), None)
    if name == "alarm_drill":
        return (jscenarios.alarm_drill_scenario(3, 32),
                scenarios.alarm_drill_scenario(3, 32), None)
    if name == "blame_drill":
        return (jscenarios.blame_drill_scenario(7, 48),
                scenarios.blame_drill_scenario(7, 48),
                dict(delivery="scatter", ping_known_only=False,
                     ping_req_members=0, ping_every=1, sync_interval=8,
                     provenance=True))
    if name == "churn_growth":
        return (jscenarios.churn_growth_scenario(3, 48),
                scenarios.churn_growth_scenario(3, 48), None)
    if name == "quiesced_heal":
        jp = jcampaign.campaign_params(
            jscenarios.Scenario("x", 32, 1, ()), sync_interval=8)
        return (jscenarios.quiesced_heal_scenario(jp, 32),
                scenarios.quiesced_heal_scenario(port_params(jp), 32),
                dict(sync_interval=8))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["lifeguard", "alarm_drill", "blame_drill",
                                  "churn_growth", "quiesced_heal"])
def test_named_scenario_builds_as_the_reference(name):
    jscen, scen, overrides = _named(name)
    _, world, spec = built_both(jscen, scen, **(overrides or {}))
    if name == "churn_growth":
        assert spec.check_joins and (world.join_at < swim.INT32_MAX).sum() > 0
    if name == "quiesced_heal":
        assert spec.check_agreement


def rollout_scenario(n, n_stages=3, stage_size=4, sync_interval=8):
    """``bench.py --rollout``'s scenario built with the port's DSL, as
    ``chip_smoke.rollout_world`` builds it."""
    import chip_smoke

    return chip_smoke.rollout_scenario(n, n_stages=n_stages,
                                       stage_size=stage_size,
                                       sync_interval=sync_interval)


@pytest.mark.parametrize("n", [24, 48, 16_384])
def test_rollout_scenario_builds_as_the_reference(n):
    """The staged rollout (a revive storm, a quiesced split, three stages
    of four owners; at 24 the smoke's two of two) built by the port's
    DSL equals the reference bench's, padding rules included, so its
    draws take the per-hop FD chains as the reference's do."""
    stages = (2, 2) if n == 24 else (3, 4)
    jscen, jparams, jworld, jrollout, heal_at, bound = reference_rollout(
        n, *stages)
    scen, params, world, spec, rollout = rollout_scenario(n, *stages)
    assert repr(scen) == repr(jscen) and rollout == scen.ops[2]
    assert dataclasses.asdict(params) == dataclasses.asdict(jparams)
    assert_world_equal(jworld, world)
    assert_spec_equal(jscen.build(jparams)[1], spec)
    assert world.faults.n_rules == 8
    assert (bound, heal_at) == (
        scenarios.metadata_convergence_bound(params, n),
        2 * scen.ops[1].phase_rounds)
    assert rollout.push_schedule() == jrollout.push_schedule()
    assert rollout.rollback_ops(1, 900) == tuple(
        scenarios.ConfigPush(**dataclasses.asdict(op))
        for op in jrollout.rollback_ops(1, 900))
    rollout.validate_gate(params, n)
    late = dataclasses.replace(rollout, stage_every=bound - 1)
    with pytest.raises(ValueError, match="convergence bound"):
        late.validate_gate(params, n)


def test_bounds_and_params_equal_the_reference():
    for n, overrides in ((16, {}), (32, dict(sync_interval=8)),
                         (48, dict(ping_every=1, sync_every=0))):
        jscen = jscenarios.Scenario("b", n, 64, ())
        jp = jcampaign.campaign_params(jscen, **overrides)
        p = campaign.campaign_params(scenarios.Scenario("b", n, 64, ()),
                                     **overrides)
        assert dataclasses.asdict(p) == dataclasses.asdict(jp)
        for name in ("quiesce_bound", "post_heal_agreement_bound",
                     "metadata_convergence_bound", "completeness_bound"):
            assert getattr(scenarios, name)(p, n) == getattr(
                jscenarios, name)(jp, n), name
        assert scenarios.asymmetric_degraded_range(n) == \
            jscenarios.asymmetric_degraded_range(n)
    assert campaign.campaign_config() == campaign.ClusterConfig(
        **dataclasses.asdict(jcampaign.campaign_config()))
    assert chaos.completeness_bound is scenarios.completeness_bound


def test_generators_and_ops_raise_as_the_reference():
    cases = [
        lambda m: m.generate_scenario(1, 8),
        lambda m: m.generate_scenario(1, 32, "apocalyptic"),
        lambda m: m.asymmetric_degradation(1, 8),
        lambda m: m.alarm_drill_scenario(1, 8),
        lambda m: m.alarm_drill_scenario(1, 32, pulse_rounds=0),
        lambda m: m.blame_drill_scenario(1, 8),
        lambda m: m.blame_drill_scenario(1, 32, victim=3, observer=3),
        lambda m: m.churn_growth_scenario(1, 8),
        lambda m: m.churn_growth_scenario(1, 32, join_wave_size=2),
        lambda m: m.ChurnStorm((1, 2, 3), 2, 0, 4),
        lambda m: m.ChurnStorm((1, 2), 2, 0, 4, down_rounds=5,
                               join_wave_size=1),
        lambda m: m.ChurnStorm((1, 2), 2, 0, 4, join_wave_size=3,
                               arrivals=(5,)),
        lambda m: m.FlappingLink(1, 2, 0, 0, 3, 3),
        lambda m: m.Brownout((0, 8), (8, 16), 0.5, 0, 0, 4),
        lambda m: m.Brownout((0, 8), (8, 16), 0.5, 0, 4, 4,
                             peak_delay_ms=-1.0),
        lambda m: m.RollingPartition(5, 16, 1),
        lambda m: m.StagedRollout((1, 2, 3), 2, 0, 1, 0, 16),
        lambda m: m.StagedRollout((1, 1), 2, 0, 1, 0, 16),
        lambda m: m.StagedRollout((1, 2), 2, 0, 1, 0, 0),
    ]
    for case in cases:
        with pytest.raises(ValueError) as want:
            case(jscenarios)
        with pytest.raises(ValueError) as got:
            case(scenarios)
        assert str(got.value) == str(want.value)
    jscen = jscenarios.generate_scenario(4, 16, "mild")
    jp = jcampaign.campaign_params(jscen)
    with pytest.raises(ValueError) as want:
        jscen.build(dataclasses.replace(jp, n_members=24, n_subjects=24))
    scen = scenarios.generate_scenario(4, 16, "mild")
    with pytest.raises(ValueError) as got:
        scen.build(dataclasses.replace(campaign.campaign_params(scen),
                                       n_members=24, n_subjects=24),
                   device="cpu")
    assert str(got.value) == str(want.value)


def test_verdict_repro_json_and_summary_equal_the_reference():
    """A verdict's ``repro()`` and ``to_json``, a campaign's ``summary``
    and a minimized repro line, built from the same digests, equal the
    reference's; the line names only what ``chaos`` exports."""
    digests = [
        {"green": True, "codes": {"COMPLETENESS": {"violations": 0,
                                                   "first_round": None}}},
        {"green": False, "codes": {"COMPLETENESS": {"violations": 3,
                                                    "first_round": 90}}}]
    ours, theirs = [], []
    for i, d in enumerate(digests):
        for mod, scen_mod, out in ((campaign, scenarios, ours),
                                   (jcampaign, jscenarios, theirs)):
            out.append(mod.ScenarioVerdict(
                scenario=scen_mod.generate_scenario(100 + i, 32, "severe"),
                green=d["green"], verdict=d, seed=100 + i, delivery="shift",
                counters={"refutations": i}))
    for v, w in zip(ours, theirs):
        assert v.repro() == w.repro() and v.to_json() == w.to_json()
    assert campaign.CampaignResult(ours, "p").summary() == \
        jcampaign.CampaignResult(theirs, "p").summary()
    hand = [m.Scenario("h", 16, 64,
                       (m.Crash(3, 4), m.LinkLoss(1, (2, 9), 0.5)),
                       extra_slack=5) for m in (scenarios, jscenarios)]
    assert hand[0].repro() == hand[1].repro() == "<hand-built scenario 'h'>"
    reprs = [mod.MinimizedRepro(
        scenario=scen, verdict=v, dropped_ops=1, codes=["COMPLETENESS"],
        repro_args="knobs=lambda p: chaos.weakened_knobs(None, p)").repro()
        for mod, scen, v in ((campaign, hand[0], ours[1]),
                             (jcampaign, hand[1], theirs[1]))]
    assert reprs[0] == reprs[1]
    env = {"chaos": chaos}
    rebuilt = eval(reprs[0].replace("chaos.run_scenario(", "(", 1)
                   .rsplit(", seed=", 1)[0] + ")", env)
    assert rebuilt == hand[0]


def test_unported_entry_points_raise_naming_their_roadmap_item():
    scen = scenarios.generate_scenario(100, 16, "mild")
    for fn, item in ((campaign.cross_validate, "A12"),
                     (campaign.cross_validate_churn, "A12"),
                     (campaign.cross_validate_partition, "A12"),
                     (campaign.cross_validate_metadata, "A12")):
        with pytest.raises(NotImplementedError, match=item):
            fn([scen])
    with pytest.raises(NotImplementedError, match="A12"):
        campaign.run_campaign([scen], cross_validate_small_n=True,
                              device="cpu")


def test_knob_overrides_are_int32_values():
    p = campaign.campaign_params(scenarios.Scenario("k", 16, 64, ()))
    weak = campaign.weakened_knobs(None, p)
    breach = campaign.alarm_breach_knobs(None, p)
    assert weak.suspicion_rounds == 1 << 20 and type(weak.suspicion_rounds) \
        is int
    assert breach.ping_every == 1
    assert dataclasses.replace(weak, suspicion_rounds=p.suspicion_rounds) \
        == swim.Knobs.from_params(p)


@pytest.mark.parametrize("name,args", [
    ("ceil_log2", (1000,)),
    ("gossip_convergence_probability", (3, 3, 64, 0.25)),
    ("gossip_convergence_percent", (3, 3, 1000, 10.0)),
    ("max_messages_per_gossip_per_node", (3, 3, 50)),
    ("max_messages_per_gossip_total", (3, 3, 1_000_000)),
    ("gossip_periods_to_spread", (3, 1_000_000)),
    ("gossip_periods_to_sweep", (3, 1_000_000)),
    ("gossip_dissemination_time", (3, 1000, 200)),
    ("gossip_timeout_to_sweep", (3, 1000, 200)),
    ("suspicion_timeout", (5, 1000, 1000)),
    ("fd_false_suspect_probability", (0.1, 3, 64)),
    ("fd_expected_false_onsets", (0.05, 3, 128, 400)),
])
def test_swim_math_equals_the_reference(name, args):
    got, want = getattr(swim_math, name)(*args), getattr(jswim_math,
                                                          name)(*args)
    assert type(got) is type(want) and got == want


def test_port_campaign_journal_reads_in_the_reference(tmp_path):
    """A one-scenario campaign on the CPU (the port's own draws) through a
    ``TelemetrySink``: the reference's ``read_records`` reads the
    manifest, the ``chaos_scenario`` row and the ``chaos_verdict``
    summary as the port's reader does."""
    scens = scenarios.generate_campaign(100, 1, 16)
    path = tmp_path / "chaos.jsonl"
    with sink.TelemetrySink(path=str(path)) as journal:
        result = campaign.run_campaign(scens, seed=100, sink=journal,
                                       device="cpu")
    assert result.manifest_path == str(path) and result.green
    theirs = jsink.read_records(str(path))
    assert theirs == sink.read_records(str(path))
    assert [r["kind"] for r in theirs] == ["manifest", "chaos_scenario",
                                           "chaos_verdict"]
    assert theirs[1]["repro"] == result.verdicts[0].repro()
    assert theirs[2]["green_scenarios"] == 1
    assert theirs[0]["workload"] == {"kind": "chaos_campaign",
                                     "scenarios": 1, "seed": 100,
                                     "delivery": "shift"}
