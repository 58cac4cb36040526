"""The campaign runner's serial half: monitored scenario sweeps and JSONL
verdict manifests.

Counterpart of ``scalecube_cluster_tpu/chaos/campaign.py``.
:func:`run_scenario` builds one :class:`~.scenarios.Scenario` against
the campaign timing preset, runs it through the invariant monitor
(:func:`~.monitor.run_monitored`) and returns a :class:`ScenarioVerdict`;
:func:`run_campaign` sweeps a scenario list, scenario i with seed
``seed + i``, and writes one JSONL manifest through
``telemetry/sink.TelemetrySink``: a ``manifest`` header, one
``chaos_scenario`` row a scenario (green flag, per-code violation
counts, first-violation evidence, counter sums, the one-line repro) and
a closing ``chaos_verdict`` summary, the reference's record kinds (its
``sink.read_records`` reads them).  :func:`minimize` shrinks a red
scenario to the ops that still reproduce its codes, and
:func:`weakened_knobs` / :func:`alarm_breach_knobs` are the coverage
arm's and the alarm drill's knob overrides.

Not ported, raising ``NotImplementedError``: the batched runner
(:func:`build_buckets`, :func:`run_bucket`, :func:`run_campaign_vmapped`,
:func:`run_weakened_slice`; ROADMAP A10) and the oracle cross-validation
(``cross_validate*``, ``run_campaign(cross_validate_small_n=True)``;
ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from scalecube_cluster_tpu_torch.chaos import monitor as cmonitor
from scalecube_cluster_tpu_torch.chaos import scenarios as cscenarios
from scalecube_cluster_tpu_torch.config import ClusterConfig
from scalecube_cluster_tpu_torch.models import swim
from scalecube_cluster_tpu_torch.ops import prng

INT32_MAX = cscenarios.INT32_MAX


def campaign_config() -> ClusterConfig:
    """The campaign timing preset: the loopback defaults with a 100 ms
    gossip round, pings every 200 ms with a 100 ms timeout, SYNC every
    second and suspicion multiplier 3, so scenarios quiesce in tens of
    rounds."""
    return ClusterConfig.default_local().replace(
        gossip_interval=100,
        ping_interval=200,
        ping_timeout=100,
        sync_interval=1_000,
        suspicion_mult=3,
    )


def campaign_params(scenario: "cscenarios.Scenario",
                    delivery: str = "shift",
                    **overrides) -> "swim.SwimParams":
    """``SwimParams`` for one scenario: full view, the scenario's
    background wire loss, the open-world plane on when the scenario
    schedules joins (``Scenario.has_joins``), the metadata plane sized by
    ``Scenario.metadata_keys_needed`` when an op pushes a config word.
    Explicit overrides win."""
    kwargs = dict(loss_probability=scenario.loss_probability,
                  delivery=delivery)
    if scenario.has_joins:
        kwargs["open_world"] = True
    if scenario.has_metadata:
        kwargs["metadata_keys"] = scenario.metadata_keys_needed()
    kwargs.update(overrides)
    return swim.SwimParams.from_config(
        campaign_config(), n_members=scenario.n_members, **kwargs)


@dataclasses.dataclass
class ScenarioVerdict:
    """One scenario's outcome: the monitor verdict and how the run was
    made."""

    scenario: "cscenarios.Scenario"
    green: bool
    verdict: dict                  # chaos.monitor.verdict() digest
    seed: int
    delivery: str
    counters: dict                 # summed per-round protocol counters
    cross_validation: Optional[dict] = None

    def repro(self) -> str:
        """The whole one-line repro: the scenario's reconstruction and
        the run's seed (under loss or partitions the violations depend on
        the draws)."""
        return (f"chaos.run_scenario({self.scenario.repro()}, "
                f"seed={self.seed}, delivery={self.delivery!r})")

    def to_json(self) -> dict:
        return {
            "name": self.scenario.name,
            "severity": self.scenario.severity,
            "n_members": self.scenario.n_members,
            "horizon": self.scenario.horizon,
            "loss_probability": self.scenario.loss_probability,
            "ops": [f"{type(op).__name__}{dataclasses.asdict(op)}"
                    for op in self.scenario.ops],
            "repro": self.repro(),
            "seed": self.seed,
            "delivery": self.delivery,
            "green": self.green,
            "verdict": self.verdict,
            "counters": self.counters,
            "cross_validation": self.cross_validation,
        }


@dataclasses.dataclass
class CampaignResult:
    verdicts: List[ScenarioVerdict]
    manifest_path: Optional[str]
    # The batched runner's compile-shape buckets; None for this runner.
    buckets: Optional[List[dict]] = None

    @property
    def green(self) -> bool:
        return all(v.green for v in self.verdicts)

    def summary(self) -> dict:
        by_code: dict = {}
        for v in self.verdicts:
            for code, d in v.verdict["codes"].items():
                by_code[code] = by_code.get(code, 0) + d["violations"]
        return {
            "scenarios": len(self.verdicts),
            "green_scenarios": sum(v.green for v in self.verdicts),
            "green": self.green,
            "violations_by_code": by_code,
            "failing_repros": [v.repro() for v in self.verdicts
                               if not v.green],
        }


_COUNTER_KEYS = ("false_suspicion_onsets", "false_positives",
                 "refutations", "messages_gossip", "messages_ping_sent")


def run_scenario(scenario: "cscenarios.Scenario", seed: int = 0,
                 delivery: str = "shift",
                 capacity: int = cmonitor.DEFAULT_CAPACITY,
                 knobs=None, device="cuda", draws=None, draw_device=None,
                 **param_overrides) -> ScenarioVerdict:
    """Build and run one scenario through the monitored rounds.

    Never raises on a violated invariant: the run completes and the red
    verdict carries the evidence; only a malformed scenario raises, at
    build time.  ``knobs``: a ``swim.Knobs`` or a callable ``params ->
    Knobs`` (:func:`weakened_knobs`); None runs the params' own values.
    ``draws``: a callable ``round_idx -> draws`` for the run (the
    scenario's params and built world decide which draws a round takes);
    None makes the port's ``TorchDraws(seed, ...)`` on ``draw_device``
    (default the run's device), moved to the run's device."""
    device = swim.resolve_device(device)
    params = campaign_params(scenario, delivery=delivery,
                             **param_overrides)
    world, spec = scenario.build(params, device=device)
    if draws is None and draw_device is not None:
        source = prng.TorchDraws(seed, draw_device, params, world)

        def draws(round_idx):
            return source(round_idx).to(device)

    _, mon, metrics = cmonitor.run_monitored(
        seed, params, world, spec, scenario.horizon, capacity=capacity,
        knobs=knobs(params) if callable(knobs) else knobs, draws=draws,
        device=device)
    v = cmonitor.verdict(mon)
    counters = {k: int(metrics[k].sum()) for k in _COUNTER_KEYS
                if k in metrics}
    return ScenarioVerdict(scenario=scenario, green=v["green"],
                           verdict=v, seed=seed, delivery=delivery,
                           counters=counters)


def run_campaign(scenarios: Sequence["cscenarios.Scenario"],
                 seed: int = 0, delivery: str = "shift",
                 sink=None, log=None,
                 cross_validate_small_n: bool = False,
                 device="cuda", draw_device=None) -> CampaignResult:
    """Sweep ``scenarios`` through :func:`run_scenario`, scenario i with
    seed ``seed + i`` (for a list from ``generate_campaign`` with the
    same base seed, a scenario's run seed is its generation seed, so each
    row's repro line is exact); write one JSONL manifest when ``sink``
    (a ``telemetry.sink.TelemetrySink``) is given.  ``draw_device``: see
    :func:`run_scenario`.  ``cross_validate_small_n`` (the oracle
    replay) raises ``NotImplementedError``."""
    if cross_validate_small_n:
        raise NotImplementedError(
            "run_campaign(cross_validate_small_n=True) replays scenarios on "
            "the reference's event-driven oracle, which is not ported "
            "(ROADMAP A12)")
    verdicts = []
    if sink is not None:
        sink.write_manifest(
            params=campaign_config(),       # digest groups same-preset runs
            workload={"kind": "chaos_campaign",
                      "scenarios": len(scenarios), "seed": seed,
                      "delivery": delivery},
        )
    for i, scen in enumerate(scenarios):
        v = run_scenario(scen, seed=seed + i, delivery=delivery,
                         device=device, draw_device=draw_device)
        verdicts.append(v)
        if log is not None:
            log.info("chaos scenario %s: %s", scen.name,
                     "green" if v.green else
                     f"RED {v.verdict['codes']}")
        if sink is not None:
            sink.write_record("chaos_scenario", v.to_json())
    result = CampaignResult(verdicts=verdicts,
                            manifest_path=getattr(sink, "path", None))
    if sink is not None:
        sink.write_record("chaos_verdict", result.summary())
    return result


def _batched(name: str):
    raise NotImplementedError(
        f"chaos.campaign.{name} is the batched campaign runner (one batched "
        f"program a compile-shape bucket, compose.composed_batch_scan), "
        f"which is not ported (ROADMAP A10); run_campaign runs the same "
        f"scenarios one by one with the same verdicts")


def build_buckets(*args, **kwargs):
    """Not ported: the batched runner (ROADMAP A10)."""
    _batched("build_buckets")


def run_bucket(*args, **kwargs):
    """Not ported: the batched runner (ROADMAP A10)."""
    _batched("run_bucket")


def run_campaign_vmapped(*args, **kwargs):
    """Not ported: the batched runner (ROADMAP A10)."""
    _batched("run_campaign_vmapped")


def run_weakened_slice(*args, **kwargs):
    """Not ported: the batched runner (ROADMAP A10)."""
    _batched("run_weakened_slice")


def _oracle(name: str):
    raise NotImplementedError(
        f"chaos.campaign.{name} replays a scenario on the reference's "
        f"event-driven oracle, which is not ported (ROADMAP A12)")


def cross_validate(*args, **kwargs):
    """Not ported: the oracle replay (ROADMAP A12)."""
    _oracle("cross_validate")


def cross_validate_churn(*args, **kwargs):
    """Not ported: the oracle replay (ROADMAP A12)."""
    _oracle("cross_validate_churn")


def cross_validate_partition(*args, **kwargs):
    """Not ported: the oracle replay (ROADMAP A12)."""
    _oracle("cross_validate_partition")


def cross_validate_metadata(*args, **kwargs):
    """Not ported: the oracle replay (ROADMAP A12)."""
    _oracle("cross_validate_metadata")


def weakened_knobs(scenario: "cscenarios.Scenario",
                   params: "swim.SwimParams") -> "swim.Knobs":
    """The deliberately weakened build of the fuzz coverage arm:
    suspicion timers stretched to 2^20 rounds, past any campaign horizon,
    so suspicions never turn DEAD and every scenario that promises
    completeness (a finite ``MonitorSpec.complete_by``) must trip
    COMPLETENESS past its deadline.  The knob is stored as an int32
    value, as the reference's ``jnp.int32``."""
    del scenario  # same weakening for every row; the hook passes it
    return swim.Knobs.for_params(params, suspicion_rounds=1 << 20)


def alarm_breach_knobs(scenario: "cscenarios.Scenario",
                       params: "swim.SwimParams") -> "swim.Knobs":
    """The alarm drill's breach arm (``bench.py --alarms``): probe every
    round (``ping_every=1``) instead of the campaign cadence, so each
    probe into the drill's loss pulse is one more chance to suspect a
    live member falsely, while ``suspicion_rounds`` stays (shortening it
    would turn false suspicions into false deaths and stop the probes).
    Stored as an int32 value."""
    del scenario  # one amplification for every drill scenario
    return swim.Knobs.for_params(params, ping_every=1)


# --------------------------------------------------------------------------
# Minimizing reducer: violating scenario -> one-line repro
# --------------------------------------------------------------------------


@dataclasses.dataclass
class MinimizedRepro:
    """:func:`minimize`'s result: the shrunken, still-violating scenario,
    its red verdict, and the one-line repro."""

    scenario: "cscenarios.Scenario"
    verdict: ScenarioVerdict
    dropped_ops: int
    codes: List[str]
    # Extra run_scenario arguments the replay needs, verbatim (e.g. the
    # weakened build's knobs): without them the repro would replay the
    # healthy build and reproduce nothing.
    repro_args: str = ""

    def repro(self) -> str:
        """One line that reproduces the minimized violation (every name
        resolves under ``from scalecube_cluster_tpu_torch import
        chaos``)."""
        ops = ", ".join(f"chaos.{op!r}" for op in self.scenario.ops)
        trail = "," if len(self.scenario.ops) == 1 else ""
        extra = (f", extra_slack={self.scenario.extra_slack}"
                 if self.scenario.extra_slack else "")
        suffix = f", {self.repro_args}" if self.repro_args else ""
        return (f"chaos.run_scenario(chaos.Scenario("
                f"name={self.scenario.name!r}, "
                f"n_members={self.scenario.n_members}, "
                f"horizon={self.scenario.horizon}, ops=({ops}{trail}), "
                f"loss_probability={self.scenario.loss_probability}"
                f"{extra}), seed={self.verdict.seed}, "
                f"delivery={self.verdict.delivery!r}{suffix})")


def minimize(verdict: ScenarioVerdict, run=None, log=None,
             repro_args: str = "") -> MinimizedRepro:
    """Greedy reducer: drop ops from a violating scenario one at a time
    (the sweep restarting after each successful drop) while every one of
    the verdict's violating codes still reproduces under the same seed
    and delivery, down to a local minimum.

    ``run(scenario) -> ScenarioVerdict`` replaces the replay (default:
    :func:`run_scenario` with the verdict's seed and delivery on the
    card); pass what it changes as ``repro_args`` (verbatim
    ``run_scenario`` arguments) so the repro line replays the failing
    build.  A drop that breaks the DSL's composition (a ``ValueError`` or
    ``TypeError`` at build time) keeps its op; a drop that adds codes
    keeps only the original ones as the predicate."""
    codes = [c for c, d in verdict.verdict["codes"].items()
             if d["violations"] > 0]
    if not codes:
        raise ValueError("minimize() needs a violating verdict "
                         "(all code totals are zero)")
    if run is None:
        def run(scen):
            return run_scenario(scen, seed=verdict.seed,
                                delivery=verdict.delivery)

    cur_scen, cur_verdict = verdict.scenario, verdict
    dropped = 0
    progress = True
    while progress and len(cur_scen.ops) > 1:
        progress = False
        for j in range(len(cur_scen.ops)):
            cand = dataclasses.replace(
                cur_scen, ops=cur_scen.ops[:j] + cur_scen.ops[j + 1:],
                name=f"{verdict.scenario.name}-min",
                seed=None, severity=None)
            try:
                v = run(cand)
            except (ValueError, TypeError):
                continue        # the drop broke DSL composition: keep op
            if all(v.verdict["codes"][c]["violations"] > 0
                   for c in codes):
                cur_scen, cur_verdict = cand, v
                dropped += 1
                progress = True
                if log is not None:
                    log.info("minimize: dropped op %d -> %d op(s) left",
                             j, len(cand.ops))
                break
    return MinimizedRepro(scenario=cur_scen, verdict=cur_verdict,
                          dropped_ops=dropped, codes=codes,
                          repro_args=repro_args)
