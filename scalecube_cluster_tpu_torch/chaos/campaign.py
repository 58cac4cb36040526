"""The campaign runner: monitored scenario sweeps, serial and batched,
and JSONL verdict manifests.

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

The batched half: :func:`build_buckets` groups a scenario list by the
shape of its built runs (:func:`_bucket_key`), :func:`run_bucket` runs
one bucket as one batch (``chaos/monitor.run_monitored_batch`` over
``models/compose.composed_batch_scan``), :func:`run_campaign_vmapped`
is the bucketed campaign (the reference's name; its manifest adds one
``chaos_bucket`` row a bucket) and :func:`run_weakened_slice` the fuzz
coverage arm.  Row i keeps seed ``seed + i``, so every row's verdict is
the serial run's.

Not ported, raising ``NotImplementedError``: the oracle cross-validation
(``cross_validate*``, ``run_campaign(cross_validate_small_n=True)``;
ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

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
    # The bucketed runner's buckets (size, n, horizon), never silent; None
    # for the serial runner.
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
        draws = _moved_draws(seed, params, world, device, draw_device)
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


def _moved_draws(seed: int, params, world, device, draw_device):
    """The port's draws for ``seed`` made on ``draw_device`` and moved to
    the run's ``device``."""
    source = prng.TorchDraws(seed, draw_device, params, world)

    def draws(round_idx):
        return source(round_idx).to(device)

    return draws


# --------------------------------------------------------------------------
# The bucketed campaign: group by the built runs' shape, run a bucket as
# one batch
# --------------------------------------------------------------------------


def _shape_signature(x):
    """A built world's or spec's shape: each tensor's shape and dtype, each
    other number as a scalar leaf, each flag by value, through the
    dataclass fields (not the private host caches)."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype))
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            (f.name, _shape_signature(getattr(x, f.name)))
            for f in dataclasses.fields(x) if not f.name.startswith("_"))
    if isinstance(x, bool):
        return x
    if isinstance(x, (int, float)):
        return ((), type(x).__name__)
    return x


def _bucket_key(params: "swim.SwimParams", horizon: int, world, spec):
    """The shape one batch must share: the params, the horizon, and the
    shapes and dtypes of the built world's and spec's tensors (the rule
    padding and partition-schedule lengths through the world's, the
    monitor's check flags through the spec's), the port's counterpart of
    the reference's pytree signature."""
    return (params, int(horizon), _shape_signature(world),
            _shape_signature(spec))


@dataclasses.dataclass
class ScenarioBucket:
    """One bucket of a batched campaign: scenarios whose
    :func:`_bucket_key` is the same, with their built ``worlds`` and
    ``specs``, run seeds (``seed`` + the scenario's index) and knobs, one
    a row, which :func:`run_bucket` runs as one batch."""

    indices: List[int]
    scenarios: List["cscenarios.Scenario"]
    params: "swim.SwimParams"
    horizon: int
    worlds: List["swim.SwimWorld"]
    specs: List["cmonitor.MonitorSpec"]
    seeds: List[int]
    knobs: List["swim.Knobs"]

    @property
    def size(self) -> int:
        return len(self.indices)

    @property
    def members(self) -> List[tuple]:
        """The rows' ``(world, spec)`` pairs."""
        return list(zip(self.worlds, self.specs))

    @property
    def device(self) -> torch.device:
        return self.worlds[0].device


def build_buckets(scenarios: Sequence["cscenarios.Scenario"],
                  seed: int = 0, delivery: str = "shift",
                  knobs_fn=None, log=None, device="cuda",
                  **param_overrides) -> List[ScenarioBucket]:
    """Group ``scenarios`` by the shape of their built runs
    (:func:`_bucket_key`) into :class:`ScenarioBucket` s, in order of
    first appearance, worlds and specs built on ``device``.  Row i keeps
    the serial runner's seed ``seed + i`` (i the scenario's index in the
    list), so a bucketed run's verdicts equal ``run_campaign``'s on the
    same list.  Never drops a scenario: every index lands in exactly one
    bucket, and a bucket of one still runs; the sizes are logged.
    ``knobs_fn(scenario, params) -> swim.Knobs`` sets a row's knobs
    (default ``Knobs.from_params``; :func:`weakened_knobs`); knobs never
    split a bucket."""
    device = swim.resolve_device(device)
    groups: dict = {}
    for i, scen in enumerate(scenarios):
        params = campaign_params(scen, delivery=delivery, **param_overrides)
        world, spec = scen.build(params, device=device)
        key = _bucket_key(params, scen.horizon, world, spec)
        groups.setdefault(key, []).append((i, scen, params, world, spec))
    buckets = []
    for members in groups.values():
        params = members[0][2]
        buckets.append(ScenarioBucket(
            indices=[m[0] for m in members],
            scenarios=[m[1] for m in members],
            params=params,
            horizon=members[0][1].horizon,
            worlds=[m[3] for m in members],
            specs=[m[4] for m in members],
            seeds=[seed + m[0] for m in members],
            knobs=[knobs_fn(m[1], params) if knobs_fn is not None
                   else swim.Knobs.from_params(params) for m in members]))
    if log is not None:
        for b in buckets:
            log.info("chaos bucket: %d scenario(s) @ n=%d horizon=%d "
                     "(first: %s)", b.size, b.params.n_members, b.horizon,
                     b.scenarios[0].name)
    return buckets


def run_bucket(bucket: ScenarioBucket,
               capacity: int = cmonitor.DEFAULT_CAPACITY, knobs=None,
               draws=None, draw_device=None):
    """One bucket as one batch (``chaos/monitor.run_monitored_batch``) on
    the bucket's device.  Returns ``(monitors, metrics)``, both
    batch-leading.  ``knobs`` (one a row) replaces the bucket's;
    ``draws`` (one source a row) replaces the port's own draws, which
    ``draw_device`` makes on another device (as :func:`run_scenario`)."""
    if draws is None and draw_device is not None:
        draws = [_moved_draws(s, bucket.params, w, bucket.device,
                              draw_device)
                 for s, w in zip(bucket.seeds, bucket.worlds)]
    _, mon, metrics = cmonitor.run_monitored_batch(
        bucket.seeds, bucket.params, bucket.worlds, bucket.specs,
        bucket.horizon, capacity=capacity,
        knobs=bucket.knobs if knobs is None else knobs, draws=draws,
        device=bucket.device)
    return mon, metrics


def run_campaign_vmapped(scenarios: Sequence["cscenarios.Scenario"],
                         seed: int = 0, delivery: str = "shift",
                         capacity: int = cmonitor.DEFAULT_CAPACITY,
                         sink=None, log=None, knobs_fn=None,
                         buckets: Optional[List[ScenarioBucket]] = None,
                         device="cuda", draw_device=None) -> CampaignResult:
    """The bucketed campaign (the reference's name): ``scenarios`` grouped
    by :func:`build_buckets` (or the ``buckets`` given), each bucket run
    as one batch (:func:`run_bucket`), every row's verdict extracted.
    Row i's verdict is ``run_scenario(scenarios[i], seed=seed + i)``'s.

    The manifest is ``run_campaign``'s (a ``manifest`` header,
    ``chaos_scenario`` rows in scenario order, the closing
    ``chaos_verdict``) plus one ``chaos_bucket`` row a bucket.
    ``draw_device``: see :func:`run_scenario`."""
    if buckets is None:
        buckets = build_buckets(scenarios, seed=seed, delivery=delivery,
                                knobs_fn=knobs_fn, log=log, device=device)
    if sink is not None:
        sink.write_manifest(
            params=campaign_config(),
            workload={"kind": "chaos_campaign_vmapped",
                      "scenarios": len(scenarios), "seed": seed,
                      "delivery": delivery,
                      "bucket_sizes": [b.size for b in buckets]})
    verdicts: List[Optional[ScenarioVerdict]] = [None] * len(scenarios)
    for b in buckets:
        mon_b, metrics_b = run_bucket(b, capacity=capacity,
                                      draw_device=draw_device)
        counters = {k: metrics_b[k].flatten(1).sum(-1).tolist()
                    for k in _COUNTER_KEYS if k in metrics_b}
        for j, (i, scen, mon) in enumerate(zip(
                b.indices, b.scenarios, cmonitor.unstack_monitor(mon_b))):
            v = cmonitor.verdict(mon)
            verdicts[i] = ScenarioVerdict(
                scenario=scen, green=v["green"], verdict=v, seed=seed + i,
                delivery=delivery,
                counters={k: int(c[j]) for k, c in counters.items()})
        green = sum(1 for i in b.indices if verdicts[i].green)
        if sink is not None:
            sink.write_record("chaos_bucket", {
                "scenarios": b.size, "n_members": b.params.n_members,
                "horizon": b.horizon, "green_scenarios": green})
        if log is not None:
            log.info("chaos bucket (%d scenarios, horizon %d): %d green",
                     b.size, b.horizon, green)
    if sink is not None:
        for v in verdicts:
            sink.write_record("chaos_scenario", v.to_json())
    result = CampaignResult(
        verdicts=verdicts, manifest_path=getattr(sink, "path", None),
        buckets=[{"scenarios": b.size, "n_members": b.params.n_members,
                  "horizon": b.horizon} for b in buckets])
    if sink is not None:
        sink.write_record("chaos_verdict", result.summary())
    return result


def run_weakened_slice(buckets: List[ScenarioBucket],
                       capacity: int = cmonitor.DEFAULT_CAPACITY,
                       knobs_fn=None, draw_device=None):
    """The fuzz coverage arm: every bucket holding a row that promises
    completeness (a finite ``MonitorSpec.complete_by``) rerun under
    ``knobs_fn`` (default :func:`weakened_knobs`).  Returns
    ``(cov_indices, weak_counts, first_red)``: the completeness-promising
    scenario indices, their summed per-code violation totals on the
    weakened build (int64 [N_CODES]) and the first red row's index (None
    if the weakened arm found nothing)."""
    if knobs_fn is None:
        knobs_fn = weakened_knobs
    cov = {i for b in buckets for i, spec in zip(b.indices, b.specs)
           if bool((torch.as_tensor(spec.complete_by) < INT32_MAX).any())}
    weak_counts = np.zeros(cmonitor.N_CODES, dtype=np.int64)
    first_red = None
    for b in buckets:
        if not any(i in cov for i in b.indices):
            continue
        mon_w, _ = run_bucket(
            b, capacity=capacity,
            knobs=[knobs_fn(s, b.params) for s in b.scenarios],
            draw_device=draw_device)
        for i, mon in zip(b.indices, cmonitor.unstack_monitor(mon_w)):
            if i not in cov:
                continue
            counts = mon.code_counts.cpu().numpy().astype(np.int64)
            weak_counts += counts
            if first_red is None and counts.sum() > 0:
                first_red = i
    return cov, weak_counts, first_red


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
