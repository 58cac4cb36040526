"""Chaos engineering for the SWIM round: fault campaigns run through the
invariant monitor.

Counterpart of ``scalecube_cluster_tpu/chaos``:

  - :mod:`~scalecube_cluster_tpu_torch.chaos.scenarios`, the declarative
    fault DSL (crashes, leaves, churn storms, joins, flapping links,
    brownouts, rolling partitions, config pushes, staged rollouts) built
    onto the world's schedules, and the seeded severity-tiered campaign
    generator;
  - :mod:`~scalecube_cluster_tpu_torch.chaos.monitor`, the invariant
    monitor riding the rounds (a fixed-capacity violation buffer, overflow
    counted: a violated run completes and reports);
  - :mod:`~scalecube_cluster_tpu_torch.chaos.campaign`, the campaign
    runners, serial and bucketed (each bucket one batch of
    ``models/compose.composed_batch_scan``), with their JSONL manifests
    and the minimizing reducer.

Every name a ``repro()`` line uses resolves here, so a red verdict's line
runs as written after ``from scalecube_cluster_tpu_torch import chaos``.
The oracle replay (``cross_validate*``) raises ``NotImplementedError``.
"""

from scalecube_cluster_tpu_torch.chaos.monitor import (  # noqa: F401
    DEFAULT_CAPACITY,
    InvariantCode,
    InvariantViolation,
    MonitorSpec,
    MonitorState,
    decode_violations,
    run_monitored,
    run_monitored_batch,
    run_monitored_metered,
    unstack_monitor,
    verdict,
)
from scalecube_cluster_tpu_torch.chaos.scenarios import (  # noqa: F401
    Brownout,
    ChurnStorm,
    ConfigPush,
    Crash,
    CrashBurst,
    FlappingLink,
    Join,
    Leave,
    LinkLoss,
    RollingPartition,
    SEVERITIES,
    Scenario,
    StagedRollout,
    alarm_drill_scenario,
    asymmetric_degradation,
    asymmetric_degraded_range,
    blame_drill_scenario,
    churn_growth_scenario,
    completeness_bound,
    generate_campaign,
    generate_fuzz_campaign,
    generate_scenario,
    metadata_convergence_bound,
    post_heal_agreement_bound,
    quiesce_bound,
    quiesced_heal_scenario,
)
from scalecube_cluster_tpu_torch.chaos.campaign import (  # noqa: F401
    CampaignResult,
    MinimizedRepro,
    ScenarioBucket,
    ScenarioVerdict,
    alarm_breach_knobs,
    build_buckets,
    campaign_config,
    campaign_params,
    cross_validate,
    minimize,
    run_bucket,
    run_campaign,
    run_campaign_vmapped,
    run_scenario,
    weakened_knobs,
)
