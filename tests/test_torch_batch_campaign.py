"""The port's bucketed campaign (``chaos/campaign.py``'s batched half)
against the JAX package.

- ``build_buckets`` partitions ``generate_fuzz_campaign`` lists exactly
  as the reference does (every scenario alone at (100, 2, 16); a
  two-row bucket at (3, 3, 16));
- ``run_bucket`` on that two-row bucket equals the reference's
  ``run_bucket`` on the reference's draws: every monitor field and
  metric, ``unstack_monitor``'s rows judged as the reference's.

The bucketed rows against the serial runner are
``tests/test_torch_batch_campaign_rows.py``.  Cost: one reference
program at N = 16 (the monitored batch, two rows, 192 rounds).
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from scalecube_cluster_tpu.chaos import campaign as jcampaign  # noqa: E402
from scalecube_cluster_tpu.chaos import monitor as jmonitor  # noqa: E402
from scalecube_cluster_tpu.chaos import scenarios as jscenarios  # noqa: E402
from scalecube_cluster_tpu_torch.chaos import campaign  # noqa: E402
from scalecube_cluster_tpu_torch.chaos import monitor  # noqa: E402
from scalecube_cluster_tpu_torch.chaos import scenarios  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    assert_metrics_equal, assert_monitor_equal, jax_draws, one_torch_thread)

pytestmark = pytest.mark.torchport

# The list with a two-row bucket (rows 0 and 6: mild-3-leave,
# mild-9-crash, horizon 192); the campaign comparisons run its rows 0, 1
# and 6 as a list of their own (buckets [0, 2] and [1]).
SEED, PER_TIER, N = 3, 3, 16
ROWS = (0, 1, 6)


@functools.lru_cache(maxsize=None)
def _scenarios():
    return scenarios.generate_fuzz_campaign(SEED, PER_TIER, N)


@pytest.mark.parametrize("seed,per_tier", [(100, 2), (SEED, PER_TIER)])
def test_build_buckets_partition_as_the_reference(seed, per_tier):
    """Bucket indices, sizes, horizons and seeds equal the reference's."""
    port = campaign.build_buckets(
        scenarios.generate_fuzz_campaign(seed, per_tier, N), seed=seed,
        device="cpu")
    ref = jcampaign.build_buckets(
        jscenarios.generate_fuzz_campaign(seed, per_tier, N), seed=seed)
    assert [b.indices for b in port] == [b.indices for b in ref]
    assert [b.horizon for b in port] == [b.horizon for b in ref]
    assert [b.seeds for b in port] == [[seed + i for i in b.indices]
                                       for b in ref]
    assert sorted(i for b in port for i in b.indices) == list(
        range(3 * per_tier))


def test_run_bucket_matches_reference():
    """The two-row bucket, run as one batch on the reference's draws,
    equals the reference's ``run_bucket``: monitors and metrics."""
    jbucket = next(b for b in jcampaign.build_buckets(
        jscenarios.generate_fuzz_campaign(SEED, PER_TIER, N), seed=SEED)
        if b.size > 1)
    bucket = next(b for b in campaign.build_buckets(
        _scenarios(), seed=SEED, device="cpu") if b.size > 1)
    assert bucket.indices == jbucket.indices == [0, 6]
    jmon, jm = jcampaign.run_bucket(jbucket)
    draws = [jax_draws(jax.random.key(SEED + i), jbucket.params, world)
             for i, (world, _) in zip(jbucket.indices, jbucket.members)]
    mon, m = campaign.run_bucket(bucket, draws=draws)
    assert_metrics_equal(jm, m)
    for want, got in zip(jmonitor.unstack_monitor(jmon),
                         monitor.unstack_monitor(mon)):
        assert_monitor_equal(want, got)


def _rows():
    return [_scenarios()[i] for i in ROWS]


@functools.lru_cache(maxsize=None)
def _serial(weakened=False):
    """The serial runner's verdicts of :func:`_rows` (own draws)."""
    knobs = ((lambda p: campaign.weakened_knobs(None, p)) if weakened
             else None)
    return [campaign.run_scenario(scen, seed=SEED + i, knobs=knobs,
                                  device="cpu")
            for i, scen in enumerate(_rows())]


def _buckets():
    buckets = campaign.build_buckets(_rows(), seed=SEED, device="cpu")
    assert [b.indices for b in buckets] == [[0, 2], [1]]
    return buckets
