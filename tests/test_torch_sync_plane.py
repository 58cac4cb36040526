"""The port's SYNC anti-entropy plane (``models/sync.py``,
``SwimParams.sync_interval``) against the JAX package.

The plane's helpers (``due``, ``exchange_targets``, ``sent_count``,
``divergent_cells``) on seeded inputs; then whole runs with the plane on,
both sides on the reference's own draws (``jax_draws`` rebuilds the
exchange's offset and drop uniforms from the reference's folds), every
state lane and stacked metric (``messages_anti_entropy`` among them)
compared exactly:

- the quiesced heal of ``tests/test_sync_plane.py`` (n = 24,
  ``sync_interval=8``, ``sync_every=0``, a split of 144 rounds healed
  for 63) in shift, scatter and ``k_block``, wide and compact, run in
  segments of 16 rounds so that the port's ``divergence_probe`` is held
  against the reference's at every segment's cursor, and the heal
  converging (the reference's claim);
- the focal heal (64 x 8, subjects spread over both halves), the plane
  converging and the gossip-only control not.

The network configuration with the plane on (the exchange bypasses the
delay ring) runs in ``tests/test_torch_lifeguard.py``, with all three
planes, so that its one program compiled at XLA's default options
serves both.

Cost: seven reference programs, each heal case's sent to a compile
thread as soon as it is lowered, with most XLA optimizations off (no
delay sums, so no FMA to keep).
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu.models import sync as jsync  # noqa: E402
from scalecube_cluster_tpu_torch.models import swim  # noqa: E402
from scalecube_cluster_tpu_torch.models import sync  # noqa: E402
from scalecube_cluster_tpu_torch.ops import prng  # noqa: E402
from tests.test_swim_model import fast_config  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    assert_metrics_equal, assert_state_equal, jax_draws, one_torch_thread,
    port_params, port_world)

pytestmark = pytest.mark.torchport

N, SPLIT, HEAL, SEGMENT = 24, 144, 64, 16
HEAL_CASES = {
    "shift-wide": dict(delivery="shift"),
    "shift-compact": dict(delivery="shift", compact_carry=True),
    "scatter-wide": dict(delivery="scatter"),
    "scatter-compact": dict(delivery="scatter", compact_carry=True),
    "k_block-wide": dict(delivery="shift", k_block=8),
    "k_block-compact": dict(delivery="shift", k_block=8, compact_carry=True),
}
FOCAL_N, FOCAL_K, FOCAL_SPLIT, FOCAL_ROUNDS = 64, 8, 160, 240


@pytest.fixture(autouse=True, scope="module")
def quick_reference_compiles():
    previous = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", previous)


# --------------------------------------------------------------------------
# The plane's helpers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_helpers_match_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 300))
    interval = int(rng.integers(1, 40))
    for r in rng.integers(0, 5000, 20).tolist():
        assert sync.due(r, interval) == bool(jsync.due(jnp.int32(r),
                                                       interval))
    ids = np.arange(n, dtype=np.int32)
    s = int(rng.integers(1, n))
    np.testing.assert_array_equal(
        sync.exchange_targets(torch.from_numpy(ids), s, n).numpy(),
        np.asarray(jsync.exchange_targets(jnp.asarray(ids), jnp.int32(s),
                                          n)))
    alive = rng.random(n) < 0.7
    for ae_due in (False, True):
        got = sync.sent_count(ae_due, torch.from_numpy(alive))
        want = jsync.sent_count(jnp.bool_(ae_due), jnp.asarray(alive))
        assert got.dtype == torch.int32 and int(got) == int(want)


@pytest.mark.parametrize("wide_inc", [True, False])
def test_divergent_cells_match_reference(wide_inc):
    """Seeded tables with agreeing and disagreeing columns, frozen rows,
    and (compact layout) int16 incarnations."""
    rng = np.random.default_rng(3)
    n, k = 40, 12
    status = np.zeros((n, k), np.int8)
    inc = np.zeros((n, k), np.int32)
    noisy = rng.random((n, k)) < np.linspace(0, 0.2, k)[None, :]
    status[noisy] = rng.integers(0, 4, noisy.sum())
    inc[noisy] = rng.integers(0, 5, noisy.sum())
    alive = rng.random(n) < 0.8
    want_cells, want_cols = jsync.divergent_cells(
        jnp.asarray(status), jnp.asarray(inc), jnp.asarray(alive))
    port_inc = torch.from_numpy(inc if wide_inc else inc.astype(np.int16))
    cells, cols = sync.divergent_cells(torch.from_numpy(status), port_inc,
                                       torch.from_numpy(alive))
    np.testing.assert_array_equal(cells.numpy(), np.asarray(want_cells))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(want_cols))
    assert 0 < int(cols.sum()) < k


# --------------------------------------------------------------------------
# Whole runs
# --------------------------------------------------------------------------


def _heal_params(overrides, n=N, k=None, sync_interval=8):
    return jswim.SwimParams.from_config(
        fast_config(), n_members=n, n_subjects=k, sync_every=0,
        sync_interval=sync_interval, **overrides)


def _split_world(params, split, subject_ids=None):
    """One split phase of ``split`` rounds over contiguous halves, then
    healed (the reference test's ``_heal_world``)."""
    n = params.n_members
    world = jswim.SwimWorld.healthy(params, subject_ids=subject_ids)
    part = np.zeros((4, n), np.int8)
    part[0, :n // 2] = 1
    return world.with_partition_schedule(part, split)


def _lower(params, world, rounds):
    return jswim.run.lower(jax.random.key(1), params, world, rounds,
                           state=jswim.initial_state(params, world),
                           start_round=0)


@functools.lru_cache(maxsize=None)
def _heal_programs():
    """The reference's ``run`` over SEGMENT rounds for every heal case,
    lowered one after another and compiled three at a time."""
    compiling = {}
    with ThreadPoolExecutor(3) as pool:
        for name, overrides in HEAL_CASES.items():
            params = _heal_params(overrides)
            compiling[name] = pool.submit(_lower(
                params, _split_world(params, SPLIT), SEGMENT).compile)
        return {name: job.result() for name, job in compiling.items()}


@functools.lru_cache(maxsize=None)
def _draws(delivery):
    """The reference's draws of a heal case's delivery mode (the same
    for every layout), kept per round."""
    params = _heal_params(dict(delivery=delivery))
    return functools.lru_cache(maxsize=None)(
        jax_draws(jax.random.key(1), params))


@pytest.mark.parametrize("case", sorted(HEAL_CASES))
def test_quiesced_heal_matches_reference(case):
    """The quiesced heal with the plane on, segment by segment: states,
    metrics and the divergence probe equal at every cursor, and the
    healed table converges with no incarnation burnt."""
    jparams = _heal_params(HEAL_CASES[case])
    jworld = _split_world(jparams, SPLIT)
    params, world = port_params(jparams), port_world(jworld)
    program = _heal_programs()[case]
    draws = _draws(jparams.delivery)
    jstate = jswim.initial_state(jparams, jworld)
    state = swim.initial_state(params, world, device="cpu")
    probes = []
    for start in range(0, SPLIT + HEAL, SEGMENT):
        jstate, jmetrics = program(jax.random.key(1), jworld, state=jstate,
                                   start_round=start)
        state, metrics = swim.run(0, params, world, SEGMENT, state=state,
                                  start_round=start, draws=draws,
                                  device="cpu")
        assert_state_equal(jstate, state)
        assert_metrics_equal(jmetrics, metrics)
        cursor = start + SEGMENT
        got = sync.divergence_probe(state, params, world, cursor)
        assert got.dtype == torch.int32 and got.dim() == 0
        assert int(got) == int(jsync.divergence_probe(jstate, jparams,
                                                      jworld, cursor))
        probes.append(int(got))
    assert max(probes[:SPLIT // SEGMENT]) > 0
    assert probes[-1] == 0
    assert bool((state.status == 0).all()) and int(state.self_inc.max()) == 0
    assert int(metrics["messages_anti_entropy"].sum()) > 0


def test_focal_heal_converges_only_with_plane():
    """The focal heal (64 x 8, subjects at ``arange(8) * 8``), the plane
    on against the reference, round by round; the gossip-only control
    (the same world and draws) stays divergent."""
    subject_ids = jnp.arange(FOCAL_K, dtype=jnp.int32) * (FOCAL_N // FOCAL_K)
    runs = {}
    for interval in (8, 0):
        jparams = _heal_params(dict(delivery="shift"), n=FOCAL_N, k=FOCAL_K,
                               sync_interval=interval)
        jworld = _split_world(jparams, FOCAL_SPLIT, subject_ids)
        params, world = port_params(jparams), port_world(jworld)
        state, metrics = swim.run(
            0, params, world, FOCAL_ROUNDS, device="cpu",
            draws=jax_draws(jax.random.key(5), jparams))
        runs[interval] = int(sync.divergence_probe(state, params, world,
                                                   FOCAL_ROUNDS))
        if interval:
            jstate, jmetrics = jswim.run(jax.random.key(5), jparams, jworld,
                                         FOCAL_ROUNDS)
            assert_state_equal(jstate, state)
            assert_metrics_equal(jmetrics, metrics)
            assert runs[interval] == int(jsync.divergence_probe(
                jstate, jparams, jworld, FOCAL_ROUNDS))
    assert runs[8] == 0 and runs[0] > 0


def test_round_refuses_draws_of_other_plane_settings():
    """Draws made with the plane on carry the exchange's offset (in [1,
    N)) and drop uniforms; a round with the plane off refuses them, and a
    round with the plane on refuses draws without them."""
    params = port_params(_heal_params(dict(delivery="shift"),
                                      sync_interval=0))
    world = swim.SwimWorld.healthy(params, device="cpu")
    on = dataclasses.replace(params, sync_interval=8)
    off_draws = prng.TorchDraws(2, "cpu", params)(3)
    on_draws = prng.TorchDraws(2, "cpu", on)(3)
    assert 1 <= on_draws.ae_offset < N
    state = swim.initial_state(params, world, device="cpu")
    with pytest.raises(ValueError, match="ae_offset"):
        swim.swim_tick(state, 3, params, world, on_draws)
    with pytest.raises(ValueError, match="ae_offset"):
        swim.swim_tick(state, 3, on, world, off_draws)
