"""The port's scatter delivery (``delivery="scatter"``, the reference's
default) against the JAX package.

Whole runs: JAX ``swim.run(key, ...)`` and the port's ``run(...,
draws=jax_draws(key, params, world))`` on the same params and world;
every ``SwimState`` lane (``flag_ring`` too) and every stacked metric
must be equal.  Configurations:

- focal 64 x 8, uniform probe targets (``ping_known_only=False``), a
  crash with a revive, a graceful leave and a two-phase partition
  schedule: wide, ``int16_wire``, ``compact_carry`` and compact +
  ``wire24``;
- full view 32 x 32, known-only probe targets (the Gumbel argmax): wide
  and ``compact_carry``;
- the mixed cases: focal with ``ping_known_only=True`` and full view
  with ``ping_known_only=False`` (shift refuses both);
- the network case, focal 64 x 8: a delayed brownout and a two-way block
  (eight rules), ``mean_delay_ms=50``, a 4-slot ring and two user
  gossips, wide and ``int16_wire`` on the fused wire (keys only in the
  ring; the flag ring stays zero) and wide on the two-buffer wire
  (``fused_wire=False``, which pushes flags into the flag ring);
- a seeded cold start at full view 16 x 16 (seeds 0, 1, 2, a block, a
  3-slot ring at ``mean_delay_ms=150``), ``warm=False``.

One ``swim_tick`` equals a one-round ``run`` and leaves its input state
alone.  Unit cases hold ``scatter_max`` / ``scatter_or`` (duplicate targets,
drops, both wire dtypes), ``targets_excluding_self`` and
``choose_eligible`` (ties, rows with nothing eligible) against the
reference's own functions; ``TorchDraws`` and the draw check; and one
oracle scenario, the seed-hub cold-start join of
``tests/test_coldstart_churn.py``, runs on the port's scatter mode with
its own draws under that file's bands and seed count.

Exact equality throughout.  The reference's programs with delays
compile with XLA's default optimizations (the delay sums are FMAs there,
which the port reproduces).  Cost: the twelve reference programs are
most of it; each is lowered in turn and compiled in a background thread
from the moment it is lowered, and configurations of one shape share
one set of draws.

The whole runs are held in ``tests/test_torch_scatter_runs.py`` and
``tests/test_torch_scatter_runs_mixed.py``, six configurations each, on
the configurations and programs defined here.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scalecube_cluster_tpu.chaos.scenarios import Brownout  # noqa: E402
from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu.ops import delivery as jdelivery  # noqa: E402
from scalecube_cluster_tpu.ops import prng as jprng  # noqa: E402
from scalecube_cluster_tpu_torch import config as pconfig  # noqa: E402
from scalecube_cluster_tpu_torch.kernels import LAUNCHES  # noqa: E402
from scalecube_cluster_tpu_torch.models import swim  # noqa: E402
from scalecube_cluster_tpu_torch.ops import delivery, prng  # noqa: E402
from tests import test_coldstart_churn as coldstart  # noqa: E402
from tests.test_swim_model import fast_config  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402
    STATE_FIELDS, assert_metrics_equal, assert_state_equal, jax_draws,
    one_torch_thread, port_params, port_world)

pytestmark = pytest.mark.torchport

ROUNDS = 32
LAYOUTS = {"wide": {}, "int16_wire": dict(int16_wire=True),
           "compact": dict(compact_carry=True),
           "compact_wire24": dict(compact_carry=True, wire24=True)}


def _faults_world(params, n):
    """A crash with a revive, a graceful leave and a partition healing at
    round 12."""
    split = (np.arange(n) >= n // 2).astype(np.int8)
    return (jswim.SwimWorld.healthy(params)
            .with_partition_schedule(np.stack([split, np.zeros(n, np.int8)]),
                                     phase_rounds=12)
            .with_crash(3, at_round=2, until_round=20)
            .with_leave(5, at_round=8))


def _plain(n, k, layout="wide", known_only=None):
    # suspicion_mult=1 brings SUSPECT -> DEAD inside the run.
    extra = {} if known_only is None else dict(ping_known_only=known_only)
    params = jswim.SwimParams.from_config(
        fast_config().replace(suspicion_mult=1), n_members=n, n_subjects=k,
        loss_probability=0.05, delivery="scatter", **LAYOUTS[layout],
        **extra)
    return params, _faults_world(params, n), True


def _network(layout, fused_wire=True):
    # One proxy and two gossip channels keep the reference programs small
    # (each rule is unrolled into every link evaluation).
    params = jswim.SwimParams.from_config(
        fast_config().replace(suspicion_mult=1), n_members=64, n_subjects=8,
        loss_probability=0.05, mean_delay_ms=50.0, max_delay_rounds=3,
        n_user_gossips=2, delivery="scatter", ping_req_members=1, fanout=2,
        fused_wire=fused_wire, **LAYOUTS[layout])
    world = Brownout(src=(0, 6), dst=(6, 64), peak_loss=0.5, from_round=4,
                     ramp_rounds=6, hold_rounds=4, steps=3,
                     peak_delay_ms=400.0).apply(
        jswim.SwimWorld.healthy(params), 64, ROUNDS)
    world = (world.with_block(5, (0, 64), 14, 24)
             .with_block((0, 64), 5, 14, 24)
             .with_crash(3, at_round=2, until_round=26)
             .with_spread(0, 7, 3).with_spread(1, 40, 9))
    return params, world, True


def _seeded_cold_start():
    params = jswim.SwimParams.from_config(
        fast_config(), n_members=16, loss_probability=0.05,
        mean_delay_ms=150.0, max_delay_rounds=2, delivery="scatter")
    world = (jswim.SwimWorld.healthy(params).with_seeds([0, 1, 2])
             .with_block(5, (0, 16), 10, 22))
    return params, world, False


CONFIGS = {
    **{f"focal_{layout}": functools.partial(_plain, 64, 8, layout)
       for layout in LAYOUTS},
    "full_view_wide": functools.partial(_plain, 32, None),
    "full_view_compact": functools.partial(_plain, 32, None, "compact"),
    "focal_known_only": functools.partial(_plain, 64, 8, known_only=True),
    "full_view_uniform": functools.partial(_plain, 32, None,
                                           known_only=False),
    "network_wide": functools.partial(_network, "wide"),
    "network_int16_wire": functools.partial(_network, "int16_wire"),
    "network_two_buffer": functools.partial(_network, "wide",
                                            fused_wire=False),
    "seeded_cold_start": _seeded_cold_start,
}
# Configurations that share their draws (same shapes and draw facts).
DRAW_GROUP = dict(
    {name: name for name in CONFIGS},
    **{f"focal_{layout}": "focal" for layout in LAYOUTS},
    full_view_wide="full_view", full_view_compact="full_view",
    network_wide="network", network_int16_wire="network",
    network_two_buffer="network")


# XLA's backend optimizations off: a third faster to compile, and no
# result changes where no delay is summed (integers and float32 compares).
QUICK = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}


@functools.lru_cache(maxsize=None)
def _reference_programs(names):
    """JAX's ``run`` over ROUNDS rounds for the configurations ``names``,
    keyed by name: lowered one after another (tracing holds the GIL),
    each compiled in the background from the moment it is lowered, four
    at a time; the configurations with delays at XLA's default
    optimizations (which fuse the delay sum into an FMA), the others at
    ``QUICK``."""
    compiling = {}
    with ThreadPoolExecutor(4) as pool:
        for name in names:
            params, world, warm = CONFIGS[name]()
            lowered = jswim.run.lower(
                jax.random.key(0), params, world, ROUNDS,
                state=jswim.initial_state(params, world, warm=warm),
                start_round=0)
            delayed = params.mean_delay_ms != 0 or world.faults.n_rules
            compiling[name] = pool.submit(
                lowered.compile, compiler_options=None if delayed else QUICK)
        return {name: job.result() for name, job in compiling.items()}


@functools.lru_cache(maxsize=None)
def _draws(group):
    """One draw group's reference draws, built once and kept per round."""
    name = next(n for n, g in DRAW_GROUP.items() if g == group)
    params, world, _ = CONFIGS[name]()
    return functools.lru_cache(maxsize=None)(
        jax_draws(jax.random.key(0), params, world))


# Whole runs, in two files of six configurations
# (tests/test_torch_scatter_runs.py, test_torch_scatter_runs_mixed.py).
RUN_FILES = (tuple(f"focal_{layout}" for layout in LAYOUTS)
             + ("full_view_wide", "full_view_compact"),
             ("focal_known_only", "full_view_uniform", "network_wide",
              "network_int16_wire", "network_two_buffer",
              "seeded_cold_start"))


def check_run(name, names):
    """One configuration's whole run on both sides, the reference's
    programs compiled for ``names`` (its file's configurations)."""
    jparams, jworld, warm = CONFIGS[name]()
    params, world = port_params(jparams), port_world(jworld)
    jstate0 = jswim.initial_state(jparams, jworld, warm=warm)
    state0 = swim.initial_state(params, world, warm=warm, device="cpu")
    assert_state_equal(jstate0, state0)
    jstate, jmetrics = _reference_programs(names)[name](
        jax.random.key(0), jworld, state=jstate0, start_round=0)
    LAUNCHES.clear()
    state, metrics = swim.run(0, params, world, ROUNDS, state=state0,
                              draws=_draws(DRAW_GROUP[name]), device="cpu")
    assert not LAUNCHES                      # the CPU runs plain versions
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, metrics)
    # The window holds what the configuration was built for.
    if name.startswith(("focal", "full_view")):
        assert int(metrics["suspect"][:, 3].max()) > 0
        assert int(metrics["dead"][:, 3].max()) > 0
    if name.startswith("network"):
        assert int((state.inbox_ring >= 0).sum()) > 0
        assert int(metrics["user_gossip_infected"][-1].min()) > 8
        flags = int(state.flag_ring.sum())
        assert flags > 0 if name == "network_two_buffer" else flags == 0
    if name == "seeded_cold_start":
        assert int(metrics["absent"][0].sum()) > 100
        assert int(metrics["absent"][-1].sum()) == 0


def test_swim_tick_leaves_its_input_alone_and_equals_run():
    """Later delay bins fold into the state's ring slots in place, but on
    copies: one ``swim_tick`` on the two-buffer wire (keys, flags and
    gossip bits in flight) leaves its input state as it was and gives
    what a one-round ``run`` gives."""
    name = "network_two_buffer"
    jparams, jworld, _ = CONFIGS[name]()
    params, world = port_params(jparams), port_world(jworld)
    draws = _draws(DRAW_GROUP[name])
    state, _ = swim.run(0, params, world, 12, draws=draws, device="cpu")
    assert int(state.flag_ring.sum()) > 0 and int(state.g_ring.sum()) > 0
    before = {name_: getattr(state, name_).clone()
              for name_ in STATE_FIELDS}
    want, want_metrics = swim.run(0, params, world, 1, state=state,
                                  start_round=12, draws=draws, device="cpu")
    got, metrics = swim.swim_tick(state, 12, params, world, draws(12))
    for name_, value in before.items():
        assert torch.equal(getattr(state, name_), value), name_
        assert torch.equal(getattr(got, name_), getattr(want, name_)), name_
    assert all(torch.equal(value, want_metrics[key][0])
               for key, value in metrics.items())


@pytest.mark.parametrize("dtype", [np.int32, np.int16])
def test_scatter_max_and_or_match_reference(dtype):
    """Colliding targets (most receivers hear several senders, some
    none), a third of the messages dropped."""
    rng = np.random.default_rng(4)
    s, k, f, n = 300, 6, 3, 400
    values = rng.integers(-1, 3000, (s, k)).astype(dtype)
    targets = rng.integers(0, n, (s, f)).astype(np.int32)
    drop = rng.uniform(size=(s, f)) < 0.35
    flags = rng.uniform(size=(s, k)) < 0.3
    want = jax.jit(jdelivery.scatter_max, static_argnums=3)(
        jnp.asarray(values), jnp.asarray(targets), jnp.asarray(drop), n)
    got = delivery.scatter_max(torch.from_numpy(values),
                               torch.from_numpy(targets),
                               torch.from_numpy(drop), n)
    assert got.dtype == torch.from_numpy(values).dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((got == -1).sum()) > 0 and int((got >= 0).sum()) > 0
    want = jax.jit(jdelivery.scatter_or, static_argnums=3)(
        jnp.asarray(flags), jnp.asarray(targets), jnp.asarray(drop), n)
    got = delivery.scatter_or(torch.from_numpy(flags),
                              torch.from_numpy(targets),
                              torch.from_numpy(drop), n)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_targets_and_choose_eligible_match_reference():
    """Targets from the reference's raw draws never hit the sender; the
    Gumbel argmax picks the reference's index, ties and all-ineligible
    rows included."""
    n, f = 50, 4
    key = jax.random.key(9)
    want = jprng.targets_excluding_self(key, n, n, f)
    raw = jax.random.randint(key, (n, f), 0, n - 1)
    got = prng.targets_excluding_self(torch.from_numpy(np.array(raw)),
                                      torch.arange(n, dtype=torch.int32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not bool((got == torch.arange(n)[:, None]).any())

    rng = np.random.default_rng(3)
    eligible = rng.uniform(size=(n, 12)) < 0.3
    eligible[:5] = False                    # nothing eligible: index 0
    eligible[5:8] = True
    for k_ in (key, jax.random.key(10)):
        idx, any_ = jprng.choose_eligible(k_, jnp.asarray(eligible))
        gumbel = jax.random.gumbel(k_, eligible.shape)
        got_idx, got_any = prng.choose_eligible(
            torch.from_numpy(np.array(gumbel)), torch.from_numpy(eligible))
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
        np.testing.assert_array_equal(got_any.numpy(), np.asarray(any_))
        assert (got_idx[:5] == 0).all() and not got_any[:5].any()
    # Equal scores: both argmaxes take the first.
    ties = torch.zeros((3, 5))
    assert prng.choose_eligible(ties, torch.ones((3, 5), dtype=torch.bool)
                                )[0].tolist() == [0, 0, 0]
    np.testing.assert_array_equal(
        np.asarray(jnp.argmax(jnp.zeros((3, 5)), axis=-1)), [0, 0, 0])


def test_torch_draws_take_the_scatter_fields():
    """TorchDraws follows DrawFacts under scatter: raw targets in
    [0, N - 1), Gumbel noise only known-only, the delayed proxy chains
    as [N, R, 4], bins [N, F]; a round refuses the other mode's draws."""
    jparams, jworld, _ = _network("wide")
    params, world = port_params(jparams), port_world(jworld)
    n, r, f = params.n_members, params.ping_req_members, params.fanout
    d = prng.TorchDraws(3, "cpu", params, world)(5)
    assert isinstance(d, prng.ScatterDraws)
    assert d.ping_t.shape == (n,) and d.ping_gumbel is None
    for t in (d.ping_t, d.proxies, d.gossip_t, d.sync_t):
        assert t.dtype == torch.int32
        assert 0 <= int(t.min()) and int(t.max()) < n - 1
    assert d.proxies.shape == (n, r) and d.gossip_t.shape == (n, f)
    assert d.proxy_chain_u.shape == d.proxy_chain_e.shape == (n, r, 4)
    assert d.u_direct is None and d.proxy_u is None
    assert d.gossip_e.shape == (n, f) and d.e_sync.shape == (n,)
    jparams, jworld, _ = _plain(32, None)
    params, world = port_params(jparams), port_world(jworld)
    d = prng.TorchDraws(3, "cpu", params, world)(5)
    assert d.ping_gumbel.shape == (32, 32) and d.ping_t is None
    assert bool(torch.isfinite(d.ping_gumbel).all())
    assert d.u_direct.shape == (32,) and d.proxy_u.shape == (32, 3)
    assert d.gossip_e is None and d.seed_sel is None
    shift = swim.SwimParams.from_config(fast_config(), n_members=32,
                                        delivery="shift")
    with pytest.raises(ValueError, match="ScatterDraws"):
        swim.run(0, shift, world, 1, draws=prng.TorchDraws(3, "cpu", params),
                 device="cpu")
    with pytest.raises(ValueError, match="RoundDraws"):
        swim.run(0, params, world, 1, draws=prng.TorchDraws(3, "cpu", shift),
                 device="cpu")
    # Known-only noise on a focal round is a stray field.
    focal = port_params(_plain(64, 8)[0])
    wrong = prng.TorchDraws(3, "cpu", port_params(
        _plain(64, 8, known_only=True)[0]))
    with pytest.raises(ValueError, match="ping_gumbel"):
        swim.run(0, focal, port_world(_plain(64, 8)[1]), 1, draws=wrong,
                 device="cpu")


def _port_join_rounds(seed):
    """``test_coldstart_churn.tick_join_rounds`` on the port's scatter
    round with its own draws."""
    cfg = pconfig.ClusterConfig.default_local().replace(
        gossip_interval=coldstart.ROUND_MS, ping_interval=200,
        ping_timeout=100, sync_interval=1_000, suspicion_mult=3)
    params = swim.SwimParams.from_config(cfg, n_members=coldstart.N,
                                         delivery="scatter")
    world = swim.SwimWorld.healthy(params, device="cpu").with_seeds(0)
    state = swim.initial_state(params, world, warm=False, device="cpu")
    _, m = swim.run(seed, params, world, 120, state=state, device="cpu")
    full = np.all(m["alive"].numpy() == coldstart.N - 1, axis=1)
    idx = np.flatnonzero(full)
    return float(idx[0]) if idx.size else float("inf")


def test_scatter_cold_start_join_matches_oracle():
    """The seed-hub cold-start join against the event-driven oracle, under
    ``test_cold_start_join_matches_oracle``'s bands and seed count."""
    o_runs = [coldstart.oracle_join_rounds(s)
              for s in range(coldstart.N_SEEDS)]
    t_runs = [_port_join_rounds(s) for s in range(coldstart.N_SEEDS)]
    o_med, t_med = coldstart.median(o_runs), coldstart.median(t_runs)
    assert np.isfinite(o_med), o_runs
    assert np.isfinite(t_med), t_runs
    assert abs(t_med - o_med) <= coldstart.SYNC_CYCLE + 2, (t_med, o_med,
                                                            t_runs)
    assert max(t_runs) <= 3 * coldstart.SYNC_CYCLE, t_runs
