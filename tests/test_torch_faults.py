"""The port's network model against the JAX package: link-fault rules,
delivery delays, seed-gated joins and user gossips on the shift round.

Whole runs: JAX ``swim.run(key, ...)`` and the port's ``run(...,
draws=jax_draws(key, params, world))`` on the same params and world;
every ``SwimState`` lane (the delay rings and user-gossip lanes too) and
every stacked metric must be equal.  Configurations:

- focal 64 x 8, a delayed brownout (the reference's own
  ``chaos.Brownout``, six rule windows) and a two-way block of node 5
  (eight rules), ``mean_delay_ms=50``, a 4-slot ring and two user
  gossips, in the wide, ``int16_wire`` and ``compact_carry`` +
  ``wire24`` layouts;
- focal 64 x 8 with loss-only rules and no ring: any rule makes the
  delay non-``None``, which switches the FD chains to per-hop draws;
- full view 16 x 16, a seeded cold start (seeds 0, 1, 2) with one
  block, a 3-slot ring at ``mean_delay_ms=150``.

Unit cases hold ``link_eval``, the ring ops, the delayed ``_chain_ok``
and ``LinkFaults.add`` against the reference's own functions, and a
delayed, seeded checkpoint crosses over and resumes.

Exact equality throughout.  The only float arithmetic is float32: loss
compares of identical uniforms, products and sums of identical unit
exponentials with identical per-link means, and one division.  The
reference's programs are compiled with XLA's default optimizations, as
``swim.run`` compiles them: XLA:CPU then fuses the delay sum into
``fma`` (which the port emulates); with most optimizations disabled it
does not, and the sums differ.

Cost: the five reference programs are most of it (about 34 s of
lowering and compiling, serially): each is lowered in turn, the
cheapest first, and compiled in a background thread from the moment it
is lowered; the brownout runs one proxy and two gossip channels, which
shrinks its three programs by 40 % (the other two configurations keep
three of each); its three layouts share one set of draws.
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scalecube_cluster_tpu.chaos.scenarios import Brownout  # noqa: E402
from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu.ops import ring as jring  # noqa: E402
from scalecube_cluster_tpu.utils import checkpoint  # noqa: E402
from scalecube_cluster_tpu_torch import interop  # noqa: E402
from scalecube_cluster_tpu_torch.models import swim  # noqa: E402
from scalecube_cluster_tpu_torch.ops import prng  # noqa: E402
from scalecube_cluster_tpu_torch.ops import ring  # noqa: E402
from tests.test_swim_model import fast_config  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402
    STATE_FIELDS, assert_metrics_equal, assert_state_equal, jax_draws,
    one_torch_thread, port_params, port_world)

pytestmark = pytest.mark.torchport

ROUNDS = 32
INT32_MAX = 2**31 - 1
LAYOUTS = {"wide": {}, "int16_wire": dict(int16_wire=True),
           "compact_wire24": dict(compact_carry=True, wire24=True)}


def _brownout(layout):
    # One proxy and two gossip channels keep the three reference programs
    # small (each rule is unrolled into every link evaluation); the other
    # configurations run three proxies and three channels.
    params = jswim.SwimParams.from_config(
        fast_config().replace(suspicion_mult=1), n_members=64, n_subjects=8,
        loss_probability=0.05, mean_delay_ms=50.0, max_delay_rounds=3,
        n_user_gossips=2, delivery="shift", ping_req_members=1, fanout=2,
        **LAYOUTS[layout])
    world = Brownout(src=(0, 6), dst=(6, 64), peak_loss=0.5, from_round=4,
                     ramp_rounds=6, hold_rounds=4, steps=3,
                     peak_delay_ms=400.0).apply(
        jswim.SwimWorld.healthy(params), 64, ROUNDS)
    world = (world.with_block(5, (0, 64), 14, 24)
             .with_block((0, 64), 5, 14, 24)
             .with_crash(3, at_round=2, until_round=26)
             .with_spread(0, 7, 3).with_spread(1, 40, 9))
    return params, world, True


def _loss_only():
    params = jswim.SwimParams.from_config(
        fast_config().replace(suspicion_mult=1), n_members=64, n_subjects=8,
        loss_probability=0.05, delivery="shift")
    world = (jswim.SwimWorld.healthy(params)
             .with_link_fault((0, 20), (20, 64), 0.4, from_round=3,
                              until_round=20)
             .with_block(9, (0, 64), 8, 16)
             .with_crash(3, at_round=2))
    return params, world, True


def _seeded_cold_start():
    params = jswim.SwimParams.from_config(
        fast_config(), n_members=16, loss_probability=0.05,
        mean_delay_ms=150.0, max_delay_rounds=2, delivery="shift")
    world = (jswim.SwimWorld.healthy(params).with_seeds([0, 1, 2])
             .with_block(5, (0, 16), 10, 22))
    return params, world, False


CONFIGS = {
    "seeded_cold_start": _seeded_cold_start,
    "loss_only_rules_no_ring": _loss_only,
    **{f"brownout_{layout}": functools.partial(_brownout, layout)
       for layout in LAYOUTS},
}
# Configurations that share their draws (same shapes and draw facts).
DRAW_GROUP = {name: ("brownout" if name.startswith("brownout") else name)
              for name in CONFIGS}


@functools.lru_cache(maxsize=None)
def _reference_programs():
    """JAX's ``run`` over ROUNDS rounds for every configuration, keyed by
    name: lowered one after another (tracing holds the GIL), each
    compiled in the background from the moment it is lowered."""
    compiling = {}
    with ThreadPoolExecutor(len(CONFIGS)) as pool:
        for name, make in CONFIGS.items():
            params, world, warm = make()
            compiling[name] = pool.submit(jswim.run.lower(
                jax.random.key(0), params, world, ROUNDS,
                state=jswim.initial_state(params, world, warm=warm),
                start_round=0).compile)
        return {name: job.result() for name, job in compiling.items()}


@functools.lru_cache(maxsize=None)
def _draws(group):
    """One draw group's reference draws, built once and kept per round."""
    name = next(n for n, g in DRAW_GROUP.items() if g == group)
    params, world, _ = CONFIGS[name]()
    return functools.lru_cache(maxsize=None)(
        jax_draws(jax.random.key(0), params, world))


def _jax_run(name, state=None, start_round=0):
    params, world, warm = CONFIGS[name]()
    if state is None:
        state = jswim.initial_state(params, world, warm=warm)
    return _reference_programs()[name](jax.random.key(0), world,
                                       state=state, start_round=start_round)


def _port_run(name, state=None, start_round=0):
    params, world, warm = CONFIGS[name]()
    pparams, pworld = port_params(params), port_world(world)
    if state is None:
        state = swim.initial_state(pparams, pworld, warm=warm, device="cpu")
    return swim.run(0, pparams, pworld, ROUNDS, state=state,
                    start_round=start_round, draws=_draws(DRAW_GROUP[name]),
                    device="cpu")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_network_run_matches_reference(name):
    jparams, jworld, warm = CONFIGS[name]()
    assert_state_equal(
        jswim.initial_state(jparams, jworld, warm=warm),
        swim.initial_state(port_params(jparams), port_world(jworld),
                           warm=warm, device="cpu"))
    jstate, jmetrics = _jax_run(name)
    state, metrics = _port_run(name)
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, metrics)
    # The window holds what the configuration was built for.
    if name.startswith("brownout"):
        assert int((state.inbox_ring >= 0).sum()) > 0
        assert int(metrics["suspect"][:, 3].max()) > 0
        assert int(metrics["user_gossip_infected"][-1].min()) > 8
    if name == "loss_only_rules_no_ring":
        assert state.inbox_ring.shape[0] == 0
        assert int(metrics["suspect"][:, 3].max()) > 0
    if name == "seeded_cold_start":
        assert int(metrics["absent"][0].sum()) > 100
        assert int(metrics["absent"][-1].sum()) == 0


def test_torch_draws_take_the_network_fields():
    """TorchDraws follows DrawFacts: delayed chains and delay bins under a
    rule, seed draws in full view with seeds, none of them otherwise."""
    jparams, jworld, _ = _brownout("wide")
    params, world = port_params(jparams), port_world(jworld)
    d = prng.TorchDraws(3, "cpu", params, world)(5)
    n, r, f = params.n_members, params.ping_req_members, params.fanout
    assert d.u_direct is None and d.u_proxy is None
    assert d.chain_u_direct.shape == d.chain_e_direct.shape == (n, 2)
    assert d.chain_u_proxy.shape == d.chain_e_proxy.shape == (r, n, 4)
    assert d.e_gossip.shape == (f, n) and d.e_sync.shape == (n,)
    assert float(d.chain_e_proxy.min()) >= 0.0 and d.seed_sel is None
    # Loss-only rules: per-hop chain draws, but no ring and no bins.
    jparams, jworld, _ = _loss_only()
    params, world = port_params(jparams), port_world(jworld)
    d = prng.TorchDraws(3, "cpu", params, world)(5)
    assert d.chain_u_direct.shape == (n, 2) and d.e_gossip is None
    plain = prng.TorchDraws(3, "cpu", params)(5)
    assert plain.chain_u_direct is None and plain.u_direct.shape == (n,)
    jparams, jworld, _ = _seeded_cold_start()
    params, world = port_params(jparams), port_world(jworld)
    d = prng.TorchDraws(3, "cpu", params, world)(5)
    assert d.seed_push_u.shape == d.seed_ack_u.shape == (3, 16)
    assert d.seed_sel.dtype == torch.int32
    assert 0 <= int(d.seed_sel.min()) and int(d.seed_sel.max()) < 3
    with pytest.raises(ValueError, match="seed_sel"):
        swim.run(0, params, world, 1, draws=prng.TorchDraws(3, "cpu", params),
                 device="cpu")


def test_link_eval_matches_reference():
    """Random overlapping rules (ranges, windows, losses, delays): the
    last matching rule wins, the default elsewhere, at rounds inside and
    around the windows; delay None exactly when statically zero."""
    rng = np.random.default_rng(7)
    jfaults, pfaults = jswim.LinkFaults.none(), swim.LinkFaults.none()
    for _ in range(12):
        s_lo, d_lo = rng.integers(0, 40, 2)
        args = ((int(s_lo), int(s_lo + rng.integers(1, 30))),
                (int(d_lo), int(d_lo + rng.integers(1, 30))),
                float(rng.choice([0.0, 1.0, rng.uniform()])),
                float(rng.choice([0.0, rng.uniform(0, 500)])),
                int(rng.integers(0, 10)), int(rng.integers(10, 20)))
        jfaults, pfaults = jfaults.add(*args), pfaults.add(*args)
    src = rng.integers(0, 64, 500).astype(np.int32)
    dst = rng.integers(0, 64, 500).astype(np.int32)
    ref = jax.jit(jswim.link_eval)
    for round_idx in (0, 5, 9, 10, 15, 19, 20):
        for default in ((0.05, 0.0), (0.0, 120.0)):
            want = ref(jfaults, jnp.int32(round_idx), src, dst, *default)
            got = swim.link_eval(pfaults, round_idx, torch.from_numpy(src),
                                 torch.from_numpy(dst), *default)
            for g, w in zip(got, want):
                assert g.dtype == torch.float32
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # A scalar destination broadcasts (the seed exchange's links).
    got = swim.link_eval(pfaults, 12, torch.from_numpy(src),
                         torch.tensor(17, dtype=torch.int32), 0.05, 0.0)
    want = ref(jfaults, jnp.int32(12), src, jnp.int32(17), 0.05, 0.0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    none = swim.LinkFaults.none()
    ids = torch.arange(4, dtype=torch.int32)
    assert swim.link_eval(none, 3, ids, ids, 0.1, 0.0)[1] is None
    assert jswim.link_eval(jswim.LinkFaults.none(), 3, jnp.arange(4),
                           jnp.arange(4), 0.1, 0.0)[1] is None
    np.testing.assert_array_equal(
        swim.link_eval(none, 3, ids, ids, 0.1, 40.0)[1].numpy(),
        np.full(4, 40.0, np.float32))


def test_ring_ops_match_reference():
    """delay_bins from the same unit exponentials (one float32 product,
    one true division, the clamp), and open/push on one slot."""
    key = jax.random.key(5)
    mean = np.random.default_rng(1).uniform(0, 500, 20000).astype(np.float32)
    want = jax.jit(jring.delay_bins, static_argnums=(2, 3, 4))(
        key, jnp.asarray(mean), 100.0, 3, (20000,))
    e = jax.jit(lambda k: -jnp.log1p(-jax.random.uniform(k, (20000,))))(key)
    got = ring.delay_bins(torch.from_numpy(np.array(e)),
                          torch.from_numpy(mean), 100.0, 3)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(np.unique(got.numpy())) == {0, 1, 2, 3}

    rng = np.random.default_rng(2)
    keys = rng.integers(-1, 50, (3, 6, 4)).astype(np.int16)
    flags = rng.integers(0, 2, (3, 6, 4)).astype(np.int8)
    values = rng.integers(-1, 50, (6, 4)).astype(np.int16)
    bits = rng.integers(0, 2, (6, 4)).astype(np.int8)
    jnow, jkeys = jring.open_slot(jnp.asarray(keys), 1, jnp.int16(-1))
    jkeys = jring.push_max(jkeys, 2, jnp.asarray(values))
    jflags = jring.push_or(jnp.asarray(flags), 0, jnp.asarray(bits))
    pkeys, pflags = torch.from_numpy(keys), torch.from_numpy(flags)
    now = ring.open_slot(pkeys, 1, -1)
    ring.push_max(pkeys, 2, torch.from_numpy(values))
    ring.push_or(pflags, 0, torch.from_numpy(bits))
    for g, w in ((now, jnow), (pkeys, jkeys), (pflags, jflags)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_delayed_chain_ok_matches_reference():
    """Four hops with per-element losses, delay means and budgets: the
    per-hop loss compares and the fused delay sum equal the reference's
    jitted ``_chain_ok`` at budgets on both sides of every sum, where a
    plain float32 multiply-then-add would differ."""
    m, h = 20000, 4
    rng = np.random.default_rng(0)
    losses = [rng.uniform(0, 0.3, m).astype(np.float32) for _ in range(h)]
    means = [rng.uniform(0, 400, m).astype(np.float32) for _ in range(h)]
    key = jax.random.key(3)
    u = np.array(jax.random.uniform(key, (m, 2 * h)))
    e = np.array(jax.jit(lambda x: -jnp.log1p(-x))(u[:, h:]))
    fused = np.zeros(m, np.float32)
    plain = np.zeros(m, np.float32)
    for j in range(h):
        fused = (e[:, j].astype(np.float64) * means[j] + fused).astype(
            np.float32)
        plain = plain + e[:, j] * means[j]
    assert int((fused != plain).sum()) > 1000
    ref = jax.jit(jswim._chain_ok, static_argnums=(4,))
    for budget in (fused, np.nextafter(fused, -np.inf, dtype=np.float32),
                   plain, np.nextafter(plain, -np.inf, dtype=np.float32)):
        want = np.asarray(ref(key, [jnp.asarray(x) for x in losses],
                              [jnp.asarray(x) for x in means],
                              jnp.asarray(budget), (m,)))
        got = swim._chain_ok(
            torch.from_numpy(u[:, :h].copy()), torch.from_numpy(e),
            [torch.from_numpy(x) for x in losses],
            [torch.from_numpy(x) for x in means], torch.from_numpy(budget))
        np.testing.assert_array_equal(got.numpy(), want)


def _xla_fma(e, mean, total):
    """The reference's delay-sum step, ``total + e * mean`` in float32,
    jitted on XLA:CPU at its default optimizations (as ``_chain_ok``
    compiles inside ``swim.run``)."""
    return np.asarray(jax.jit(lambda a, b, c: c + a * b)(e, mean, total))


def test_fma32_rounds_once():
    """The witness of a sum whose float64 value lands on a float32
    midpoint it did not start on: e * mean = 2^-24 - 2^-54 above
    1 + 2^-23 rounds down to 1 + 2^-23 in one rounding, and up to
    1 + 2^-22 through float64 first."""
    e = np.float32(32767 * 2.0**-27)
    mean = np.float32(32769 * 2.0**-27)
    total = np.float32(1 + 2.0**-23)
    want = _xla_fma(e, mean, total)
    assert want == np.float32(1 + 2.0**-23)
    assert np.float32(np.float64(e) * np.float64(mean)
                      + np.float64(total)) == np.float32(1 + 2.0**-22)
    got = swim._fma32(*(torch.tensor([x]) for x in (e, mean, total)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), [want])


def test_fma32_matches_xla_near_midpoints():
    """Triples whose exact sum lies on a float32 midpoint, or a little
    below one (closer than half a float64 ulp, or farther), among plain
    triples: the port's ``_fma32`` equals XLA:CPU's fused sum on every
    one.  The product (x - y)(x + y) = x^2 - y^2 with x = s * 2^17 (s
    odd) puts x^2 * c at s^2 / 2 float32 ulps of ``total``, a midpoint,
    and y^2 * c below it."""
    rng = np.random.default_rng(11)
    m = 4000
    total = rng.uniform(0.5, 600.0, m).astype(np.float32)
    x = (rng.integers(0, 64, m) * 2 + 1) * 2**17
    y = rng.choice([0, 1, 2, 3, 4, 5, 7, 20], m)
    c = np.spacing(total).astype(np.float64) * 2.0**-35
    e = ((x - y) * 2.0**-22).astype(np.float32)
    mean = ((x + y) * c * 2.0**22).astype(np.float32)
    plain = rng.uniform(size=m) < 0.2
    e = np.where(plain, rng.uniform(0, 4, m).astype(np.float32), e)
    mean = np.where(plain, rng.uniform(0, 400, m).astype(np.float32), mean)
    want = _xla_fma(e, mean, total)
    twice = (e.astype(np.float64) * mean + total).astype(np.float32)
    assert int((twice != want).sum()) > 500       # the cases that matter
    got = swim._fma32(torch.from_numpy(e), torch.from_numpy(mean),
                      torch.from_numpy(total))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("args,match", [
    (((0, 4), 5, 1.5), "loss must be a probability"),
    (((0, 4), 5, -0.1), "loss must be a probability"),
    (((0, 4), 5, 0.5, -1.0), "delay_ms must be non-negative"),
    (((4, 4), 5, 0.5), "empty id range"),
    ((0, (9, 3), 0.5), "empty id range"),
    ((0, 5, 0.5, 0.0, 10, 10), "inverted round window"),
])
def test_link_faults_add_validation(args, match):
    """The reference's errors, message for message; a valid rule
    appends."""
    with pytest.raises(ValueError, match=match) as got:
        swim.LinkFaults.none().add(*args)
    with pytest.raises(ValueError) as want:
        jswim.LinkFaults.none().add(*args)
    assert str(got.value) == str(want.value)
    faults = swim.LinkFaults.none().add((0, 4), 5, 0.5, 20.0, 3, 9)
    assert faults.n_rules == 1 and faults.loss.dtype == torch.float32
    assert [int(faults.dst_lo[0]), int(faults.dst_hi[0])] == [5, 6]


def test_port_resumes_a_delayed_seeded_checkpoint(tmp_path):
    """A JAX seeded cold start with a delay ring and a block,
    checkpointed at round ROUNDS with messages in flight, resumes in the
    port (its ring lanes from the checkpoint, its world carried over)
    and matches JAX's own continuation."""
    name = "seeded_cold_start"
    half, _ = _jax_run(name)
    path = str(tmp_path / "delayed.npz")
    checkpoint.save(path, half, ROUNDS, key=jax.random.key(0),
                    meta={"run": name})
    jparams, _, _ = CONFIGS[name]()
    state, next_round, _, meta = interop.load_jax_checkpoint(
        path, device="cpu", params=port_params(jparams))
    assert (next_round, meta) == (ROUNDS, {"run": name})
    assert state.inbox_ring.shape == (3, 16, 16)
    assert int((state.inbox_ring >= 0).sum()) > 0
    want, want_metrics = _jax_run(name, state=half, start_round=ROUNDS)
    got, metrics = _port_run(name, state=state, start_round=ROUNDS)
    assert_state_equal(want, got)
    assert_metrics_equal(want_metrics, metrics)
    assert set(STATE_FIELDS) == {f.name for f in dataclasses.fields(got)}


def test_run_and_swim_tick_leave_their_input_state_alone():
    """A round updates the delay rings in place, but on copies: ``run``
    and ``swim_tick`` leave the state they are given as it was, and one
    ``swim_tick`` gives what a one-round ``run`` gives."""
    name = "seeded_cold_start"
    jparams, jworld, _ = CONFIGS[name]()
    params, world = port_params(jparams), port_world(jworld)
    draws = _draws(DRAW_GROUP[name])
    state, _ = _port_run(name)
    assert int((state.inbox_ring >= 0).sum()) > 0
    before = {f.name: getattr(state, f.name).clone()
              for f in dataclasses.fields(state)}
    want, want_metrics = swim.run(0, params, world, 1, state=state,
                                  start_round=ROUNDS, draws=draws,
                                  device="cpu")
    got, metrics = swim.swim_tick(state, ROUNDS, params, world,
                                  draws(ROUNDS))
    for name_, value in before.items():
        assert torch.equal(getattr(state, name_), value), name_
        assert torch.equal(getattr(got, name_), getattr(want, name_)), name_
    assert all(torch.equal(value, want_metrics[key][0])
               for key, value in metrics.items())
