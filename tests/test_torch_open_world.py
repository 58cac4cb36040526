"""The port's open-world plane (``SwimParams.open_world``: joins into
recycled slots, identity epochs on every wire key) against the JAX
package.

- the wire: epoch-extended keys in the three formats, their round trips
  and fold order, against the reference's ``ops/delivery``;
- the merge gate's epoch cases (``merge_inbox``) on the reference's unit
  planes and on seeded planes, guard on and off, and the merge kernel's
  plain version against the reference's ``_merge_and_timers``;
- ``epoch_bits``, the incarnation cap and the lane in every layout;
- ``SwimWorld.with_join``'s validation;
- the plane on without joins against the plane off (the port alone);
- whole runs of the reference's ``crash_join_world`` in every tick body
  and layout, both arms, on the reference's own draws, every state lane
  and metric exact, and ``node_snapshot``'s ``record_epochs``;
- ``chaos/monitor.run_monitored`` on the reference's churn storm
  (``churn_growth_scenario(seed=3, n=24)``) in both arms, every monitor
  lane and the verdict against the reference monitor's (the join codes),
  and under deadlines one round after each join (JOIN_COMPLETENESS);
- interop of the join schedule and the epoch lane, both ways, and a
  checkpoint from before the lane.

Cost: eleven reference programs, lowered one after another and
compiled in the background four at a time, at XLA's backend
optimizations off except the delayed one (whose delay sums need XLA's
default FMA fusion).
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scalecube_cluster_tpu.chaos import campaign as jcampaign  # noqa: E402
from scalecube_cluster_tpu.chaos import monitor as jmonitor  # noqa: E402
from scalecube_cluster_tpu.chaos import scenarios as jscenarios  # noqa: E402
from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu.ops import delivery as jdelivery  # noqa: E402
from scalecube_cluster_tpu.utils import checkpoint  # noqa: E402
from scalecube_cluster_tpu_torch import interop, records  # noqa: E402
from scalecube_cluster_tpu_torch.chaos import campaign  # noqa: E402
from scalecube_cluster_tpu_torch.chaos import monitor, scenarios  # noqa: E402
from scalecube_cluster_tpu_torch.kernels import merge as kmerge  # noqa: E402
from scalecube_cluster_tpu_torch.models import swim  # noqa: E402
from scalecube_cluster_tpu_torch.ops import delivery  # noqa: E402
from tests.test_swim_model import fast_config  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    STATE_FIELDS, assert_metrics_equal, assert_monitor_equal,
    assert_state_equal, jax_draws, one_torch_thread, port_monitor_spec,
    port_params, port_world)

pytestmark = pytest.mark.torchport

INT32_MAX = swim.INT32_MAX
FORMATS = ("wide", "wire24", "wire16")
LAYOUTS = {"wide": {}, "int16_wire": dict(int16_wire=True),
           "compact": dict(compact_carry=True),
           "compact_wire24": dict(compact_carry=True, wire24=True)}
# The incarnation cap each layout's wire and carry hold with the epoch
# field carved out (computed on the reference).
CAPS = {"wide": 8_388_607, "int16_wire": 2_047, "compact": 2_047,
        "compact_wire24": 32_767}
CRASH_AT, JOIN_AT, SLOT, ROUNDS = 5, 26, 3, 60
# The whole runs: name -> (n, k, params overrides, seeds).
RUNS = {
    "shift": (16, None, dict(delivery="shift"), ()),
    "scatter-focal": (24, 8, dict(delivery="scatter"), ()),
    "compact": (16, None, dict(delivery="shift", compact_carry=True), ()),
    "int16_wire": (16, None, dict(delivery="shift", int16_wire=True), ()),
    "compact-wire24": (16, None, dict(delivery="shift", compact_carry=True,
                                      wire24=True), ()),
    "k_block-planes": (16, None, dict(delivery="shift", k_block=4,
                                      dead_suppress_rounds=64, lhm_max=4,
                                      sync_interval=8), ()),
    "scatter-delay": (16, None, dict(delivery="scatter", max_delay_rounds=2,
                                     mean_delay_ms=120.0), ()),
    "scatter-seeds": (16, None, dict(delivery="scatter"), (0, 1)),
    "naive": (16, None, dict(delivery="shift", epoch_guard=False), ()),
}
# XLA's backend optimizations off: no result changes where no delay is
# summed (integers and float32 compares).
QUICK = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}
STORM_SEED, STORM_N = 3, 24


def _jrun_setup(name):
    n, k, overrides, seeds = RUNS[name]
    params = jswim.SwimParams.from_config(fast_config(), n_members=n,
                                          n_subjects=k, open_world=True,
                                          **overrides)
    world = jswim.SwimWorld.healthy(params)
    if seeds:
        world = world.with_seeds(list(seeds))
    return params, world.with_crash(SLOT, CRASH_AT).with_join(SLOT, JOIN_AT)


def _storm(guard):
    scen = jscenarios.churn_growth_scenario(seed=STORM_SEED, n=STORM_N)
    params = jcampaign.campaign_params(scen, delivery="shift",
                                       epoch_guard=guard)
    world, spec = scen.build(params)
    return scen, params, world, spec


@functools.lru_cache(maxsize=None)
def _reference_programs():
    """The reference's ``run`` of every whole run and its monitored run
    of both storm arms, lowered one after another (tracing holds the
    GIL) and compiled in the background."""
    compiling = {}
    with ThreadPoolExecutor(4) as pool:
        for name in RUNS:
            params, world = _jrun_setup(name)
            lowered = jswim.run.lower(
                jax.random.key(0), params, world, ROUNDS,
                state=jswim.initial_state(params, world), start_round=0)
            delayed = params.mean_delay_ms != 0
            compiling[name] = pool.submit(
                lowered.compile, compiler_options=None if delayed else QUICK)
        for guard in (True, False):
            scen, params, world, spec = _storm(guard)
            lowered = jmonitor.run_monitored.lower(
                jax.random.key(0), params, world, spec,
                n_rounds=scen.horizon)
            compiling[("storm", guard)] = pool.submit(
                lowered.compile, compiler_options=QUICK)
        return {name: job.result() for name, job in compiling.items()}


@functools.lru_cache(maxsize=None)
def _run_both(name):
    """One whole run on both sides, compared; returns the reference's
    params, world and final state and the port's."""
    jparams, jworld = _jrun_setup(name)
    params, world = port_params(jparams), port_world(jworld)
    jstate, jmetrics = _reference_programs()[name](
        jax.random.key(0), jworld, state=jswim.initial_state(jparams, jworld),
        start_round=0)
    state, metrics = swim.run(0, params, world, ROUNDS,
                              draws=jax_draws(jax.random.key(0), jparams,
                                              jworld), device="cpu")
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, metrics)
    return (jparams, jworld, jstate), (params, world, state)


# --------------------------------------------------------------------------
# The wire
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
def test_epoch_key_round_trip_and_order(fmt):
    """Keys of seeded records (incarnations past the cap, epochs past the
    field) equal the reference's; they unpack to the clipped record and
    epoch, carry their ALIVE flag, and fold DEAD over any epoch, a higher
    epoch over any incarnation, SUSPECT over ALIVE."""
    f, jf = delivery.WIRE_FORMATS[fmt], jdelivery.WIRE_FORMATS[fmt]
    eb = f.epoch_bits
    cap = f.inc_sat(eb)
    rng = np.random.default_rng(1)
    status = rng.integers(0, 4, 512).astype(np.int8)
    inc = rng.choice([0, 1, 5, cap - 1, cap, cap + 1, 1 << 20], 512)
    epoch = rng.integers(0, (1 << eb) + 2, 512)
    want = np.asarray(jdelivery.pack_record(status, inc, fmt=jf,
                                            epoch=epoch, epoch_bits=eb))
    key = delivery.pack_record(torch.from_numpy(status),
                               torch.from_numpy(inc), fmt=f,
                               epoch=torch.from_numpy(epoch), epoch_bits=eb)
    assert key.dtype == f.dtype and str(key.numpy().dtype) == str(want.dtype)
    np.testing.assert_array_equal(key.numpy(), want)
    for got, ref in (
            (delivery.unpack_record(key, fmt=f, epoch_bits=eb),
             jdelivery.unpack_record(want, fmt=jf, epoch_bits=eb)),
            ((delivery.unpack_epoch(key, fmt=f, epoch_bits=eb),),
             (jdelivery.unpack_epoch(want, fmt=jf, epoch_bits=eb),)),
            ((delivery.is_alive_key(key, fmt=f),),
             (jdelivery.is_alive_key(want, fmt=jf),))):
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    live = status != records.ABSENT
    np.testing.assert_array_equal(
        delivery.unpack_epoch(key, fmt=f, epoch_bits=eb).numpy()[live],
        np.minimum(epoch, f.epoch_cap())[live])

    def k(st, i, e):
        return int(delivery.pack_record(torch.tensor(st, dtype=torch.int8),
                                        torch.tensor(i), fmt=f,
                                        epoch=torch.tensor(e),
                                        epoch_bits=eb))

    assert k(records.DEAD, 0, 0) > k(records.ALIVE, 100, 1)
    assert k(records.ALIVE, 0, 1) > k(records.ALIVE, 100, 0)
    assert k(records.SUSPECT, 3, 1) > k(records.ALIVE, 3, 1)


# The reference's unit cases (tests/test_open_world.py:182-240): entry
# (status, inc, epoch), winner (status, inc, epoch), suppress, guard, and
# the expected (status, inc, epoch, changed).
UNIT_CASES = {
    "lower-dead": ((0, 0, 1), (2, 7, 0), None, True, (0, 0, 1, False)),
    "lower-alive": ((0, 0, 1), (0, 9, 0), None, True, (0, 0, 1, False)),
    "lower-suspect": ((0, 0, 1), (1, 9, 0), None, True, (0, 0, 1, False)),
    "higher-alive": ((2, 7, 0), (0, 0, 1), None, True, (0, 0, 1, True)),
    "higher-suspect": ((2, 7, 0), (1, 0, 1), None, True, (2, 7, 0, False)),
    "higher-dead": ((2, 7, 0), (2, 0, 1), None, True, (2, 7, 0, False)),
    "suppressed-same-epoch": ((2, 7, 0), (0, 9, 0), True, True,
                              (2, 7, 0, False)),
    "suppressed-higher-epoch": ((2, 7, 0), (0, 0, 1), True, True,
                                (0, 0, 1, True)),
    "same-epoch": ((0, 3, 1), (1, 3, 1), None, True, (1, 3, 1, True)),
    "guard-off": ((0, 0, 1), (2, 7, 0), None, False, (2, 7, 0, True)),
}


@pytest.mark.parametrize("case", list(UNIT_CASES))
def test_merge_gate_unit_cases(case):
    (est, einc, eep), (wst, winc, wep), supp, guard, want = UNIT_CASES[case]
    eb = delivery.WIDE.epoch_bits
    key = delivery.pack_record(torch.tensor([wst], dtype=torch.int8),
                               torch.tensor([winc]), epoch=torch.tensor([wep]),
                               epoch_bits=eb)
    got = delivery.merge_inbox(
        torch.tensor([est], dtype=torch.int8), torch.tensor([einc]), key,
        torch.tensor([True]),
        suppress=None if supp is None else torch.tensor([supp]),
        entry_epoch=torch.tensor([eep]), epoch_bits=eb, epoch_guard=guard)
    ref = jdelivery.merge_inbox(
        jnp.asarray([est], jnp.int8), jnp.asarray([einc]),
        jnp.asarray(key.numpy()), jnp.asarray([True]),
        suppress=None if supp is None else jnp.asarray([supp]),
        entry_epoch=jnp.asarray([eep]), epoch_bits=eb, epoch_guard=guard)
    assert tuple(int(g[0]) for g in got) == tuple(int(r[0]) for r in ref)
    assert tuple(int(g[0]) for g in got) == want


def _seeded_planes(fmt, n=64, k=16, seed=0):
    """Seeded entries, epochs, suppression and a winner inbox at epochs
    one below, at and one above each entry's, in ``fmt``."""
    f = delivery.WIRE_FORMATS[fmt]
    eb = f.epoch_bits
    cap = f.inc_sat(eb)
    rng = np.random.default_rng(seed)
    status = rng.integers(0, 4, (n, k)).astype(np.int8)
    inc = rng.choice([0, 1, 2, 3, cap - 1, cap], (n, k)).astype(np.int32)
    epoch = rng.integers(0, 3, (n, k)).astype(np.int32)
    win_status = rng.integers(0, 3, (n, k)).astype(np.int8)
    win_inc = np.clip(inc + rng.integers(-1, 2, (n, k)), 0, cap)
    win_ep = np.clip(epoch + rng.integers(-1, 2, (n, k)), 0, f.epoch_cap())
    inbox = delivery.pack_record(torch.from_numpy(win_status),
                                 torch.from_numpy(win_inc), fmt=f,
                                 epoch=torch.from_numpy(win_ep),
                                 epoch_bits=eb)
    inbox = torch.where(torch.from_numpy(rng.random((n, k)) < 0.15), -1,
                        inbox).to(f.dtype)
    return dict(status=status, inc=inc, epoch=epoch, inbox=inbox.numpy(),
                alive=rng.random((n, k)) < 0.5,
                suppress=(status == records.DEAD) & (rng.random((n, k)) < 0.5))


@pytest.mark.parametrize("guard", [True, False])
@pytest.mark.parametrize("fmt", FORMATS)
def test_merge_gate_seeded_planes(fmt, guard):
    """``merge_inbox`` with epochs on seeded planes, with and without the
    suppression window, equals the reference's in every output."""
    f, jf = delivery.WIRE_FORMATS[fmt], jdelivery.WIRE_FORMATS[fmt]
    p = _seeded_planes(fmt)
    for suppress in (None, p["suppress"]):
        got = delivery.merge_inbox(
            torch.from_numpy(p["status"]), torch.from_numpy(p["inc"]),
            torch.from_numpy(p["inbox"]), torch.from_numpy(p["alive"]),
            fmt=f, suppress=None if suppress is None
            else torch.from_numpy(suppress),
            entry_epoch=torch.from_numpy(p["epoch"]),
            epoch_bits=f.epoch_bits, epoch_guard=guard)
        want = jdelivery.merge_inbox(
            p["status"], p["inc"], p["inbox"], p["alive"], fmt=jf,
            suppress=suppress, entry_epoch=p["epoch"],
            epoch_bits=f.epoch_bits, epoch_guard=guard)
        for g, w in zip(got, want):
            assert str(g.numpy().dtype) == str(np.asarray(w).dtype)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("layout", ["wide", "int16_wire", "compact_wire24"])
def test_merge_kernel_plain_version_epoch_form(layout):
    """The merge kernel's plain version in its epoch form (raw lane, own
    epochs, the suppression window on) equals the reference's
    ``_merge_and_timers`` on seeded planes: every new plane, the new
    epoch lane (self cells at their own epoch, frozen rows keeping the
    pinned lane), ``self_inc`` and the refutations."""
    n, k, r = 64, 16, 37
    jparams = jswim.SwimParams.from_config(
        fast_config(), n_members=n, n_subjects=k, delivery="shift",
        open_world=True, dead_suppress_rounds=8, **LAYOUTS[layout])
    params = port_params(jparams)
    fmt = params.wire_format
    p = _seeded_planes(fmt.name, n, k, seed=2)
    rng = np.random.default_rng(3)
    own = rng.integers(0, 3, n).astype(np.int32)
    self_inc = rng.choice([0, 1, 2, CAPS[layout]], n).astype(np.int32)
    alive_here = rng.random(n) < 0.8
    spread = rng.integers(0, 2 * r, (n, k)).astype(np.int32)
    deadline = rng.choice([INT32_MAX, r - 1, r, r + 1, r + 5],
                          (n, k)).astype(np.int32)
    jworld = jswim.SwimWorld.healthy(jparams)
    is_self = np.arange(k)[None, :] == np.asarray(jworld.slot_of_node)[:, None]
    status = np.where(is_self, records.ALIVE, p["status"]).astype(np.int8)
    inc = np.where(is_self, self_inc[:, None], p["inc"]).astype(np.int32)
    jstate = dataclasses.replace(
        jswim.initial_state(jparams, jworld), spread_until=spread,
        suspect_deadline=deadline, self_inc=self_inc)
    jstate = dataclasses.replace(jstate, inc=jnp.asarray(
        jstate.inc).astype(jnp.int32), epoch=jnp.asarray(p["epoch"]))
    pinned = np.where(is_self, own[:, None], p["epoch"])
    new, refuted = jswim._merge_and_timers(
        jstate, status, inc, p["inbox"], p["alive"], r, jparams,
        jswim.Knobs.from_params(jparams), jworld,
        jnp.arange(n, dtype=jnp.int32), alive_here, is_self,
        epoch=pinned, own_epoch=own)
    args = (*(torch.from_numpy(x) for x in (status, inc, spread, deadline,
                                            p["inbox"], p["alive"], self_inc,
                                            alive_here)),
            torch.tensor(np.asarray(jworld.slot_of_node)), r,
            params.suspicion_rounds, params.periods_to_spread,
            swim._wire_inc_sat(params))
    epochs = dict(epoch=torch.from_numpy(p["epoch"]),
                  own_epoch=torch.from_numpy(own))
    got = kmerge.merge_and_timers_reference(*args, fmt=fmt,
                                            dead_suppress_rounds=8, **epochs)
    want = (new.status, new.inc, new.spread_until, new.suspect_deadline,
            new.self_inc, refuted, new.epoch)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[5].any()) and (got[6].numpy() != pinned).any()
    # The wrapper takes the epoch form's two arguments together and, on
    # CPU tensors, gives the plain version's results.
    with pytest.raises(ValueError, match="own_epoch"):
        kmerge.merge_and_timers(*args, fmt=fmt, epoch=epochs["epoch"])
    wrapped = kmerge.merge_and_timers(*args, fmt=fmt, dead_suppress_rounds=8,
                                      **epochs)
    assert all(torch.equal(g, w) for g, w in zip(wrapped, got))


# --------------------------------------------------------------------------
# Params, lane and schedule
# --------------------------------------------------------------------------


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_epoch_bits_cap_and_lane_in_every_layout(layout):
    for guard in (True, False):
        jparams = jswim.SwimParams.from_config(
            fast_config(), n_members=16, delivery="shift", open_world=True,
            epoch_guard=guard, **LAYOUTS[layout])
        params = port_params(jparams)
        assert params.epoch_bits == jparams.epoch_bits
        assert swim._wire_inc_sat(params) == jswim._wire_inc_sat(jparams)
        if guard:
            assert swim._wire_inc_sat(params) == CAPS[layout]
        else:
            assert params.epoch_bits == 0
        lane = swim.initial_epoch(params, "cpu")
        want = np.asarray(jswim.initial_epoch(jparams))
        assert lane.shape == want.shape
        assert str(lane.numpy().dtype) == str(want.dtype)


@pytest.mark.parametrize("case", ["live", "early", "revived", "valid"])
def test_with_join_validation(case):
    """The reference's three refusals, and a valid join's schedule equal
    to the reference's (the join round ends the old down window)."""
    jparams = jswim.SwimParams.from_config(fast_config(), n_members=16,
                                           delivery="shift", open_world=True)
    jworld = jswim.SwimWorld.healthy(jparams)
    world = swim.SwimWorld.healthy(port_params(jparams), device="cpu")
    setups = {"live": lambda w: w,
              "early": lambda w: w.with_crash(SLOT, 30),
              "revived": lambda w: w.with_crash(SLOT, 5, 20),
              "valid": lambda w: w.with_leave(SLOT, 5)}
    jworld, world = setups[case](jworld), setups[case](world)
    if case != "valid":
        match = {"live": "no scheduled death", "early": "strictly after",
                 "revived": "revive the old"}[case]
        with pytest.raises(ValueError, match=match):
            world.with_join(SLOT, JOIN_AT)
        with pytest.raises(ValueError):
            jworld.with_join(SLOT, JOIN_AT)
        return
    jworld, world = jworld.with_join(SLOT, JOIN_AT), world.with_join(
        SLOT, JOIN_AT)
    for name in ("down_from", "down_until", "leave_at", "join_at"):
        np.testing.assert_array_equal(getattr(world, name).numpy(),
                                      np.asarray(getattr(jworld, name)))
    for r in (JOIN_AT - 1, JOIN_AT, JOIN_AT + 1):
        np.testing.assert_array_equal(world.epoch_at(r).numpy(),
                                      np.asarray(jworld.epoch_at(r)))
        np.testing.assert_array_equal(world.joining_at(r).numpy(),
                                      np.asarray(jworld.joining_at(r)))
    assert {r: rows.tolist() for r, rows in world.join_rows().items()} == \
        {JOIN_AT: [SLOT]}


@pytest.mark.parametrize("name", ["shift", "scatter-focal", "compact",
                                  "int16_wire", "k_block"])
def test_plane_on_without_joins_equals_plane_off(name):
    """With the plane on and no join scheduled, a run with a crash and a
    leave equals the plane-off run in every lane but ``epoch``, which
    stays 0, on the same draws (the plane takes none of its own)."""
    n, k, overrides, _ = RUNS.get(name, (16, None, dict(
        delivery="shift", k_block=4), ()))
    runs = []
    for open_world in (False, True):
        params = swim.SwimParams.from_config(
            fast_config(), n_members=n, n_subjects=k, open_world=open_world,
            **overrides)
        world = swim.SwimWorld.healthy(params, device="cpu").with_crash(
            1, 6).with_leave(2, 9)
        runs.append(swim.run(0, params, world, 32, device="cpu") + (params,))
    (off, m_off, _), (on, m_on, p_on) = runs
    for field in STATE_FIELDS:
        if field != "epoch":
            assert torch.equal(getattr(off, field), getattr(on, field)), field
    for metric, value in m_off.items():
        assert torch.equal(value, m_on[metric]), metric
    assert on.epoch.shape == (n, k or n) and not bool(on.epoch.any())
    assert on.epoch.dtype == (torch.int16 if p_on.compact_carry
                              else torch.int32)


# --------------------------------------------------------------------------
# Whole runs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(RUNS))
def test_crash_join_run_matches_reference(name):
    """Slot 3 crashed at round 5 and joined by a new identity at round
    26: both sides on the reference's draws, every state lane and metric
    exact after 60 rounds.  Guarded, every live observer has admitted the
    new identity (epoch 1) by then; the naive arm runs without a lane."""
    (jparams, jworld, jstate), (params, world, state) = _run_both(name)
    if name == "naive":
        assert state.epoch.shape[1] == 0
        return
    col = SLOT if params.full_view else int(
        world.slot_of_node[SLOT])
    assert bool((state.epoch[:, col] == 1).all())
    if name == "scatter-seeds":
        assert int((state.status[SLOT] == records.ALIVE).sum()) >= 14


@pytest.mark.parametrize("name", ["shift", "compact", "naive"])
def test_node_snapshot_record_epochs(name):
    """``node_snapshot`` of the joiner's and another row equals the
    reference's: ``record_epochs`` with the guard on, none without."""
    (jparams, jworld, jstate), (params, world, state) = _run_both(name)
    for node in (0, SLOT):
        want = jswim.node_snapshot(jstate, jparams, jworld, node,
                                   round_idx=ROUNDS)
        got = swim.node_snapshot(state, params, world, node,
                                 round_idx=ROUNDS)
        assert got == want
        assert ("record_epochs" in got) == (name != "naive")


@pytest.mark.parametrize("guard", [True, False])
def test_join_codes_match_reference_monitor(guard):
    """The churn storm at n = 24 (scares, three crash waves, nine joins
    mid-suspicion) in both arms: the port's ``run_monitored`` equals the
    reference's (state, metrics, every monitor lane, count, dropped, code
    counts and first rounds, the verdict), and the join deadlines follow
    the reference's rule.  The guard holds both join codes at zero; the
    naive arm resurrects."""
    scen, jparams, jworld, spec = _storm(guard)
    jstate, mon, jmetrics = _reference_programs()[("storm", guard)](
        jax.random.key(0), jworld, spec)
    params, world = port_params(jparams), port_world(jworld)
    disruptions = [d for d in (op.disruption(scen.n_members, scen.horizon)
                               for op in scen.ops) if d is not None]
    known_by, check = monitor.join_deadlines(
        params, world, disruption_end=max(d[1] for d in disruptions))
    np.testing.assert_array_equal(known_by.numpy(),
                                  np.asarray(spec.join_known_by))
    assert check == spec.check_joins
    draws = jax_draws(jax.random.key(0), jparams, jworld)
    state, port_mon, metrics = monitor.run_monitored(
        0, params, world, port_monitor_spec(spec), scen.horizon,
        draws=draws, device="cpu")
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, metrics)
    assert_monitor_equal(mon, port_mon)
    codes = monitor.verdict(port_mon)["codes"]
    totals = {name: codes[name]["violations"]
              for name in ("NO_RESURRECTION", "JOIN_COMPLETENESS")}
    if guard:
        assert set(totals.values()) == {0}
    else:
        assert totals["NO_RESURRECTION"] > 0


def test_join_completeness_trips_before_a_join_is_known():
    """The guard arm's storm under a spec whose join deadlines fall one
    round after each join: eligible observers cannot know a joiner yet,
    so JOIN_COMPLETENESS trips, and the port's ``run_monitored`` (the
    same reference program, the spec being data) equals the reference's
    monitor field for field."""
    scen, jparams, jworld, spec = _storm(True)
    join_at = np.asarray(jworld.join_at)[np.asarray(jworld.subject_ids)]
    early = np.where(join_at < INT32_MAX, join_at + 1, INT32_MAX)
    spec = dataclasses.replace(spec,
                               join_known_by=jnp.asarray(early, jnp.int32))
    jstate, mon, jmetrics = _reference_programs()[("storm", True)](
        jax.random.key(0), jworld, spec)
    params, world = port_params(jparams), port_world(jworld)
    state, port_mon, metrics = monitor.run_monitored(
        0, params, world, port_monitor_spec(spec), scen.horizon,
        draws=jax_draws(jax.random.key(0), jparams, jworld), device="cpu")
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, metrics)
    assert_monitor_equal(mon, port_mon)
    code = monitor.InvariantCode.JOIN_COMPLETENESS
    assert int(port_mon.code_counts[code]) > 0
    assert {v.code for v in monitor.decode_violations(port_mon)} >= {code}


def test_storm_world_is_the_reference_churn_storm():
    """The port's ``chaos.churn_growth_scenario(seed=3, n=24)`` built by
    its DSL equals the reference's (scenario, params, every world field
    with the padded link rules, the monitor spec); and
    ``chip_smoke.storm_world``, which builds the storm for the card at
    1M x 16 (pools drawn from the focal subjects), at full view draws
    its pools from every member as the reference does: at n = 24 its
    world, joins and horizon are the scenario's."""
    import chip_smoke

    scen, jparams, jworld, spec = _storm(True)
    port_scen = scenarios.churn_growth_scenario(seed=STORM_SEED, n=STORM_N)
    assert repr(port_scen) == repr(scen)
    params = campaign.campaign_params(port_scen, delivery="shift")
    assert params == port_params(jparams)
    built, port_spec = port_scen.build(params, device="cpu")
    want = port_world(jworld)
    for name in ("down_from", "down_until", "leave_at", "join_at",
                 "partition_of", "subject_ids", "slot_of_node"):
        np.testing.assert_array_equal(getattr(built, name).numpy(),
                                      getattr(want, name).numpy(),
                                      err_msg=name)
    for name in swim.LinkFaults.ARRAYS:
        np.testing.assert_array_equal(getattr(built.faults, name).numpy(),
                                      getattr(want.faults, name).numpy(),
                                      err_msg=name)
    assert built.faults.n_rules == 8
    ref_spec = port_monitor_spec(spec)
    for name in ("complete_by", "join_known_by"):
        np.testing.assert_array_equal(getattr(port_spec, name).numpy(),
                                      getattr(ref_spec, name).numpy())
    assert (port_spec.agree_from, port_spec.check_agreement,
            port_spec.check_false_suspicion, port_spec.check_joins) == (
        ref_spec.agree_from, ref_spec.check_agreement,
        ref_spec.check_false_suspicion, ref_spec.check_joins)
    world, horizon, disruption_end, joins = chip_smoke.storm_world(
        chip_smoke.storm_params(STORM_N, STORM_N), "cpu", STORM_SEED)
    assert horizon == scen.horizon
    for name in ("down_from", "down_until", "leave_at", "join_at"):
        np.testing.assert_array_equal(getattr(world, name).numpy(),
                                      np.asarray(getattr(jworld, name)))
    rules = world.faults.n_rules
    for name in swim.LinkFaults.ARRAYS:
        np.testing.assert_array_equal(
            getattr(world.faults, name).numpy(),
            np.asarray(getattr(jworld.faults, name))[:rules])
    assert not np.asarray(jworld.faults.src_hi)[rules:].any()
    known_by, _ = monitor.join_deadlines(port_params(jparams), world,
                                         disruption_end)
    np.testing.assert_array_equal(known_by.numpy(),
                                  np.asarray(spec.join_known_by))
    assert sorted(joins) == sorted(
        (int(s), int(r)) for s, r in enumerate(np.asarray(jworld.join_at))
        if r < INT32_MAX)


# --------------------------------------------------------------------------
# Interop
# --------------------------------------------------------------------------


@pytest.mark.parametrize("compact", [False, True])
def test_join_schedule_and_epoch_lane_convert_both_ways(compact):
    """A reference world's join schedule and a reference state's epoch
    lane (in its layout's dtype) come across, and the port's state goes
    back through ``interop.state_to_arrays`` to the reference's
    ``checkpoint.state_from_arrays`` field for field."""
    jparams, jworld = _jrun_setup("compact" if compact else "shift")
    world = port_world(jworld)
    np.testing.assert_array_equal(world.join_at.numpy(),
                                  np.asarray(jworld.join_at))
    params = port_params(jparams)
    lane = np.random.default_rng(4).integers(0, 3, (16, 16))
    jstate = dataclasses.replace(
        jswim.initial_state(jparams, jworld),
        epoch=jnp.asarray(lane, jnp.int16 if compact else jnp.int32))
    state = interop.state_from_arrays(checkpoint.state_to_arrays(jstate),
                                      device="cpu", params=params)
    swim.check_lanes(state, params)
    np.testing.assert_array_equal(state.epoch.numpy(), lane)
    back = checkpoint.state_from_arrays(
        {name[len("state/"):]: value
         for name, value in interop.state_to_arrays(state).items()})
    for field in dataclasses.fields(jstate):
        want = np.asarray(getattr(jstate, field.name))
        got = np.asarray(getattr(back, field.name))
        assert got.dtype == want.dtype and got.shape == want.shape, field.name
        np.testing.assert_array_equal(got, want, err_msg=field.name)


@pytest.mark.parametrize("compact", [False, True])
def test_pre_epoch_checkpoint_loads_as_zero_epochs(compact):
    """A checkpoint without the epoch lane loads with zero epochs in the
    carry's dtype under open-world params, and zero-size without, as the
    reference's ``checkpoint.state_from_arrays`` does."""
    jparams = jswim.SwimParams.from_config(fast_config(), n_members=12,
                                           delivery="shift",
                                           compact_carry=compact)
    arrays = checkpoint.state_to_arrays(
        jswim.initial_state(jparams, jswim.SwimWorld.healthy(jparams)))
    del arrays["state/epoch"]
    off = interop.state_from_arrays(arrays, device="cpu",
                                    params=port_params(jparams))
    assert off.epoch.shape == (12, 0) and off.epoch.dtype == torch.int32
    on = port_params(dataclasses.replace(jparams, open_world=True))
    state = interop.state_from_arrays(arrays, device="cpu", params=on)
    swim.check_lanes(state, on)
    assert state.epoch.shape == (12, 12) and not bool(state.epoch.any())
    assert state.epoch.dtype == (torch.int16 if compact else torch.int32)
    want = jswim.SwimParams(**dataclasses.asdict(on))
    ref = checkpoint.state_from_arrays(
        {name[len("state/"):]: value for name, value in arrays.items()},
        params=want)
    assert str(state.epoch.numpy().dtype) == str(np.asarray(ref.epoch).dtype)
