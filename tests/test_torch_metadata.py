"""The port's metadata KV plane (``models/metadata.py``,
``SwimParams.metadata_keys``) against the JAX package.

- the packed word and its LWW order, and ``merge``'s gates (the window,
  the epoch gate, the self pin, frozen rows) function to function on the
  reference's unit planes and on seeded planes;
- the params' validation and ``with_metadata_push``'s, against the
  reference's;
- the plane on in a quiet world against the plane off (the port alone:
  the plane takes no draws), shift and scatter in the four layouts;
- whole runs on the reference's own draws, every state lane (``md`` and
  ``md_spread`` among them) and metric (``metadata_divergent``) exact,
  and ``divergence_probe`` / ``member_converged`` against the
  reference's: pushes reaching every observer (a second push winning, a
  crashed owner writing nothing, a key past ``metadata_keys`` writing
  nothing) in shift and scatter and the narrow layouts; the quiesced
  heal converging only with the exchange (the control in shift); the
  suppression window
  keeping a dead owner's words and its versions resuming; a join
  resetting the joiner's row (compact open world); delays on, md
  same-round only;
- ``bench.py --rollout --smoke``'s geometry (N = 24, 2 stages of 2
  owners) run whole through ``chip_smoke.rollout_gated``, both arms.

Cost: thirteen reference programs, lowered one after another and
compiled in the background four at a time, at XLA's backend
optimizations off except the two delayed ones (whose delay sums need
XLA's default FMA fusion).

The pushes and the rollout smoke are held in
``tests/test_torch_metadata_runs.py``, the heals, suppression and join
in ``tests/test_torch_metadata_heals.py``, on the runs and programs
defined here.
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scalecube_cluster_tpu.chaos import scenarios as jscenarios  # noqa: E402
from scalecube_cluster_tpu.models import metadata as jmetadata  # noqa: E402
from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu_torch.models import metadata, swim  # noqa: E402
from tests.test_swim_model import fast_config  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    assert_metrics_equal, assert_state_equal, jax_draws, one_torch_thread,
    port_params, port_world)
from tests.torch_rollout_reference import reference_rollout  # noqa: E402

pytestmark = pytest.mark.torchport

LAYOUTS = {"wide": {}, "int16_wire": dict(int16_wire=True),
           "compact": dict(compact_carry=True),
           "compact_wire24": dict(compact_carry=True, wire24=True)}
# XLA's backend optimizations off: no result changes where no delay is
# summed (integers and float32 compares).
QUICK = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}
# The push world (n = 16, two keys, the exchange every 4 rounds): node 3
# pushes once, node 5 twice to one cell (the second wins), node 6 is
# crashed before its push, node 9 pushes a key past metadata_keys.
PUSHES = ((3, 0, 641, 4), (5, 1, 900, 3), (5, 1, 17, 8), (6, 0, 99, 4),
          (9, 5, 1, 6))
PUSH_RUNS = {
    "shift": dict(delivery="shift"),
    "scatter": dict(delivery="scatter"),
    "shift-compact": dict(delivery="shift", compact_carry=True),
    "scatter-two-buffer-int16": dict(delivery="scatter", fused_wire=False,
                                     int16_wire=True),
    "shift-delay": dict(delivery="shift", max_delay_rounds=2,
                        mean_delay_ms=120.0),
    "scatter-delay": dict(delivery="scatter", max_delay_rounds=2,
                          mean_delay_ms=120.0),
}
HEAL_N = 24
SUPPRESS = 24
JOIN_SLOT, JOIN_CRASH, JOIN_AT = 3, 10, 30
SMOKE_N = 24


def _push_params(n, delivery="shift", sync_interval=4, **overrides):
    return jswim.SwimParams.from_config(
        fast_config(), n_members=n, delivery=delivery, sync_every=0,
        sync_interval=sync_interval, metadata_keys=1, **overrides)


def _bound(params):
    return jscenarios.metadata_convergence_bound(params, params.n_members)


def _pushed(world, pushes):
    for node, key, value, at in pushes:
        world = world.with_metadata_push(node, key, value, at)
    return world


def _setup(name):
    """``(params, world, rounds)`` of a whole run, the reference's."""
    kind, _, rest = name.partition(":")
    if kind == "push":
        params = dataclasses.replace(_push_params(16, **PUSH_RUNS[rest]),
                                     metadata_keys=2)
        world = _pushed(jswim.SwimWorld.healthy(params).with_crash(6, 0),
                        PUSHES)
        rounds = 40 if "delay" in rest else 8 + _bound(params)
        return params, world, rounds
    if kind == "heal":
        # tests/test_metadata_plane.py's quiesced heal: a push inside the
        # split goes cold long before the heal.
        delivery, arm = rest.split("-")
        params = _push_params(HEAL_N, delivery,
                              sync_interval=8 if arm == "on" else 0)
        on = dataclasses.replace(params, sync_interval=8)
        phase = -(-jscenarios.quiesce_bound(on, HEAL_N) // 16) * 16
        part = np.zeros((4, HEAL_N), np.int8)
        part[0, :HEAL_N // 2] = 1
        world = jswim.SwimWorld.healthy(params).with_partition_schedule(
            part, phase).with_metadata_push(0, key=0, value=321, at_round=8)
        return params, world, phase + _bound(on)
    if kind == "suppress":
        # tests/test_metadata_plane.py's window: the owner crashed past
        # its first push's convergence, revived past the window, pushing
        # again.
        params = _push_params(16, dead_suppress_rounds=SUPPRESS)
        bound = _bound(params)
        crash_at, revive_at = 8 + bound, 8 + bound + 40
        world = (jswim.SwimWorld.healthy(params)
                 .with_metadata_push(2, key=0, value=555, at_round=4)
                 .with_crash(2, at_round=crash_at, until_round=revive_at)
                 .with_metadata_push(2, key=0, value=777,
                                     at_round=revive_at + 8))
        return params, world, revive_at + 8 + bound
    if kind == "join":
        # The slot's first identity pushes, dies and is replaced; the new
        # identity pushes at epoch 1.
        params = _push_params(16, open_world=True, compact_carry=True)
        world = _pushed(
            jswim.SwimWorld.healthy(params)
            .with_crash(JOIN_SLOT, JOIN_CRASH).with_join(JOIN_SLOT, JOIN_AT),
            ((JOIN_SLOT, 0, 5, 2), (7, 0, 8, 2), (JOIN_SLOT, 0, 6,
                                                  JOIN_AT + 4)))
        return params, world, JOIN_AT + 4 + _bound(params)
    if kind == "smoke":
        # bench.py --rollout --smoke: N = 24, 2 stages of 2 owners, as
        # Scenario.build pads it: eight match-nothing link rules, so the
        # rounds take the per-hop FD chains and their draws.
        scen, params, world, _, _, _ = reference_rollout(
            SMOKE_N, n_stages=2, stage_size=2,
            sync_interval=8 if rest == "gated" else 0)
        return params, world, scen.horizon
    raise KeyError(name)


NAMES = ([f"push:{run}" for run in PUSH_RUNS]
         + ["heal:shift-on", "heal:shift-control", "heal:scatter-on",
            "suppress:", "join:", "smoke:gated", "smoke:control"])


# The whole runs of each file that compiles them
# (tests/test_torch_metadata_runs.py, test_torch_metadata_heals.py).
PUSH_FILE = tuple(n for n in NAMES if n.startswith(("push:", "smoke:")))
HEAL_FILE = tuple(n for n in NAMES if n not in PUSH_FILE)


@functools.lru_cache(maxsize=None)
def _reference_programs(names):
    """The reference's ``run`` of the whole runs ``names``, lowered one
    after another (tracing holds the GIL) and compiled in the
    background."""
    compiling = {}
    with ThreadPoolExecutor(4) as pool:
        for name in names:
            params, world, rounds = _setup(name)
            lowered = jswim.run.lower(
                jax.random.key(0), params, world, rounds,
                state=jswim.initial_state(params, world), start_round=0)
            delayed = params.mean_delay_ms != 0
            compiling[name] = pool.submit(
                lowered.compile, compiler_options=None if delayed else QUICK)
        return {name: job.result() for name, job in compiling.items()}


def _file_of(name):
    return PUSH_FILE if name in PUSH_FILE else HEAL_FILE


@functools.lru_cache(maxsize=None)
def _run_both(name):
    """One whole run on both sides, compared (the reference's programs
    compiled for its file's runs); returns the reference's ``(params,
    world, state)``, the port's, and the round count."""
    jparams, jworld, rounds = _setup(name)
    params, world = port_params(jparams), port_world(jworld)
    jstate, jmetrics = _reference_programs(_file_of(name))[name](
        jax.random.key(0), jworld, state=jswim.initial_state(jparams, jworld),
        start_round=0)
    state, metrics = swim.run(0, params, world, rounds,
                              draws=jax_draws(jax.random.key(0), jparams,
                                              jworld), device="cpu")
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, metrics)
    return (jparams, jworld, jstate), (params, world, state), metrics, rounds


def _probes_match(ref, port, rounds):
    """The port's divergence probe and member_converged equal the
    reference's at ``rounds``; returns the probe."""
    (jparams, jworld, jstate), (params, world, state) = ref, port
    div = int(metadata.divergence_probe(state, params, world, rounds))
    assert div == int(jmetadata.divergence_probe(jstate, jparams, jworld,
                                                 rounds))
    np.testing.assert_array_equal(
        metadata.member_converged(state, params, world, rounds).numpy(),
        np.asarray(jmetadata.member_converged(jstate, jparams, jworld,
                                              rounds)))
    return div


def _cells(state, owner, key=0):
    """Every observer's (value, version) of ``owner``'s cell ``key``."""
    words = state.md[:, owner, key]
    return (metadata.word_value(words).tolist(),
            metadata.word_version(words).tolist())


# --------------------------------------------------------------------------
# The word and the merge
# --------------------------------------------------------------------------


def test_word_packing_round_trip_and_lww_order():
    """Packed words equal the reference's (the epoch masked to 7 bits),
    unpack to their fields, keep the sign bit clear, and order a newer
    version above any value of an older one."""
    rng = np.random.default_rng(0)
    ep = np.concatenate([[0, 3, 127, 130], rng.integers(0, 300, 60)])
    ver = np.concatenate([[0, 1, 16383, 7], rng.integers(0, 16384, 60)])
    val = np.concatenate([[0, 1023, 512, 9], rng.integers(0, 1024, 60)])
    want = np.asarray(jmetadata.pack_word(ep, ver, val))
    word = metadata.pack_word(torch.from_numpy(ep), torch.from_numpy(ver),
                              torch.from_numpy(val))
    assert word.dtype == torch.int32
    np.testing.assert_array_equal(word.numpy(), want)
    assert bool((word >= 0).all())
    for got, ref in ((metadata.word_epoch, jmetadata.word_epoch),
                     (metadata.word_version, jmetadata.word_version),
                     (metadata.word_value, jmetadata.word_value)):
        np.testing.assert_array_equal(got(word).numpy(),
                                      np.asarray(ref(want)))
    np.testing.assert_array_equal(metadata.word_epoch(word).numpy(), ep & 127)
    assert int(metadata.pack_word(1, 4, 0)) > int(metadata.pack_word(1, 3,
                                                                     1023))


def _merge_inputs(case):
    """The reference's unit planes (tests/test_metadata_plane.py:147-240)
    or seeded ones: ``(md, md_spread, arrivals, round, is_self, belief,
    frozen)`` as numpy arrays."""
    n, m = 4, 1
    md = np.zeros((n, n, m), np.int32)
    arr = np.zeros((n, n, m), np.int32)
    spread = np.zeros((n, n), np.int32)
    is_self = np.zeros((n, n), bool)
    belief = np.zeros((n, n), np.int32)
    frozen = np.zeros(n, bool)

    def w(e, v, x):
        return int(jmetadata.pack_word(e, v, x))

    if case == "window":
        md[0, 2, 0], arr[0, 2, 0], arr[1, 2, 0] = w(0, 2, 5), w(0, 3, 1), \
            w(0, 1, 9)
    elif case == "epoch-gate":
        md[0, 2, 0] = arr[0, 2, 0] = w(0, 9, 7)
        arr[1, 2, 0] = w(1, 1, 3)
        belief[:2, 2] = 1
    elif case == "self-pin":
        arr[1, 1, 0] = w(0, 5, 5)
        is_self = np.eye(n, dtype=bool)
    elif case == "frozen":
        spread[:] = 7
        arr[2, 0, 0] = arr[3, 0, 0] = w(0, 4, 8)
        frozen[2] = True
    else:
        rng = np.random.default_rng(1)
        n, m = 24, 3

        def words(p):
            word = jmetadata.pack_word(rng.integers(0, 3, (n, n, m)),
                                       rng.integers(0, 6, (n, n, m)),
                                       rng.integers(0, 1024, (n, n, m)))
            return np.where(rng.random((n, n, m)) < p, np.asarray(word), 0)

        md, arr = words(0.6).astype(np.int32), words(0.5).astype(np.int32)
        arr = np.where(rng.random((n, n, m)) < 0.2, -1, arr).astype(np.int32)
        spread = rng.integers(0, 40, (n, n)).astype(np.int32)
        is_self = np.eye(n, dtype=bool)
        belief = rng.integers(0, 3, (n, n)).astype(np.int32)
        frozen = rng.random(n) < 0.25
    return md, spread, arr.reshape(n, n * m), 10, is_self, belief, frozen


@pytest.mark.parametrize("guard", [True, False])
@pytest.mark.parametrize("case", ["window", "epoch-gate", "self-pin",
                                  "frozen", "seeded"])
def test_merge_matches_reference(case, guard):
    """``merge`` equals the reference's on each gate's planes, with the
    epoch guard on (the belief gates) and off (the belief is not read):
    the words, the windows of improved rows, frozen rows kept."""
    jparams = jswim.SwimParams.from_config(
        fast_config(), n_members=4, delivery="shift", open_world=guard,
        metadata_keys=1)
    params = port_params(jparams)
    md, spread, arr, r, is_self, belief, frozen = _merge_inputs(case)
    want = jmetadata.merge(jnp.asarray(md), jnp.asarray(spread),
                           jnp.asarray(arr), jnp.int32(r), jparams,
                           jnp.asarray(is_self), jnp.asarray(belief),
                           jnp.asarray(frozen))
    got = metadata.merge(*(torch.from_numpy(x) for x in (md, spread, arr)),
                         r, params, torch.from_numpy(is_self),
                         torch.from_numpy(belief), torch.from_numpy(frozen))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "window":
        assert int(got[1][0, 2]) == int(got[1][1, 2]) == \
            r + 1 + params.periods_to_spread and int(got[1][0, 0]) == 0
    if case == "epoch-gate" and guard:
        assert int(got[0][0, 2, 0]) == 0          # dropped and zeroed
        assert int(metadata.word_value(got[0][1, 2, 0])) == 3
    if case == "frozen":
        assert int(got[0][2, 0, 0]) == 0 and int(got[1][2, 0]) == 7


# --------------------------------------------------------------------------
# Params, world, lanes
# --------------------------------------------------------------------------


def test_params_and_push_validation_match_reference():
    """A negative key count, focal shapes and ``k_block`` raise the
    reference's errors; ``with_metadata_push`` refuses what the
    reference refuses and appends the schedule it appends."""
    base = dict(n_members=8, delivery="shift")
    for overrides, match in ((dict(metadata_keys=-1), "metadata_keys"),
                             (dict(metadata_keys=1, k_block=4), "k_block"),
                             (dict(metadata_keys=1, n_subjects=4,
                                   delivery="scatter"), "full view")):
        kwargs = dict(base, **overrides)
        with pytest.raises(ValueError, match=match):
            swim.SwimParams.from_config(fast_config(), **kwargs)
        with pytest.raises(ValueError, match=match):
            jswim.SwimParams.from_config(fast_config(), **kwargs)
    jparams = _push_params(8)
    jworld = jswim.SwimWorld.healthy(jparams)
    world = swim.SwimWorld.healthy(port_params(jparams), device="cpu")
    for args, match in ((([1, 2], 0, 1, 0), "ONE push"),
                        ((1, -1, 1, 0), "key"), ((1, 0, 1024, 0), "value"),
                        ((1, 0, 1, -1), "at_round"), ((8, 0, 1, 0), "range")):
        with pytest.raises(ValueError, match=match):
            world.with_metadata_push(*args)
        with pytest.raises(ValueError):
            jworld.with_metadata_push(*args)
    pushes = ((3, 0, 641, 4), (5, 1, 7, 4), (3, 0, 9, 2))
    jworld, world = _pushed(jworld, pushes), _pushed(world, pushes)
    for name in swim.SwimWorld.PUSH_FIELDS:
        np.testing.assert_array_equal(getattr(world, name).numpy(),
                                      np.asarray(getattr(jworld, name)))
    assert world.push_rows() == {4: ((3, 0, 641), (5, 1, 7)),
                                 2: ((3, 0, 9),)}


@pytest.mark.parametrize("keys", [0, 2])
def test_lanes_match_reference(keys):
    """The fresh state's md lanes have the reference's shapes and dtypes,
    zero-size with the plane off, in both carry layouts."""
    for layout in ("wide", "compact"):
        jparams = dataclasses.replace(
            jswim.SwimParams.from_config(fast_config(), n_members=12,
                                         delivery="shift", **LAYOUTS[layout]),
            metadata_keys=keys)
        jstate = jswim.initial_state(jparams,
                                     jswim.SwimWorld.healthy(jparams))
        params = port_params(jparams)
        state = swim.initial_state(
            params, swim.SwimWorld.healthy(params, device="cpu"),
            device="cpu")
        for lane in ("md", "md_spread"):
            got, want = getattr(state, lane), np.asarray(getattr(jstate,
                                                                 lane))
            assert tuple(got.shape) == want.shape, lane
            assert str(got.numpy().dtype) == str(want.dtype), lane
        swim.check_lanes(state, params)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("delivery", ["shift", "scatter"])
def test_quiet_world_equals_plane_off(delivery, layout):
    """With the plane on and no push, a run with a crash and a partition
    equals the plane-off run in every lane but the md lanes, which stay
    0, and in every metric, plus ``metadata_divergent`` at 0, on the same
    draws (the plane takes none of its own)."""
    runs = []
    for keys in (0, 2):
        params = swim.SwimParams.from_config(
            fast_config(), n_members=24, delivery=delivery, sync_interval=4,
            metadata_keys=keys, **LAYOUTS[layout])
        part = torch.zeros((2, 24), dtype=torch.int8)
        part[0, :12] = 1
        world = swim.SwimWorld.healthy(params, device="cpu").with_crash(
            1, 6).with_partition_schedule(part, 12)
        runs.append(swim.run(0, params, world, 24, device="cpu"))
    (off, m_off), (on, m_on) = runs
    for field in dataclasses.fields(swim.SwimState):
        if field.name not in ("md", "md_spread"):
            assert torch.equal(getattr(off, field.name),
                               getattr(on, field.name)), field.name
    assert set(m_on) == set(m_off) | {"metadata_divergent"}
    for name, value in m_off.items():
        assert torch.equal(value, m_on[name]), name
    assert not bool(m_on["metadata_divergent"].any())
    assert on.md.shape == (24, 24, 2) and not bool(on.md.any())
    assert off.md.shape == (24, 0, 0)


# --------------------------------------------------------------------------
# Whole runs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [48, 16_384])
def test_rollout_world_is_the_reference_scenario(n):
    """``chip_smoke.rollout_world`` builds ``bench.py --rollout``'s
    scenario with the port's DSL (``chaos/scenarios.Scenario.build``):
    every world field (crash windows, partition schedule, push schedule,
    the eight match-nothing link rules), the monitor spec and the horizon
    equal the reference's ``Scenario.build`` at the bench's N = 48 and at
    the card's 16,384."""
    import chip_smoke

    scen, jparams, jworld, _, heal_at, bound = reference_rollout(n)
    world, geo = chip_smoke.rollout_world(n, "cpu")
    assert (geo["horizon"], geo["heal_at"], geo["bound"]) == (
        scen.horizon, heal_at, bound)
    want = port_world(jworld)
    names = ("down_from", "down_until", "leave_at", "partition_of",
             "join_at", "subject_ids", "slot_of_node",
             *swim.SwimWorld.PUSH_FIELDS)
    for name in names:
        np.testing.assert_array_equal(getattr(world, name).numpy(),
                                      getattr(want, name).numpy(),
                                      err_msg=name)
    for name in swim.LinkFaults.ARRAYS:
        got = getattr(world.faults, name)
        assert got.dtype == getattr(want.faults, name).dtype, name
        np.testing.assert_array_equal(got.numpy(),
                                      getattr(want.faults, name).numpy(),
                                      err_msg=name)
    assert world.faults.n_rules == 8
    assert not np.asarray(jworld.faults.src_hi).any()   # match-nothing rules
    assert world.partition_phase_rounds == int(jworld.partition_phase_rounds)
    assert chip_smoke.rollout_params(n) == port_params(jparams)
    _, params, _, spec, _ = chip_smoke.rollout_scenario(n)
    jspec = scen.build(jparams)[1]
    np.testing.assert_array_equal(spec.complete_by.numpy(),
                                  np.asarray(jspec.complete_by))
    assert (spec.agree_from, spec.check_agreement,
            spec.check_false_suspicion) == (
        int(jspec.agree_from), jspec.check_agreement,
        jspec.check_false_suspicion)
