"""The port's narrow layouts against the JAX package: ``int16_wire``,
``compact_carry`` and ``compact_carry`` + ``wire24`` on the shift round.

Whole runs: JAX ``swim.run(key, ...)`` and the port's ``run(...,
draws=<the same draws>)`` on focal 256 x 16 (healthy, crash/revive,
leave and partition worlds) and full view 48 x 48 (crash/revive and
partition); every ``SwimState`` field (in the layout's own dtypes) and
every stacked metric must be equal.  The codec's and the merge instances' plain versions are held
against the reference's ``_carry_decode`` / ``_carry_encode`` /
``_merge_and_timers`` on seeded edge-case planes.  Exact equality
throughout: states and metrics are integers, and the only float
operations compare identical float32 draws with float32 probabilities.

Cost: the reference's six programs (layout x shape) are most of it.
Every world of a (layout, shape) pair shares one program (the worlds all
carry a two-phase partition schedule and an explicit initial state); each
of the six goes to a compile thread as soon as it is lowered, so that
XLA's compiles (which release the GIL) run while the next program is
lowered (which holds it); and the module compiles them with most XLA
optimizations off, about twice as fast at these sizes and changing no
result (integer arithmetic, float32 compares without fast math).  Each
shape's draws are built once.

The whole runs are held in ``tests/test_torch_narrow_runs_int16.py``,
``..._compact.py`` and ``..._wire24.py``, one file a layout, on the
worlds and programs defined here.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu_torch.kernels import LAUNCHES  # noqa: E402
from scalecube_cluster_tpu_torch.kernels import carry, merge  # noqa: E402
from scalecube_cluster_tpu_torch.models import swim  # noqa: E402
from scalecube_cluster_tpu_torch.ops import delivery  # noqa: E402
from tests.test_swim_model import fast_config  # noqa: E402
from tests.test_torch_merge import make_planes, port_args  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402
    assert_metrics_equal, assert_state_equal, jax_draws, one_torch_thread,
    port_params, port_world)

pytestmark = pytest.mark.torchport

ROUNDS = 24
LAYOUTS = {
    "int16_wire": dict(int16_wire=True),
    "compact": dict(compact_carry=True),
    "compact_wire24": dict(compact_carry=True, wire24=True),
}
SHAPES = {"focal_256x16": (256, 16), "full_view_48": (48, None)}
# Every world on the focal shape; the full view repeats the two that
# exercise the most (refutation after a revive, a healed partition).
WORLDS = {"focal_256x16": ("healthy", "crash", "leave", "partition"),
          "full_view_48": ("crash", "partition")}
# Carry dtypes (inc, spread_until, suspect_deadline) and wire dtype.
CARRY = {"int16_wire": (torch.int32, torch.int32, torch.int32),
         "compact": (torch.int16, torch.int8, torch.int16),
         "compact_wire24": (torch.int16, torch.int8, torch.int16)}
WIRE = {"int16_wire": torch.int16, "compact": torch.int16,
        "compact_wire24": torch.int32}
INT32_MAX = 2**31 - 1


@pytest.fixture(autouse=True, scope="module")
def quick_reference_compiles():
    previous = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", previous)


def _jparams(layout, shape):
    # suspicion_mult=1 brings SUSPECT -> DEAD inside the 24 rounds.
    n, k = SHAPES[shape]
    return jswim.SwimParams.from_config(
        fast_config().replace(suspicion_mult=1), n_members=n, n_subjects=k,
        loss_probability=0.05, delivery="shift", **LAYOUTS[layout])


def _jworld(params, world):
    n = params.n_members
    split = (np.arange(n) >= n // 2).astype(np.int8)
    phases = np.stack([split if world == "partition" else
                       np.zeros(n, np.int8), np.zeros(n, np.int8)])
    w = jswim.SwimWorld.healthy(params).with_partition_schedule(
        phases, phase_rounds=12)
    if world == "crash":
        w = w.with_crash(3, at_round=2, until_round=18)
    if world == "leave":
        w = w.with_leave(5, at_round=8)
    return w


@functools.lru_cache(maxsize=None)
def _draws(shape):
    """One shape's reference draws, built once and kept per round (the
    draws depend on N, the proxies and the fanout, not on the layout)."""
    make = jax_draws(jax.random.key(0), _jparams("compact", shape))
    return functools.lru_cache(maxsize=None)(make)


@functools.lru_cache(maxsize=None)
def _reference_program(params):
    """JAX's ``run`` over ROUNDS rounds for one (layout, shape)'s
    params."""
    world = _jworld(params, "healthy")
    return jswim.run.lower(jax.random.key(0), params, world, ROUNDS,
                           state=jswim.initial_state(params, world),
                           start_round=0).compile()


def _jax_run(params, world, state=None, start_round=0):
    if state is None:
        state = jswim.initial_state(params, world)
    return _reference_program(params)(jax.random.key(0), world, state=state,
                                      start_round=start_round)


def _port_run(jparams, jworld, shape, rounds=ROUNDS, state=None,
              start_round=0):
    return swim.run(0, port_params(jparams), port_world(jworld), rounds,
                    state=state, start_round=start_round,
                    draws=_draws(shape), device="cpu")


def _carry_dtypes(state):
    return (state.inc.dtype, state.spread_until.dtype,
            state.suspect_deadline.dtype)


# Whole runs, one file a layout (tests/test_torch_narrow_runs_*.py).
RUN_CASES = [(shape, world) for shape in sorted(SHAPES)
             for world in WORLDS[shape]]


def check_run(layout, shape, world):
    """One layout's whole run of ``world`` at ``shape`` on both sides:
    every lane, the carry dtypes, the metrics and the decoded timers."""
    jparams = _jparams(layout, shape)
    jworld = _jworld(jparams, world)
    jstate, jmetrics = _jax_run(jparams, jworld)
    state, metrics = _port_run(jparams, jworld, shape)
    assert _carry_dtypes(state) == CARRY[layout]
    assert state.status.dtype == torch.int8
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, metrics)
    for got, want in zip(
            swim._wide_timer_fields(state, port_params(jparams), ROUNDS),
            jswim._wide_timer_fields(jstate, jparams, ROUNDS)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if world == "crash":
        assert int(metrics["dead"][:, 3].max()) > 0
        assert int(metrics["refutations"].sum()) > 0
    if world == "leave":
        assert int(metrics["dead"][:, 5].max()) > 0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_swim_tick_steps_as_run_does(layout):
    """``swim_tick`` (decode, round, encode) gives what ``run`` gives over
    the same rounds, carry dtypes included."""
    params = port_params(_jparams(layout, "full_view_48"))
    world = swim.SwimWorld.healthy(params, device="cpu").with_crash(
        2, at_round=1)
    draws = _draws("full_view_48")
    want, want_metrics = swim.run(0, params, world, 4, draws=draws,
                                  device="cpu")
    state = swim.initial_state(params, world, device="cpu")
    for round_idx in range(4):
        state, metrics = swim.swim_tick(state, round_idx, params, world,
                                        draws(round_idx))
    for name in ("status", "inc", "spread_until", "suspect_deadline",
                 "self_inc"):
        assert torch.equal(getattr(state, name), getattr(want, name)), name
    assert all(torch.equal(value, want_metrics[name][-1])
               for name, value in metrics.items())
    assert _carry_dtypes(state) == CARRY[layout]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_wire_buffers_and_inbox_carry_the_wire_dtype(layout, monkeypatch):
    """The payload, FD inbox, folded inbox and carry keep the layout's
    dtypes through a run (no silent promotion back to int32/int64)."""
    seen = {}

    def spy(name, fn, pick):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen.setdefault(name, set()).add(pick(args, kwargs, out))
            return out
        monkeypatch.setattr(swim if name != "inbox" else swim.merge_kernel,
                            fn.__name__, wrapped)

    spy("payload", swim._send_components, lambda a, k, out: out[0].dtype)
    spy("fd_inbox", swim._fd_phase, lambda a, k, out: out["fd_inbox"].dtype)
    spy("inbox", swim.merge_kernel.merge_and_timers,
        lambda a, k, out: a[4].dtype)
    spy("carry", swim._carry_encode if layout != "int16_wire"
        else swim._merge_and_timers,
        lambda a, k, out: _carry_dtypes(out if isinstance(out, swim.SwimState)
                                        else out[0]))
    params = port_params(_jparams(layout, "full_view_48"))
    world = swim.SwimWorld.healthy(params, device="cpu").with_crash(
        2, at_round=1)
    swim.run(1, params, world, 6, device="cpu")
    assert seen == {"payload": {WIRE[layout]}, "fd_inbox": {WIRE[layout]},
                    "inbox": {WIRE[layout]}, "carry": {CARRY[layout]}}


# ---- the codec and the merge instances ------------------------------------

def _wide_planes(n, k, seed, round_idx):
    """Decoded-carry planes with the codec's edges: no timer, deadlines
    due, stale (negative remaining, also past -32766), far ahead (beyond
    32766 remaining), spreads below the cursor and beyond 127 ahead,
    incarnations above the cap."""
    rng = np.random.default_rng(seed)
    nxt = round_idx + 1
    deadline = rng.choice(np.array(
        [INT32_MAX, nxt, nxt - 1, nxt - 500, nxt - 32766, nxt - 40000,
         nxt + 1, nxt + 32765, nxt + 32766, nxt + 32767, nxt + 90000]),
        (n, k)).astype(np.int32)
    spread = (nxt + rng.integers(-300, 300, (n, k))).astype(np.int32)
    inc = rng.choice(np.array([0, 1, 7, 8190, 8191, 8192, 32766, 32767,
                               40000]), (n, k)).astype(np.int32)
    return inc, spread, deadline


@pytest.mark.parametrize("round_idx", [0, 37, 2**31 - 40])
@pytest.mark.parametrize("inc_sat", [8191, 32767])
def test_carry_codec_matches_reference(round_idx, inc_sat):
    inc, spread, deadline = _wide_planes(48, 48, round_idx % 97, round_idx)
    jparams = _jparams("compact", "full_view_48")
    wide = dataclasses.replace(
        jswim.initial_state(jparams, jswim.SwimWorld.healthy(jparams)),
        inc=jnp.asarray(inc), spread_until=jnp.asarray(spread),
        suspect_deadline=jnp.asarray(deadline))
    r = jnp.int32(np.int32(round_idx))
    want = jswim._carry_encode(wide, r, inc_sat=inc_sat)
    got = carry.carry_encode(*(torch.from_numpy(a) for a in
                               (inc, spread, deadline)), round_idx, inc_sat)
    for name, g in zip(("inc", "spread_until", "suspect_deadline"), got):
        w = np.asarray(getattr(want, name))
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    # Decode what was encoded, at the next round's cursor.
    want_d = jswim._carry_decode(want, r + 1)
    got_d = carry.carry_decode(*got, round_idx + 1)
    for name, g in zip(("inc", "spread_until", "suspect_deadline"), got_d):
        w = np.asarray(getattr(want_d, name))
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert (got[2] == carry.DEADLINE_NONE16).any() and (got[2] < 0).any()
    assert (got[1] == 0).any() and (got[1] == 127).any()


def test_codec_wrappers_take_plain_version_on_cpu_and_check_inputs():
    inc, spread, deadline = (torch.from_numpy(a)
                             for a in _wide_planes(8, 4, 0, 9))
    before = dict(LAUNCHES)
    got = carry.carry_encode(inc, spread, deadline, 9, 8191)
    want = carry.carry_encode_reference(inc, spread, deadline, 9, 8191)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert dict(LAUNCHES) == before
    with pytest.raises(TypeError, match="inc"):
        carry.carry_decode(inc, got[1], got[2], 9)
    with pytest.raises(ValueError, match="suspect_deadline"):
        carry.carry_decode(got[0], got[1], got[2][:, :-1].contiguous(), 9)


@pytest.mark.parametrize("col0", [0, 8, 16])
def test_codec_block_form_on_column_views(col0):
    """Decode from, and encode into, an [N, 8] column view of a [48, 24]
    compact carry (row stride 24): the block equals the whole-plane
    codec's columns, and encode leaves the carry's other columns as they
    were."""
    kb, round_idx = 8, 37
    wide = tuple(torch.from_numpy(a)
                 for a in _wide_planes(48, 24, 3 + col0, round_idx))
    compact = carry.carry_encode(*wide, round_idx, 8191)
    blk = slice(col0, col0 + kb)
    views = tuple(t[:, blk] for t in compact)
    assert not views[0].is_contiguous()
    got = carry.carry_decode(*views, round_idx + 1)
    want = carry.carry_decode(*compact, round_idx + 1)
    for g, w in zip(got, want):
        assert g.is_contiguous() and torch.equal(g, w[:, blk])
    target = tuple(torch.full_like(t, -5) for t in compact)
    outs = carry.carry_encode(*(t[:, blk].contiguous() for t in wide),
                              round_idx, 8191,
                              out=tuple(t[:, blk] for t in target))
    for o, tgt, c in zip(outs, target, compact):
        assert o.data_ptr() == tgt[:, blk].data_ptr()
        assert torch.equal(tgt[:, blk], c[:, blk])
        rest = torch.ones(tgt.shape[1], dtype=torch.bool)
        rest[blk] = False
        assert bool((tgt[:, rest] == -5).all())
    with pytest.raises(ValueError, match="row strides differ"):
        carry.carry_decode(views[0], views[1].contiguous(), views[2], 1)


# The reference merge, compiled once per layout (eagerly it compiles
# op by op, several times slower).
_jax_merge = jax.jit(jswim._merge_and_timers, static_argnums=(6,))


def _narrow_inbox(inbox, fmt):
    """Re-pack the wide test inbox keys in ``fmt``."""
    status, inc = delivery.unpack_record(torch.from_numpy(inbox))
    return delivery.pack_record(status, inc, fmt=fmt).numpy()


@pytest.mark.parametrize("layout,cap", [("int16_wire", 8191),
                                        ("compact_wire24", 32767)])
@pytest.mark.parametrize("seed", [5, 6])
def test_merge_instance_matches_reference(layout, cap, seed):
    """The merge on the narrow wire (inbox in the format's dtype, bump
    clamped at the layout's cap), against the reference's
    ``_merge_and_timers`` on the same seeded 64 x 16 planes
    (``test_torch_merge.make_planes``), incarnations at the cap."""
    n, k = 64, 16
    planes = make_planes(n, k, seed)
    for name in ("inc", "self_inc"):
        planes[name] = np.minimum(planes[name], cap).astype(np.int32)
    jparams = jswim.SwimParams.from_config(
        fast_config(), n_members=n, n_subjects=k, delivery="shift",
        **LAYOUTS[layout])
    fmt = port_params(jparams).wire_format
    planes["inbox"] = _narrow_inbox(planes["inbox"], fmt)
    assert planes["inbox"].dtype == (np.int16 if layout == "int16_wire"
                                     else np.int32)
    jworld = jswim.SwimWorld.healthy(
        jparams, subject_ids=jnp.asarray(planes["subject_ids"]))
    state = dataclasses.replace(
        jswim.initial_state(jparams, jworld),
        status=jnp.asarray(planes["status"]),
        inc=jnp.asarray(planes["inc"]),
        spread_until=jnp.asarray(planes["spread_until"]),
        suspect_deadline=jnp.asarray(planes["suspect_deadline"]),
        self_inc=jnp.asarray(planes["self_inc"]))
    new_state, refuted = _jax_merge(
        state, jnp.asarray(planes["status"]), state.inc,
        jnp.asarray(planes["inbox"]), jnp.asarray(planes["inbox_alive"]),
        jnp.int32(37), jparams, jswim.Knobs.from_params(jparams), jworld,
        jnp.arange(n, dtype=jnp.int32), jnp.asarray(planes["alive_here"]),
        jnp.asarray(planes["is_self"]))
    want = [np.asarray(getattr(new_state, f)) for f in
            ("status", "inc", "spread_until", "suspect_deadline",
             "self_inc")] + [np.asarray(refuted)]
    before = dict(LAUNCHES)
    got = merge.merge_and_timers(
        *port_args(planes), 37, jparams.suspicion_rounds,
        jparams.periods_to_spread, swim._wire_inc_sat(port_params(jparams)),
        fmt=fmt)
    assert dict(LAUNCHES) == before
    for name, w, g in zip(("status", "inc", "spread_until",
                           "suspect_deadline", "self_inc", "refuted"),
                          want, got):
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert int(got[4].max()) == cap and bool(got[5].any())
    if fmt is delivery.WIRE16:
        # An int16 inbox is refused by the wide instance.
        with pytest.raises(TypeError, match="inbox"):
            merge.merge_and_timers(*port_args(planes), 37, 20, 12, cap)


def test_narrow_knob_validation_matches_reference():
    base = dict(n_members=64, delivery="shift")
    for kwargs, error in (
            (dict(wire24=True), "compact_carry"),
            (dict(compact_carry=True, wire24=True, int16_wire=True),
             "pick one")):
        with pytest.raises(ValueError, match=error):
            jswim.SwimParams.from_config(fast_config(), **base, **kwargs)
        with pytest.raises(ValueError, match=error):
            swim.SwimParams.from_config(fast_config(), **base, **kwargs)
    for field, value in (("periods_to_spread", 127),
                         ("suspicion_rounds", 32766)):
        p = swim.SwimParams.from_config(fast_config(), **base)
        with pytest.raises(ValueError, match=field):
            dataclasses.replace(p, compact_carry=True, **{field: value})
    for layout, kwargs in LAYOUTS.items():
        p = swim.SwimParams.from_config(fast_config(), **base, **kwargs)
        j = jswim.SwimParams.from_config(fast_config(), **base, **kwargs)
        assert p.compact_wire == j.compact_wire, layout
        assert p.wire_format.name == j.wire_format.name, layout
        assert swim._wire_inc_sat(p) == jswim._wire_inc_sat(j), layout
