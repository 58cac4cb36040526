"""The port's merge/timers step against the JAX package's
``swim._merge_and_timers``.

Seeded [64, 16] focal and [48, 48] full-view planes cover ABSENT and DEAD
entries, the ABSENT opener with and without ALIVE arrivals, self cells
overridden and not, frozen rows, timers pending, firing and at
INT32_MAX, and incarnations at the key's cap.  Exact equality: every
input and output is an integer plane.

The two plane branches (Lifeguard's per-row armed rounds, the
dead-member suppression window) are held against the reference's
``_merge_and_timers`` with ``lhm_max=8`` and ``dead_suppress_rounds=64``
on planes with suppressed and unsuppressed tombstones, expiries at the
round and one round either side, seeded multipliers in [1, 8] and frozen
rows, in all three wire formats, and in block form at a column offset.

On the CPU the wrapper runs the plain PyTorch version; ``chip_smoke.py``
holds the CUDA kernel against that version on the card.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu_torch.kernels import LAUNCHES  # noqa: E402
from scalecube_cluster_tpu_torch.kernels import merge  # noqa: E402
from scalecube_cluster_tpu_torch.models import lifeguard  # noqa: E402
from scalecube_cluster_tpu_torch.ops import delivery  # noqa: E402
from tests.test_swim_model import fast_config  # noqa: E402
from tests.torch_port_helpers import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torchport

CAP = 2**29 - 1
INT32_MAX = 2**31 - 1
ROUND = 37
SHAPES = {"focal_64x16": (64, 16), "full_view_48": (48, 48)}


def _key(status, inc):
    """records.merge_key in numpy."""
    inc = np.minimum(inc, CAP)
    key = ((status == 2).astype(np.int64) << 30) | (inc << 1) \
        | (status == 1).astype(np.int64)
    return np.where(status == 3, -1, key).astype(np.int32)


def make_planes(n, k, seed):
    """Seeded merge inputs with every edge case present.  Returns numpy
    arrays; ``status``/``inc`` are already pinned (self cells ALIVE at
    self_inc), as the tick hands them to the merge."""
    rng = np.random.default_rng(seed)
    if k == n:
        subject_ids = np.arange(n)
    else:
        subject_ids = rng.permutation(n)[:k]
    slot_of_node = np.full(n, -1, np.int32)
    slot_of_node[subject_ids] = np.arange(k)
    is_self = subject_ids[None, :] == np.arange(n)[:, None]

    small = np.array([0, 1, 2, 3, 5, CAP - 1, CAP])
    status = rng.integers(0, 4, (n, k)).astype(np.int8)
    inc = rng.choice(small, (n, k), p=[.3, .2, .15, .1, .1, .1, .05])
    self_inc = rng.choice(small, n, p=[.3, .2, .15, .1, .1, .1, .05])

    # Winner keys around the entry: no message, same/lower/higher
    # incarnation, any status, and keys at the incarnation cap.
    win_status = rng.integers(0, 4, (n, k))
    delta = rng.integers(-1, 2, (n, k))
    win_inc = np.clip(inc + delta, 0, CAP)
    win_inc = np.where(rng.random((n, k)) < 0.1, CAP, win_inc)
    # Self cells: winners relative to the node's own incarnation, so
    # both overriding (SUSPECT@self_inc, DEAD, higher inc) and
    # non-overriding (ALIVE@self_inc, lower inc) arrivals occur.
    self_rel = np.clip(self_inc[:, None] + delta, 0, CAP)
    win_inc = np.where(is_self, self_rel, win_inc)
    inbox = _key(win_status, win_inc)
    inbox = np.where(rng.random((n, k)) < 0.15, -1, inbox).astype(np.int32)
    inbox_alive = rng.random((n, k)) < 0.5

    deadline = rng.choice(
        np.array([INT32_MAX, ROUND - 3, ROUND, ROUND + 4, 0]), (n, k),
        p=[.5, .15, .15, .15, .05]).astype(np.int32)
    spread_until = rng.integers(0, 2 * ROUND, (n, k)).astype(np.int32)
    alive_here = rng.random(n) < 0.8

    status = np.where(is_self, 0, status).astype(np.int8)
    inc = np.where(is_self, self_inc[:, None], inc).astype(np.int32)
    return dict(status=status, inc=inc, spread_until=spread_until,
                suspect_deadline=deadline, inbox=inbox,
                inbox_alive=inbox_alive, self_inc=self_inc.astype(np.int32),
                alive_here=alive_here, slot_of_node=slot_of_node,
                subject_ids=subject_ids.astype(np.int32), is_self=is_self)


def reference(planes, n, k):
    """JAX ``_merge_and_timers`` on the planes: (status, inc,
    spread_until, suspect_deadline, self_inc, refuted) as numpy."""
    params = jswim.SwimParams.from_config(fast_config(), n_members=n,
                                          n_subjects=k, delivery="shift")
    world = jswim.SwimWorld.healthy(
        params, subject_ids=jnp.asarray(planes["subject_ids"]))
    state = dataclasses.replace(
        jswim.initial_state(params, world),
        status=jnp.asarray(planes["status"]), inc=jnp.asarray(planes["inc"]),
        spread_until=jnp.asarray(planes["spread_until"]),
        suspect_deadline=jnp.asarray(planes["suspect_deadline"]),
        self_inc=jnp.asarray(planes["self_inc"]))
    new_state, refuted = jswim._merge_and_timers(
        state, state.status, state.inc, jnp.asarray(planes["inbox"]),
        jnp.asarray(planes["inbox_alive"]), jnp.int32(ROUND), params,
        jswim.Knobs.from_params(params), world,
        jnp.arange(n, dtype=jnp.int32), jnp.asarray(planes["alive_here"]),
        jnp.asarray(planes["is_self"]))
    out = [np.asarray(getattr(new_state, f)) for f in
           ("status", "inc", "spread_until", "suspect_deadline", "self_inc")]
    return out + [np.asarray(refuted)], params


PORT_ARGS = ("status", "inc", "spread_until", "suspect_deadline", "inbox",
             "inbox_alive", "self_inc", "alive_here", "slot_of_node")


def port_args(planes):
    return [torch.tensor(planes[name]) for name in PORT_ARGS]


def scalars(params):
    return (ROUND, params.suspicion_rounds, params.periods_to_spread, CAP)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_merge_matches_reference(shape, seed):
    n, k = SHAPES[shape]
    planes = make_planes(n, k, seed)
    want, params = reference(planes, n, k)
    got = merge.merge_and_timers_reference(*port_args(planes),
                                           *scalars(params))
    for name, w, g in zip(("status", "inc", "spread_until",
                           "suspect_deadline", "self_inc", "refuted"),
                          want, got):
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_planes_cover_the_edge_cases():
    """The seeded planes do reach every branch the merge has."""
    n, k = SHAPES["focal_64x16"]
    planes = make_planes(n, k, 0)
    want, _ = reference(planes, n, k)
    new_status, _, _, new_deadline, new_self, refuted = want
    live = planes["alive_here"][:, None]
    st, dl = planes["status"], planes["suspect_deadline"]
    assert (live & (st == 3) & planes["inbox_alive"]
            & (planes["inbox"] >= 0)).any()                  # opener
    assert (live & (st == 3) & ~planes["inbox_alive"]
            & (planes["inbox"] >= 0)).any()                  # closed gate
    assert (live & (st == 2) & (new_status != 2)).any()      # DEAD reopens
    assert (refuted & planes["alive_here"]).any()            # self overridden
    assert (planes["slot_of_node"] >= 0).sum() > refuted.sum()  # and not
    assert ((new_status == 2) & (st == 1) & live).any()      # timer fired
    assert ((new_deadline != INT32_MAX) & (dl == INT32_MAX)).any()  # armed
    assert (~planes["alive_here"]).any()                     # frozen rows
    assert (planes["inc"] == CAP).any() and (new_self == CAP).any()


def test_wrapper_takes_plain_version_on_cpu():
    n, k = SHAPES["full_view_48"]
    planes = make_planes(n, k, 3)
    _, params = reference(planes, n, k)
    before = LAUNCHES[merge.NAME]
    got = merge.merge_and_timers(*port_args(planes), *scalars(params))
    want = merge.merge_and_timers_reference(*port_args(planes),
                                            *scalars(params))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert LAUNCHES[merge.NAME] == before


@pytest.mark.parametrize("field,bad", [
    ("status", lambda t: t.to(torch.int32)),
    ("inbox", lambda t: t[:, :-1]),
    ("inc", lambda t: t.t().contiguous().t()),
    ("self_inc", lambda t: t[None, :]),
])
def test_wrapper_rejects_bad_inputs(field, bad):
    n, k = SHAPES["full_view_48"]
    planes = make_planes(n, k, 4)
    args = port_args(planes)
    i = PORT_ARGS.index(field)
    args[i] = bad(args[i])
    with pytest.raises((TypeError, ValueError), match=field):
        merge.merge_and_timers(*args, ROUND, 20, 12, CAP)



@pytest.mark.parametrize("col0", [0, 16, 32])
def test_block_form_equals_the_whole_planes_columns(col0):
    """The merge of an [N, 16] column block of full-view 48 x 48 planes,
    read through strided views with ``col0`` and written through ``out``
    views into [N, K] planes, equals the whole merge's columns and leaves
    the other columns untouched; rows whose self column lies outside the
    block keep their ``self_inc`` and do not refute."""
    n, k, kb = 48, 48, 16
    planes = make_planes(n, k, 5)
    args = port_args(planes)
    params = jswim.SwimParams.from_config(fast_config(), n_members=n,
                                          delivery="shift")
    whole = merge.merge_and_timers(*args, *scalars(params))
    blk = slice(col0, col0 + kb)
    views = [a[:, blk] for a in args[:6]]
    assert not views[1].is_contiguous()
    target = [torch.full((n, k), -7, dtype=t.dtype) for t in whole[:4]]
    got = merge.merge_and_timers(*views, *args[6:], *scalars(params),
                                 col0=col0, out=[t[:, blk] for t in target])
    rest = torch.ones(k, dtype=torch.bool)
    rest[blk] = False
    for g, t, w in zip(got[:4], target, whole[:4]):
        assert g.data_ptr() == t[:, blk].data_ptr()
        assert torch.equal(t[:, blk], w[:, blk])
        assert bool((t[:, rest] == -7).all())
    slot = args[8]
    inside = (slot >= col0) & (slot < col0 + kb)
    assert bool(inside.any()) and bool((~inside).any())
    assert torch.equal(got[4], torch.where(inside, whole[4], args[6]))
    assert torch.equal(got[5], whole[5] & inside)
    assert bool((whole[5] & inside).any())
    # The twin itself, on the same views.
    twin = merge.merge_and_timers_reference(*views, *args[6:],
                                            *scalars(params), col0=col0)
    assert all(torch.equal(a, b) for a, b in zip(twin, got))


# --------------------------------------------------------------------------
# The plane branches: per-row armed rounds and the suppression window
# --------------------------------------------------------------------------

PLANE_LAYOUTS = {"wide": ({}, CAP),
                 "int16_wire": (dict(int16_wire=True), 8191),
                 "compact_wire24": (dict(compact_carry=True, wire24=True),
                                    32767)}
LHM_MAX, SUPPRESS = 8, 64
# Deadlines around the round: no timer, expiries at the round and one
# round either side, older and later ones.
PLANE_DEADLINES = [INT32_MAX, INT32_MAX, ROUND - 1, ROUND, ROUND + 1,
                   ROUND - 3, ROUND + 4, 0]
_jax_merge = jax.jit(jswim._merge_and_timers, static_argnums=(6,))


def plane_planes(n, k, seed, layout):
    """``make_planes`` for the plane branches: incarnations clipped at
    the layout's cap, the inbox packed in its wire format, deadlines from
    ``PLANE_DEADLINES`` (so tombstones are suppressed and not, and
    expiries fall at the round and one round either side), multipliers
    ``lhm`` [N] in [1, LHM_MAX]."""
    overrides, cap = PLANE_LAYOUTS[layout]
    planes = make_planes(n, k, seed)
    rng = np.random.default_rng(seed + 100)
    for name in ("inc", "self_inc"):
        planes[name] = np.minimum(planes[name], cap).astype(np.int32)
    planes["suspect_deadline"] = rng.choice(
        np.array(PLANE_DEADLINES, np.int64), (n, k)).astype(np.int32)
    planes["lhm"] = rng.integers(1, LHM_MAX + 1, n).astype(np.int32)
    jparams = jswim.SwimParams.from_config(
        fast_config(), n_members=n, n_subjects=k, delivery="shift",
        lhm_max=LHM_MAX, dead_suppress_rounds=SUPPRESS, **overrides)
    fmt = delivery.WIRE_FORMATS[layout_format(layout)]
    status, inc = delivery.unpack_record(torch.from_numpy(planes["inbox"]))
    planes["inbox"] = delivery.pack_record(status, inc, fmt=fmt).numpy()
    return planes, jparams, fmt, cap


def layout_format(layout):
    return {"wide": "wide", "int16_wire": "wire16",
            "compact_wire24": "wire24"}[layout]


def plane_reference(planes, jparams):
    """The reference's ``_merge_and_timers`` with the planes on: the
    state carries ``lhm``, and the world has the rows that are not live
    crashed, so its live count is theirs.  Returns the six outputs and
    the live count."""
    n, k = planes["status"].shape
    down = np.flatnonzero(~planes["alive_here"])
    jworld = jswim.SwimWorld.healthy(
        jparams, subject_ids=jnp.asarray(planes["subject_ids"]))
    jworld = jworld.with_crash(jnp.asarray(down), at_round=0)
    state = dataclasses.replace(
        jswim.initial_state(jparams, jworld),
        status=jnp.asarray(planes["status"]),
        inc=jnp.asarray(planes["inc"]),
        spread_until=jnp.asarray(planes["spread_until"]),
        suspect_deadline=jnp.asarray(planes["suspect_deadline"]),
        self_inc=jnp.asarray(planes["self_inc"]),
        lhm=jnp.asarray(planes["lhm"]))
    new_state, refuted = _jax_merge(
        state, jnp.asarray(planes["status"]), state.inc,
        jnp.asarray(planes["inbox"]), jnp.asarray(planes["inbox_alive"]),
        jnp.int32(ROUND), jparams, jswim.Knobs.from_params(jparams), jworld,
        jnp.arange(n, dtype=jnp.int32), jnp.asarray(planes["alive_here"]),
        jnp.asarray(planes["is_self"]))
    want = [np.asarray(getattr(new_state, f)) for f in
            ("status", "inc", "spread_until", "suspect_deadline",
             "self_inc")] + [np.asarray(refuted)]
    return want, n - down.size


def plane_args(planes, jparams, n_live):
    """The port's plane arguments: the armed rounds of each row's
    multiplier at this live count, and the window."""
    armed = lifeguard.suspicion_deadline_rounds(
        jparams.suspicion_rounds, torch.from_numpy(planes["lhm"]),
        torch.tensor(n_live, dtype=torch.int32), jparams.n_members)
    return dict(armed_rounds=armed, dead_suppress_rounds=SUPPRESS)


@pytest.mark.parametrize("seed", [7, 8])
@pytest.mark.parametrize("layout", sorted(PLANE_LAYOUTS))
def test_plane_branches_match_reference(layout, seed):
    n, k = SHAPES["focal_64x16"]
    planes, jparams, fmt, cap = plane_planes(n, k, seed, layout)
    want, n_live = plane_reference(planes, jparams)
    before = dict(LAUNCHES)
    got = merge.merge_and_timers(
        *port_args(planes), ROUND, jparams.suspicion_rounds,
        jparams.periods_to_spread, cap, fmt=fmt,
        **plane_args(planes, jparams, n_live))
    assert dict(LAUNCHES) == before
    for name, w, g in zip(("status", "inc", "spread_until",
                           "suspect_deadline", "self_inc", "refuted"),
                          want, got):
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    # The planes reach both branches: suppressed tombstones that hold
    # against an ALIVE arrival, unsuppressed ones that reopen, windows
    # opened this round, and timers armed at more than one length.
    live = planes["alive_here"][:, None]
    st, dl = planes["status"], planes["suspect_deadline"]
    new_status, new_dl = want[0], want[3]
    suppressed = live & (st == 2) & (dl != INT32_MAX) & (ROUND < dl)
    alive_in = ((planes["inbox"] >= 0) & planes["inbox_alive"])
    assert (suppressed & alive_in & (new_status == 2)).any()
    assert (live & (st == 2) & ~suppressed & (new_status == 0)).any()
    assert (live & (new_status == 2) & (new_dl == ROUND + SUPPRESS)
            & (st != 2)).any()
    armed = new_dl[live[:, 0]][(new_status[live[:, 0]] == 1)
                               & (dl[live[:, 0]] != new_dl[live[:, 0]])]
    assert np.unique(armed - ROUND).size > 1


@pytest.mark.parametrize("layout", sorted(PLANE_LAYOUTS))
def test_plane_branches_in_block_form(layout):
    """The block form with the plane arguments: an [N, 16] block of
    full-view 48 x 48 planes at column 16, through strided views, equals
    the whole planes' merge on its columns."""
    n, k, kb, col0 = 48, 48, 16, 16
    planes, jparams, fmt, cap = plane_planes(n, k, 9, layout)
    want, n_live = plane_reference(planes, jparams)
    args = port_args(planes)
    extra = plane_args(planes, jparams, n_live)
    scal = (ROUND, jparams.suspicion_rounds, jparams.periods_to_spread, cap)
    whole = merge.merge_and_timers(*args, *scal, fmt=fmt, **extra)
    for w, g in zip(want, whole):
        np.testing.assert_array_equal(g.numpy(), w)
    blk = slice(col0, col0 + kb)
    views = [a[:, blk] for a in args[:6]]
    target = [torch.full((n, k), -7, dtype=t.dtype) for t in whole[:4]]
    got = merge.merge_and_timers(*views, *args[6:], *scal, fmt=fmt,
                                 col0=col0, out=[t[:, blk] for t in target],
                                 **extra)
    for t, w in zip(target, whole[:4]):
        assert torch.equal(t[:, blk], w[:, blk])
    inside = (args[8] >= col0) & (args[8] < col0 + kb)
    assert torch.equal(got[4], torch.where(inside, whole[4], args[6]))
    assert torch.equal(got[5], whole[5] & inside)
