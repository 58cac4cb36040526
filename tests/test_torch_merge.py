"""The port's merge/timers step against the JAX package's
``swim._merge_and_timers``.

Seeded [64, 16] focal and [48, 48] full-view planes cover ABSENT and DEAD
entries, the ABSENT opener with and without ALIVE arrivals, self cells
overridden and not, frozen rows, timers pending, firing and at
INT32_MAX, and incarnations at the key's cap.  Exact equality: every
input and output is an integer plane.

On the CPU the wrapper runs the plain PyTorch version; ``chip_smoke.py``
holds the CUDA kernel against that version on the card.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu_torch.kernels import LAUNCHES  # noqa: E402
from scalecube_cluster_tpu_torch.kernels import merge  # noqa: E402
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

