"""The port's foundation modules against the JAX package: the merge rule
and keys (``records.py``), the round quantization (``config.py``,
``swim_math.py``), the wire keys and inbox merge (``ops/delivery.py``)
and the shifted views (``ops/shift.py``).

Inputs are seeded numpy arrays handed to both sides; all values are
integers, so every comparison is exact equality.
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from scalecube_cluster_tpu import config as jconfig  # noqa: E402
from scalecube_cluster_tpu import records as jrecords  # noqa: E402
from scalecube_cluster_tpu import swim_math as jmath  # noqa: E402
from scalecube_cluster_tpu.ops import delivery as jdelivery  # noqa: E402
from scalecube_cluster_tpu.ops import shift as jshift  # noqa: E402
from scalecube_cluster_tpu_torch import config, records, swim_math  # noqa: E402
from scalecube_cluster_tpu_torch.ops import delivery, shift  # noqa: E402
from tests.torch_port_helpers import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torchport

CAP = 2**29 - 1
STATUSES = (records.ALIVE, records.SUSPECT, records.DEAD, records.ABSENT)


# ---- records.py -----------------------------------------------------------

# MembershipRecordTest.java:47-107 (tests/test_records.py), new record at
# incarnation 1 against entries at 0, 1, 2.
TRUTH_TABLE = [
    (records.DEAD, records.ABSENT, [False]),
    (records.DEAD, records.ALIVE, [True, True, True]),
    (records.DEAD, records.SUSPECT, [True, True, True]),
    (records.DEAD, records.DEAD, [False, False, False]),
    (records.ALIVE, records.ABSENT, [True]),
    (records.ALIVE, records.ALIVE, [True, False, False]),
    (records.ALIVE, records.SUSPECT, [True, False, False]),
    (records.ALIVE, records.DEAD, [False, False, False]),
    (records.SUSPECT, records.ABSENT, [False]),
    (records.SUSPECT, records.ALIVE, [True, True, False]),
    (records.SUSPECT, records.SUSPECT, [True, False, False]),
    (records.SUSPECT, records.DEAD, [False, False, False]),
]


@pytest.mark.parametrize("new_s,old_s,expected", TRUTH_TABLE)
def test_membership_record_truth_table(new_s, old_s, expected):
    for old_inc, want in zip((0, 1, 2), expected):
        assert records.is_overrides(new_s, 1, old_s, old_inc) == want
        assert bool(records.is_overrides_array(new_s, 1, old_s, old_inc)) \
            == want
        assert jrecords.is_overrides(new_s, 1, old_s, old_inc) == want


def test_is_overrides_matches_reference_on_full_grid():
    grid = np.array(list(itertools.product(STATUSES, range(4), STATUSES,
                                           range(4))), dtype=np.int32)
    ns, ni, os_, oi = grid.T
    want = np.asarray(jrecords.is_overrides_array(ns, ni, os_, oi))
    got = records.is_overrides_array(*(torch.from_numpy(c.copy())
                                       for c in (ns, ni, os_, oi)))
    np.testing.assert_array_equal(got.numpy(), want)
    scalar = [records.is_overrides(*map(int, row)) for row in grid]
    np.testing.assert_array_equal(np.array(scalar), want)


def _status_inc(rng, size):
    status = rng.integers(0, 4, size).astype(np.int8)
    inc = rng.choice(np.array([0, 1, 7, CAP - 1, CAP, CAP + 5, 2**31 - 1]),
                     size).astype(np.int32)
    return status, inc


def test_merge_key_matches_reference():
    status, inc = _status_inc(np.random.default_rng(0), (300,))
    want = np.asarray(jrecords.merge_key(status, inc))
    got = records.merge_key(torch.from_numpy(status), torch.from_numpy(inc))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ---- config.py / swim_math.py ---------------------------------------------

@pytest.mark.parametrize("preset", ["default", "default_wan", "default_local"])
@pytest.mark.parametrize("n", [1, 2, 50, 1000, 65_536, 1_000_000])
def test_to_sim_matches_reference(preset, n):
    want = getattr(jconfig.ClusterConfig, preset)().to_sim(n)
    got = getattr(config.ClusterConfig, preset)().to_sim(n)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_swim_math_matches_reference():
    for n in (0, 1, 2, 3, 4, 50, 1000, 2**20):
        assert swim_math.ceil_log2(n) == jmath.ceil_log2(n)
        for m in (1, 3):
            assert swim_math.gossip_periods_to_spread(m, n) \
                == jmath.gossip_periods_to_spread(m, n)
            assert swim_math.gossip_periods_to_sweep(m, n) \
                == jmath.gossip_periods_to_sweep(m, n)
            assert swim_math.suspicion_timeout(m, n, 1000) \
                == jmath.suspicion_timeout(m, n, 1000)
    with pytest.raises(ValueError):
        swim_math.ceil_log2(-1)


def test_config_validation_matches_reference():
    with pytest.raises(ValueError, match="ping_timeout"):
        config.ClusterConfig(ping_timeout=1000, ping_interval=1000)


# ---- ops/delivery.py ------------------------------------------------------

def test_wire_format_table_matches_reference():
    for name, fmt in delivery.WIRE_FORMATS.items():
        ref = jdelivery.WIRE_FORMATS[name]
        assert (fmt.dead_bit, fmt.epoch_bits, fmt.wide_word) \
            == (ref.dead_bit, ref.epoch_bits, ref.wide_word)
        for eb in (0, fmt.epoch_bits):
            assert fmt.inc_sat(eb) == ref.inc_sat(eb)
    for fmt in (delivery.WIRE16, delivery.WIRE24):
        with pytest.raises(NotImplementedError, match=fmt.name):
            delivery.pack_record(torch.zeros(2, dtype=torch.int8),
                                 torch.zeros(2, dtype=torch.int32), fmt=fmt)


def _keys(rng, size):
    """Random wire keys: no message, DEAD, SUSPECT, ALIVE, and keys at the
    2^29-1 incarnation saturation."""
    status, inc = _status_inc(rng, size)
    keys = np.asarray(jrecords.merge_key(status, np.minimum(inc, CAP)))
    return np.where(rng.random(size) < 0.2, -1, keys).astype(np.int32)


def test_pack_unpack_and_alive_flag_match_reference():
    rng = np.random.default_rng(1)
    status, inc = _status_inc(rng, (400,))
    np.testing.assert_array_equal(
        delivery.pack_record(torch.from_numpy(status),
                             torch.from_numpy(inc)).numpy(),
        np.asarray(jdelivery.pack_record(status, inc)))
    keys = _keys(rng, (400,))
    ws, wi = jdelivery.unpack_record(keys)
    gs, gi = delivery.unpack_record(torch.from_numpy(keys))
    assert gs.dtype == torch.int8 and gi.dtype == torch.int32
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(
        delivery.is_alive_key(torch.from_numpy(keys)).numpy(),
        np.asarray(jdelivery.is_alive_key(keys)))
    assert delivery.no_message() == int(jdelivery.no_message())


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_inbox_matches_reference(seed):
    rng = np.random.default_rng(seed)
    status, inc = _status_inc(rng, (50, 16))
    inc = np.minimum(inc, CAP).astype(np.int32)
    inbox = _keys(rng, (50, 16))
    any_alive = rng.random((50, 16)) < 0.5
    want = jdelivery.merge_inbox(status, inc, inbox, any_alive)
    got = delivery.merge_inbox(*(torch.from_numpy(a) for a in
                                 (status, inc, inbox, any_alive)))
    for w, g in zip(want, got):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---- ops/shift.py ---------------------------------------------------------

@pytest.mark.parametrize("n", [2, 7, 64])
def test_deliver_and_look_match_reference(n):
    x = np.random.default_rng(n).integers(-5, 100, (n, 3)).astype(np.int32)
    dj = jshift.doubled(jnp.asarray(x))
    dt = shift.doubled(torch.from_numpy(x))
    eng = shift.ShiftEngine(n)
    for s in range(1, n):
        want_d = np.asarray(jshift.deliver(dj, jnp.int32(s), n))
        want_l = np.asarray(jshift.look(dj, jnp.int32(s), n))
        np.testing.assert_array_equal(shift.deliver(dt, s, n).numpy(), want_d)
        np.testing.assert_array_equal(shift.look(dt, s, n).numpy(), want_l)
        np.testing.assert_array_equal(eng.deliver(eng.prep(
            torch.from_numpy(x)), s).numpy(), want_d)
