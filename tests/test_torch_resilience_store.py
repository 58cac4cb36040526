"""The port's checkpoint store (``resilience/store.py``) against the JAX
package's: ``payload_checksum`` on the same states, generations written by
either package loading in the other, and the scenarios of the reference's
``tests/test_resilience_store.py`` (rotation, the corruption fallback, the
checksum against a re-stamped member, the deletion rule after a fallback,
exhaustion, the legacy single file, a failed save) run on both stores in
twin directories.  Every result is equal exactly: arrays, cursors, meta,
the load's ``info`` and the errors' messages, paths aside.
"""

import os
import zipfile

import jax
import numpy as np
import pytest

from scalecube_cluster_tpu.models import swim as jswim
from scalecube_cluster_tpu.resilience import store as jstore
from scalecube_cluster_tpu.utils import checkpoint as jcheckpoint
from scalecube_cluster_tpu_torch.models import swim
from scalecube_cluster_tpu_torch.resilience import store
from scalecube_cluster_tpu_torch.utils import checkpoint
from tests.test_swim_model import make
from tests.torch_port_helpers import (  # noqa: F401
    jax_draws, one_torch_thread, port_params, port_world)

pytestmark = pytest.mark.torchport


def payload(seed=0, n=8):
    """The reference test's payload: seeded state and telemetry arrays."""
    rng = np.random.default_rng(seed)
    return {
        "state/status": rng.integers(0, 4, (n, n)).astype(np.int8),
        "state/inc": rng.integers(0, 100, (n, n)).astype(np.int32),
        "telemetry/first_suspect": rng.integers(
            0, 1 << 30, (n, n)).astype(np.int32),
    }


def fill(st, gens, seed0=0):
    for i, g in enumerate(gens):
        st.save(payload(seed=seed0 + i), g, meta={"gen": g})


def _load(st):
    """``load_latest`` as comparable data: the arrays, cursor, meta and
    info, or the error's type and message (directories as ``<dir>``),
    and the generations left on disk."""
    base = os.path.dirname(st.base_path)
    try:
        got = st.load_latest()
    except Exception as e:  # noqa: BLE001 - compared across packages
        return ("raised", type(e).__name__, str(e).replace(base, "<dir>"),
                st.generations_on_disk())
    if got is None:
        return None
    arrays, next_round, _, meta, info = got
    info = {k: ([(p.replace(base, "<dir>"), why) for p, why in v]
                if k == "fallbacks" else v.replace(base, "<dir>")
                if isinstance(v, str) else v) for k, v in info.items()}
    return ({k: (v.dtype.str, v.tolist()) for k, v in arrays.items()},
            next_round, meta, info, st.generations_on_disk())


def _twin(tmp_path, scenario, **kwargs):
    """Run ``scenario(store_module, base_path)`` on both packages' stores
    in twin directories and return the reference's result, which the
    port's must equal."""
    results = []
    for name, mod in (("ref", jstore), ("port", store)):
        directory = tmp_path / name
        directory.mkdir(parents=True)
        results.append(scenario(mod, str(directory / "ck"), **kwargs))
    assert results[1] == results[0]
    return results[0]


def test_payload_checksum_matches_reference():
    """The checksum of the same run's state in both packages (the port on
    the reference's draws, every lane and dtype, the metadata plane on)
    and of the reference test's payloads, with extra members."""
    jparams, jworld = make(12, loss=0.1, metadata_keys=1, sync_interval=4)
    jworld = jworld.with_crash(4, at_round=3).with_metadata_push(
        2, 0, 9, 1)
    key = jax.random.key(5)
    jstate, _ = jswim.run(key, jparams, jworld, 16)
    state, _ = swim.run(5, port_params(jparams), port_world(jworld), 16,
                        draws=jax_draws(key, jparams, jworld), device="cpu")
    want = jcheckpoint.state_to_arrays(jstate)
    got = checkpoint.state_to_arrays(state)
    assert sorted(got) == sorted(want)
    assert store.payload_checksum(got) == jstore.payload_checksum(want)
    for seed in range(4):
        arrays = dict(payload(seed), next_round=np.int64(seed))
        assert store.payload_checksum(arrays) == jstore.payload_checksum(
            arrays)
    assert store.payload_checksum(got) != store.payload_checksum(payload())


def test_generations_load_across_packages(tmp_path):
    """A port generation (seed, meta) loads in the reference store with
    the seed's key, and a reference generation loads in the port's with
    the seed its key spells; arrays, cursor, meta and info equal."""
    arrays = payload(seed=3)
    p = store.CheckpointStore(str(tmp_path / "p"), keep=2)
    p.save(arrays, 40, key=9, meta={"run": "x", "n": 8})
    got, next_round, got_key, meta, info = jstore.CheckpointStore(
        str(tmp_path / "p"), keep=2).load_latest()
    assert (next_round, meta, info["generation"]) == (
        40, {"run": "x", "n": 8}, 40)
    np.testing.assert_array_equal(jax.random.key_data(got_key),
                                  jax.random.key_data(jax.random.key(9)))
    j = jstore.CheckpointStore(str(tmp_path / "j"), keep=2)
    j.save(arrays, 24, key=jax.random.key(7), meta={"run": "y"})
    got2, next_round2, seed2, meta2, info2 = store.CheckpointStore(
        str(tmp_path / "j"), keep=2).load_latest()
    assert (next_round2, seed2, meta2, info2) == (
        24, 7, {"run": "y"}, {"path": j.gen_path(24), "generation": 24,
                              "fallbacks": []})
    for name, a in arrays.items():
        np.testing.assert_array_equal(got[name], a)
        np.testing.assert_array_equal(got2[name], a)


def _rotation(mod, base):
    st = mod.CheckpointStore(base, keep=3)
    empty = st.load_latest()
    fill(st, [10, 20, 30, 40, 50])
    gone = [os.path.exists(st.gen_path(g)) for g in (10, 20)]
    try:
        mod.CheckpointStore(base, keep=0)
        refused = None
    except ValueError as e:
        refused = str(e)
    return empty, gone, refused, _load(st)


def _corrupt(mod, base, corruption):
    st = mod.CheckpointStore(base, keep=3)
    fill(st, [10, 20, 30])
    targets = (10, 20, 30) if corruption == "exhaust" else (30,)
    for g in targets:
        path = st.gen_path(g)
        if corruption == "truncate":
            with open(path, "rb+") as f:
                f.truncate(os.path.getsize(path) // 3)
        elif corruption == "bitflip":
            with open(path, "rb+") as f:
                f.seek(os.path.getsize(path) // 2)
                b = f.read(1)
                f.seek(-1, 1)
                f.write(bytes([b[0] ^ 0xFF]))
        elif corruption == "delete":
            os.unlink(path)
        else:
            with open(path, "rb+") as f:
                f.truncate(10)
    return _load(st)


@pytest.mark.parametrize("corruption",
                         ["truncate", "bitflip", "delete", "exhaust"])
def test_corrupt_latest_falls_back(tmp_path, corruption):
    """The newest generation truncated, bit-flipped or deleted: both
    stores fall back to round 20 with the same reason; every generation
    truncated: both raise ``CheckpointExhaustedError`` naming each
    candidate."""
    got = _twin(tmp_path, _corrupt, corruption=corruption)
    if corruption == "exhaust":
        assert got[1] == "CheckpointExhaustedError" and "start over" in got[2]
        assert all(f".gen-{g:08d}.npz" in got[2] for g in (10, 20, 30))
    else:
        assert got[1:3] == (20, {"gen": 20})
        assert len(got[3]["fallbacks"]) == (corruption != "delete")


def _content_swap(mod, base):
    st = mod.CheckpointStore(base, keep=2)
    fill(st, [10, 20])
    bogus = base + ".bogus.npz"
    np.savez(bogus, **{"state/status": payload(seed=99)["state/status"]})
    with zipfile.ZipFile(bogus) as zin, \
            zipfile.ZipFile(st.gen_path(20), "a") as zout:
        zout.writestr("state/status.npy", zin.read("state/status.npy"))
    return _load(st)


def test_checksum_catches_a_restamped_member(tmp_path):
    """A member rewritten with valid zip bytes of other content fails the
    load in both stores, which fall back to round 10."""
    got = _twin(tmp_path, _content_swap)
    (_, why), = got[3]["fallbacks"]
    assert got[1] == 10 and ("checksum" in why or "unreadable" in why)


def _fallback_then_save(mod, base):
    st = mod.CheckpointStore(base, keep=3)
    fill(st, [20, 30, 40])
    for g in (30, 40):
        with open(st.gen_path(g), "rb+") as f:
            f.truncate(os.path.getsize(st.gen_path(g)) // 3)
    first = _load(st)
    st.save(payload(seed=9), 28, meta={"gen": 28})
    second = _load(st)
    for i, g in enumerate((36, 44, 52)):
        st.save(payload(seed=10 + i), g, meta={"gen": g})
    return first, second, _load(st)


def test_rotation_and_deletion(tmp_path):
    """An empty lineage loads None; five saves under ``keep=3`` leave the
    last three, the older files gone; ``keep=0`` refuses.  After a
    fallback past two corrupt generations, a save at a lower round keeps
    itself and the intact fallback; the corrupt files age out as the
    cursor passes them."""
    empty, gone, refused, loaded = _twin(tmp_path / "rotation", _rotation)
    assert empty is None and gone == [False, False] and "keep" in refused
    assert loaded[1] == 50 and loaded[4] == [30, 40, 50]
    first, second, third = _twin(tmp_path / "fallback", _fallback_then_save)
    assert first[1] == 20 and len(first[3]["fallbacks"]) == 2
    assert second[1] == 28 and {20, 28} <= set(second[4])
    assert third[1] == 52 and third[3]["fallbacks"] == []
    assert 30 not in third[4]


def _legacy_and_failed_save(mod, base, ckpt, jax_side):
    params, world = make(8)
    state = jswim.initial_state(params, world)
    if not jax_side:
        state = swim.initial_state(port_params(params), port_world(world),
                                   device="cpu")
    ckpt.save(base, state, next_round=12, meta={"legacy": True})
    st = mod.CheckpointStore(base, keep=2)
    legacy = _load(st)
    got = st.load_latest()[0]
    st.save(got, 24, meta={"legacy": True})
    rotated = _load(st)

    class Unsavable:
        def __array__(self, *args, **kwargs):
            raise RuntimeError("mid-serialization failure")

    try:
        st.save({"state/x": Unsavable()}, 30)
        failed = None
    except Exception as e:  # noqa: BLE001 - compared across packages
        failed = type(e).__name__
    leftovers = sorted(f for f in os.listdir(os.path.dirname(base))
                       if ".tmp" in f)
    return legacy, rotated, failed, leftovers, _load(st)


def test_legacy_file_and_failed_save(tmp_path):
    """A single-file ``utils/checkpoint`` file (each package's own) is the
    last candidate, loaded without a checksum, until a rotated generation
    exists; a save that fails mid-serialisation leaves the lineage and no
    temporary file."""
    results = []
    for name, mod, ckpt in (("ref", jstore, jcheckpoint),
                            ("port", store, checkpoint)):
        directory = tmp_path / name
        directory.mkdir()
        results.append(_legacy_and_failed_save(
            mod, str(directory / "old.npz"), ckpt, name == "ref"))
    assert results[1] == results[0]
    legacy, rotated, failed, leftovers, after = results[0]
    assert legacy[1:3] == (12, {"legacy": True})
    assert legacy[3]["generation"] is None and legacy[3]["legacy"] is True
    assert rotated[1] == 24 and rotated[3]["generation"] == 24
    assert failed and leftovers == [] and after == rotated
