"""The port's checkpoints (``utils/checkpoint.py``) against the JAX
package's: save and load round trips, a checkpoint written by either
package loading in the other (the metadata plane's ``md`` and
``md_spread`` lanes included), older checkpoints loading with the
plane-off lanes, and ``run_checkpointed`` killed and resumed: equal to the
unbroken run, to the reference's on the reference's draws, and resumable
by the other package.  The trace-file rules (meta mismatch, re-chunking,
holes, orphans) give the reference's results and messages.  Exact, no
tolerance.
"""

import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu.utils import checkpoint as jcheckpoint  # noqa: E402
from scalecube_cluster_tpu_torch import interop  # noqa: E402
from scalecube_cluster_tpu_torch.models import swim  # noqa: E402
from scalecube_cluster_tpu_torch.utils import checkpoint  # noqa: E402
from tests.test_swim_model import make  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    STATE_FIELDS, assert_state_equal, jax_draws, one_torch_thread,
    port_params, port_world)

pytestmark = pytest.mark.torchport

SEED, N, ROUNDS, CHUNK = 4, 12, 60, 20


def _world(metadata=False):
    """N = 12 at loss 0.1 with node 4 crashed at round 10; ``metadata``:
    the metadata plane (one key, SYNC every 4 rounds) with a push."""
    extra = dict(metadata_keys=1, sync_interval=4) if metadata else {}
    jparams, jworld = make(N, loss=0.1, **extra)
    jworld = jworld.with_crash(4, at_round=10)
    if metadata:
        jworld = jworld.with_metadata_push(2, 0, 9, 3)
    return jparams, jworld


def _port_run(jparams, jworld):
    """A ``swim.run``-shaped function for the port on the reference's
    draws under ``SEED``, and the port's params and world."""
    params, world = port_params(jparams), port_world(jworld)
    draws = jax_draws(jax.random.key(SEED), jparams, jworld)

    def run_fn(seed, params, world, n, state=None, start_round=0):
        assert seed == SEED
        return swim.run(seed, params, world, n, state=state,
                        start_round=start_round, draws=draws, device="cpu")

    return run_fn, params, world


def _dying(run_fn, after):
    calls = {"n": 0}

    def run(*args, **kwargs):
        if calls["n"] == after:
            raise KeyboardInterrupt("simulated preemption")
        calls["n"] += 1
        return run_fn(*args, **kwargs)

    return run


def test_save_load_round_trip(tmp_path):
    """A port state with the metadata lanes saved with its seed and meta
    loads equal, on every lane and dtype; raw key data is kept as given;
    a rewrite in place leaves no temporary file."""
    jparams, jworld = _world(metadata=True)
    params, world = port_params(jparams), port_world(jworld)
    state, _ = swim.run(SEED, params, world, 8, device="cpu")
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, state, next_round=8, key=SEED, meta={"n": N})
    got, r, seed, meta = checkpoint.load(path, params=params, device="cpu")
    assert (r, seed, meta) == (8, SEED, {"n": N})
    for name in STATE_FIELDS:
        assert torch.equal(getattr(got, name), getattr(state, name)), name
    raw = np.array([1, 2], np.uint32)
    checkpoint.save(path, state, next_round=9, key=raw)
    with np.load(path) as z:
        np.testing.assert_array_equal(z["key_data"], raw)
    assert checkpoint.load(path, device="cpu")[1:3] == (9, (1 << 32) | 2)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_checkpoints_load_across_packages(tmp_path):
    """On a ``metadata_keys=1`` world: the reference's checkpoint loads in
    the port (``load`` and ``interop.load_jax_checkpoint``) and the
    port's in the reference, each equal on every lane (``md`` and
    ``md_spread`` among them), with the cursor, meta and key."""
    jparams, jworld = _world(metadata=True)
    key = jax.random.key(SEED)
    jstate, _ = jswim.run(key, jparams, jworld, 8)
    ref_path = str(tmp_path / "ref.npz")
    jcheckpoint.save(ref_path, jstate, next_round=8, key=key,
                     meta={"from": "ref"})
    params = port_params(jparams)
    state, r, seed, meta = checkpoint.load(ref_path, params=params,
                                           device="cpu")
    assert (r, seed, meta) == (8, SEED, {"from": "ref"})
    assert state.md.shape == (N, N, 1) and state.md_spread.shape == (N, N)
    assert_state_equal(jstate, state)
    wrapped = interop.load_jax_checkpoint(ref_path, device="cpu",
                                          params=params)
    assert_state_equal(jstate, wrapped[0])
    np.testing.assert_array_equal(wrapped[2], jax.random.key_data(key))
    assert wrapped[1::2] == (8, {"from": "ref"})

    port_path = str(tmp_path / "port.npz")
    checkpoint.save(port_path, state, next_round=8, key=SEED,
                    meta={"from": "port"})
    back, r2, key2, meta2 = jcheckpoint.load(port_path)
    assert (r2, meta2) == (8, {"from": "port"})
    np.testing.assert_array_equal(jax.random.key_data(key2),
                                  jax.random.key_data(key))
    assert_state_equal(back, state)


def test_legacy_checkpoints_get_the_plane_off_lanes(tmp_path):
    """A reference checkpoint without the plane lanes (``lhm``, ``epoch``,
    ``g_*``, ``md``, ``md_spread``) loads in the port with the lanes the
    reference's own load gives it; one without ``status`` raises
    ``KeyError`` in both; a compact checkpoint loaded without params
    raises the port's ``ValueError``."""
    jparams, jworld = _world()
    key = jax.random.key(SEED)
    jstate, _ = jswim.run(key, jparams, jworld, 8)
    path = str(tmp_path / "ckpt.npz")
    jcheckpoint.save(path, jstate, next_round=8, key=key)
    with np.load(path) as z:
        arrays = {name: z[name] for name in z.files}
    planes = ("state/lhm", "state/epoch", "state/g_", "state/md")
    legacy = {k: v for k, v in arrays.items() if not k.startswith(planes)}
    jcheckpoint._atomic_savez(path, legacy)
    want = jcheckpoint.load(path)[0]
    got = checkpoint.load(path, device="cpu")[0]
    assert_state_equal(want, got)
    assert got.lhm.shape == (0,) and got.md.shape == (N, 0, 0)
    nostatus = str(tmp_path / "nostatus.npz")
    jcheckpoint._atomic_savez(nostatus, {k: v for k, v in legacy.items()
                                         if k != "state/status"})
    with pytest.raises(KeyError):
        jcheckpoint.load(nostatus)
    with pytest.raises(KeyError, match="lacks state fields"):
        checkpoint.load(nostatus, device="cpu")
    compact = dict(legacy, **{"state/inc": legacy["state/inc"].astype(
        np.int16)})
    jcheckpoint._atomic_savez(path, compact)
    with pytest.raises(ValueError, match="compact_carry"):
        checkpoint.load(path, device="cpu")


def test_kill_and_resume_matches_the_reference(tmp_path):
    """``run_checkpointed`` on the metadata plane's world killed after two
    20-round chunks and resumed: its final state and metric chunks equal
    the unbroken run and the reference's ``run_checkpointed`` on the
    reference's draws; the port's interrupted checkpoint resumes in the
    reference to the same state."""
    jparams, jworld = _world(metadata=True)
    key = jax.random.key(SEED)
    run_fn, params, world = _port_run(jparams, jworld)
    unbroken, unbroken_metrics = run_fn(SEED, params, world, ROUNDS)
    path = str(tmp_path / "port.npz")
    with pytest.raises(KeyboardInterrupt):
        checkpoint.run_checkpointed(_dying(run_fn, 2), SEED, params, world,
                                    ROUNDS, path, chunk=CHUNK, device="cpu")
    assert checkpoint.load(path, params=params, device="cpu")[1] == 40
    # The reference resumes the port's files: copied before the port
    # finishes the run in place.
    jpath = str(tmp_path / "ref.npz")
    with open(path, "rb") as src, open(jpath, "wb") as dst:
        dst.write(src.read())
    for upto in (20, 40):
        with open(checkpoint._metrics_path(path, upto), "rb") as src, \
                open(jcheckpoint._metrics_path(jpath, upto), "wb") as dst:
            dst.write(src.read())
    final, chunks = checkpoint.run_checkpointed(
        run_fn, 0, params, world, ROUNDS, path, chunk=CHUNK, device="cpu")
    assert len(chunks) == 3
    for name in STATE_FIELDS:
        assert torch.equal(getattr(final, name), getattr(unbroken, name))
    for name, value in unbroken_metrics.items():
        assert torch.equal(torch.cat([c[name] for c in chunks]), value)
    # Given the initial state, every reference chunk runs one program.
    want, want_chunks = jcheckpoint.run_checkpointed(
        jswim.run, key, jparams, jworld, ROUNDS, str(tmp_path / "j.npz"),
        chunk=CHUNK, state=jswim.initial_state(jparams, jworld))
    assert_state_equal(want, final)
    resumed, resumed_chunks = jcheckpoint.run_checkpointed(
        jswim.run, key, jparams, jworld, ROUNDS, jpath, chunk=CHUNK)
    assert_state_equal(resumed, final)
    for name, value in unbroken_metrics.items():
        want_trace = np.concatenate([np.asarray(c[name])
                                     for c in want_chunks])
        np.testing.assert_array_equal(value.numpy(), want_trace)
        np.testing.assert_array_equal(
            np.concatenate([np.asarray(c[name]) for c in resumed_chunks]),
            want_trace)


def _plain_run(seed, params, world, n, state=None, start_round=0):
    return swim.run(seed, params, world, n, state=state,
                    start_round=start_round, device="cpu")


def _outcome(fn, *args, **kwargs):
    try:
        state, chunks = fn(*args, **kwargs)
    except ValueError as e:
        return ("raised", str(e))
    return ("ok", [(len(np.asarray(c["alive"])),
                    int(np.asarray(c["alive"]).sum())) for c in chunks])


def _both(tmp_path, steps):
    """Run ``steps`` (``(n_rounds, chunk, meta, action)``; ``action(path,
    ckpt)`` edits the files before the step) through both packages'
    ``run_checkpointed`` in twin directories; the outcomes (each chunk's
    length and ``alive`` total, or the error, paths as ``<path>``) must
    be equal."""
    jparams, jworld = make(8)
    params, world = port_params(jparams), port_world(jworld)
    outcomes = []
    for name, ckpt, args in (
            ("ref", jcheckpoint, (jswim.run, jax.random.key(7), jparams,
                                  jworld)),
            ("port", checkpoint, (_plain_run, 7, params, world))):
        path = str(tmp_path / f"{name}.npz")
        got = []
        for n_rounds, chunk, meta, action in steps:
            if action is not None:
                action(path, ckpt)
            kwargs = dict(chunk=chunk, meta=meta)
            if ckpt is checkpoint:
                kwargs["device"] = "cpu"
            else:
                kwargs["state"] = jswim.initial_state(jparams, jworld)
            kind, value = _outcome(ckpt.run_checkpointed, *args, n_rounds,
                                   path, **kwargs)
            got.append((kind, value.replace(path, "<path>")
                        if isinstance(value, str) else value))
        outcomes.append(got)
    assert outcomes[1] == outcomes[0]
    return outcomes[0]


def test_meta_and_rechunking_match_the_reference(tmp_path):
    """A resume under other meta refuses; JSON-lossy meta (tuples, int
    keys) resumes; re-chunking and extending past a short last chunk
    reload every trace, equal to the unbroken run."""
    meta = {"shape": (8, 4), "knobs": {1: "a"}}
    got = _both(tmp_path / "meta", [(10, 5, {"cfg": "a"}, None),
                                    (20, 5, {"cfg": "b"}, None)])
    assert got[1][0] == "raised" and "meta mismatch" in got[1][1]
    got = _both(tmp_path / "lossy", [(10, 5, meta, None),
                                     (20, 5, meta, None)])
    assert [n for n, _ in got[1][1]] == [5, 5, 5, 5]
    # Re-chunking on the port alone, against its unbroken run.
    params, world = port_params(make(8)[0]), port_world(make(8)[1])
    path = str(tmp_path / "chunks.npz")
    for n_rounds, chunk in ((12, 5), (20, 5), (22, 4)):
        final, chunks = checkpoint.run_checkpointed(
            _plain_run, 7, params, world, n_rounds, path, chunk=chunk,
            device="cpu")
    assert [len(c["alive"]) for c in chunks] == [5, 5, 2, 5, 3, 2]
    unbroken, metrics = _plain_run(7, params, world, 22)
    for name in STATE_FIELDS:
        assert torch.equal(getattr(final, name), getattr(unbroken, name))
    for name, value in metrics.items():
        assert torch.equal(torch.cat([c[name] for c in chunks]), value)


def _unlink(upto):
    def action(path, ckpt):
        os.unlink(ckpt._metrics_path(path, upto))
    return action


def _orphan(path, ckpt):
    ckpt._atomic_savez(ckpt._metrics_path(path, 15),
                       {"alive": np.zeros((5, 1))})


def test_trace_holes_and_orphans_match_the_reference(tmp_path):
    """An interior or a suffix trace deleted out of band raises the
    reference's error on resume; an orphan trace past the cursor is
    discarded and its chunk re-run."""
    for upto in (10, 15):
        got = _both(tmp_path / f"hole{upto}", [(15, 5, None, None),
                                               (20, 5, None, _unlink(upto))])
        assert got[1][0] == "raised" and "deleted out-of-band" in got[1][1]
    got = _both(tmp_path / "orphan", [(10, 5, None, None),
                                      (15, 5, None, _orphan)])
    assert [n for n, _ in got[1][1]] == [5, 5, 5] and got[1][1][2][1] > 0
