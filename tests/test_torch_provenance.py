"""The port's provenance plane (``models/provenance.py``, the per-channel
exposure of ``models/swim.py``'s tick bodies, ``kernels/provenance.py``,
``telemetry/query.py``'s blame engine) against the JAX package.

- ``run_composed(with_provenance=True)`` against the reference's on its
  own draws: the blame drill at smoke size (scatter, the reference's
  ``tests/test_provenance.py`` geometry), shift wide with ping-req
  members and SYNC on a chaos world from a seeded cold start (the seed
  exchange folds into the SYNC family), ``k_block`` on the int16 wire,
  and scatter under the compact carry from a seeded cold start with the
  open world's join (the seeds take the joiner's push the round it
  joins: JOIN_REBIRTH); the
  buffer (lanes, count, dropped), the final state and the stacked
  metrics exact;
- the cascade on the reference's hand-built keys, the record on its
  bursts (fast-path size, a big burst, overflow as an exact prefix),
  ``decode_attributions`` and ``attributions_payload``;
- the knob on against off in all three bodies (state and metrics);
- the blame engine on the drill's rows against the reference's;
- ``provenance_from_arrays`` / ``_to_arrays``, a chunked run resumed
  through ``ProvenancePlane(state=...)``, and a port journal's
  ``provenance`` records read by the reference's ``query.load_report``.

Cost: four reference programs at N = 16, lowered one after another and
compiled in the background at XLA's backend optimizations off (no delay
sums, so no FMA to keep).
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
from scalecube_cluster_tpu.models import compose as jcompose  # noqa: E402
from scalecube_cluster_tpu.models import provenance as jprov  # noqa: E402
from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu.ops import delivery as jdelivery  # noqa: E402
from scalecube_cluster_tpu.telemetry import query as jquery  # noqa: E402
from scalecube_cluster_tpu.telemetry import sink as jsink  # noqa: E402
from scalecube_cluster_tpu.telemetry.events import TraceEventType  # noqa: E402,E501
from scalecube_cluster_tpu_torch import interop  # noqa: E402
from scalecube_cluster_tpu_torch.kernels import provenance as kprov  # noqa: E402,E501
from scalecube_cluster_tpu_torch.models import compose, provenance, swim  # noqa: E402,E501
from scalecube_cluster_tpu_torch.ops import prng  # noqa: E402
from scalecube_cluster_tpu_torch.telemetry import query, sink  # noqa: E402
from tests.test_swim_model import fast_config  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    assert_metrics_equal, assert_state_equal, jax_draws, one_torch_thread,
    port_params, port_world)

pytestmark = pytest.mark.torchport

QUICK = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}
N, ROUNDS, CAPACITY = 16, 36, 4096
VICTIM, OBSERVER = 3, 11
# The join round: from the seeded cold start the seeds take the joiner's
# SYNC push the round it joins (JOIN_REBIRTH rows).
JOIN_AT = 30


def _params(**overrides):
    kw = dict(ping_every=2, ping_req_members=2, sync_interval=8,
              loss_probability=0.05, provenance=True)
    kw.update(overrides)
    return jswim.SwimParams.from_config(fast_config(), n_members=N, **kw)


def _chaos_world(params, seeds=()):
    """The reference test's chaos schedule: a crash, a leave, a crash and
    revival, a lossy link between the halves; under the open world the
    crashed slot 7 is joined by a new identity at ``JOIN_AT`` instead of
    reviving.  ``seeds``: the seed members of a cold start."""
    world = (jswim.SwimWorld.healthy(params)
             .with_crash(3, at_round=8)
             .with_leave(5, at_round=14))
    if seeds:
        world = world.with_seeds(list(seeds))
    if params.open_world:
        world = world.with_crash(7, at_round=5).with_join(7, JOIN_AT)
    else:
        world = world.with_crash(7, at_round=5, until_round=24)
    return world.with_link_fault((0, N // 2), (N // 2, N), loss=0.3,
                                 from_round=4, until_round=20)


def _drill():
    scen = jscenarios.blame_drill_scenario(
        7, n=N, victim=VICTIM, observer=OBSERVER, onset_round=16,
        pulse_rounds=64, cool_rounds=48)
    params = jswim.SwimParams.from_config(
        fast_config(), n_members=N, delivery="scatter",
        ping_known_only=False, ping_req_members=0, ping_every=1,
        sync_interval=8, provenance=True)
    world, _ = scen.build(params)
    return params, world, scen.horizon


SEEDS = (0, 1, 9)
# name -> (params overrides on the chaos world, rounds, seeds of a cold
# start or ()); None: the drill
CASES = {
    "drill-scatter": None,
    "shift-wide-pingreq-sync-seeds": (dict(delivery="shift"), ROUNDS,
                                      SEEDS),
    "k_block-int16_wire": (dict(delivery="shift", k_block=8,
                                int16_wire=True), ROUNDS, ()),
    "scatter-compact-join-seeds": (dict(compact_carry=True,
                                        open_world=True), 48, SEEDS),
}


def _case(name):
    """``(params, world, rounds)`` of a case (the reference's objects)."""
    if CASES[name] is None:
        return _drill()
    overrides, rounds, seeds = CASES[name]
    params = _params(**overrides)
    return params, _chaos_world(params, seeds), rounds


def _warm(name):
    return CASES[name] is None or not CASES[name][2]


def _program(name):
    """One case's reference program, lowered and compiled."""
    params, world, rounds = _case(name)
    return jcompose.run_composed.lower(
        jax.random.key(7), params, world, rounds, with_trace=False,
        with_metrics=False, with_monitor=False, with_provenance=True,
        provenance_capacity=CAPACITY,
        state=jswim.initial_state(params, world, warm=_warm(name))
    ).compile(compiler_options=QUICK)


@functools.lru_cache(maxsize=None)
def _programs():
    """Every reference program, each built in a thread of its own, so that
    the port's runs and the other programs' builds overlap a build; a
    case waits for its own program only."""
    pool = ThreadPoolExecutor(len(CASES))
    jobs = {name: pool.submit(_program, name) for name in CASES}
    pool.shutdown(wait=False)
    return jobs


@functools.lru_cache(maxsize=None)
def _draws(name):
    """The reference's draws of a case (one draw program a case)."""
    params, world, _ = _case(name)
    return jax_draws(jax.random.key(7), params, world)


@functools.lru_cache(maxsize=None)
def _both(name):
    """``(reference (state, results, metrics), port (...), port params,
    port world)`` of one case on the reference's draws."""
    params, world, rounds = _case(name)
    program = _programs()[name]
    p, w = port_params(params), port_world(world)
    port = compose.run_composed(
        0, p, w, rounds, with_trace=False, with_metrics=False,
        with_monitor=False, with_provenance=True,
        provenance_capacity=CAPACITY,
        state=swim.initial_state(p, w, warm=_warm(name), device="cpu"),
        draws=_draws(name), device="cpu")
    ref = program.result()(
        jax.random.key(7), world,
        state=jswim.initial_state(params, world, warm=_warm(name)))
    return ref, port, p, w


def _assert_buffer_equal(jpv, pv):
    for name in ("lanes", "count", "dropped"):
        want = np.asarray(getattr(jpv, name))
        got = getattr(pv, name).cpu().numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("name", list(CASES))
def test_run_composed_matches_reference(name):
    """The provenance buffer, the final state and the stacked metrics equal
    the reference's; each case records, drops nothing, and sees the
    channels its world was built for."""
    (jstate, jres, jm), (state, res, m), _, _ = _both(name)
    assert_state_equal(jstate, state)
    assert_metrics_equal(jm, m)
    _assert_buffer_equal(jres["provenance"], res["provenance"])
    pv = res["provenance"]
    assert int(pv.count) > 0 and int(pv.dropped) == 0
    channels = {r["channel"] for r in provenance.decode_attributions(pv)}
    want = {"drill-scatter": {"fd_direct", "gossip", "self_refutation"},
            "shift-wide-pingreq-sync-seeds": {"gossip", "sync"},
            "k_block-int16_wire": {"gossip", "sync"},
            "scatter-compact-join-seeds": {"gossip", "sync",
                                           "join_rebirth"}}[name]
    assert want <= channels, channels


def test_drill_first_sighting_is_first_hand():
    """The planted link's observer is the only first-hand sighting of the
    victim; everyone else heard it second-hand, and the victim refuted
    by itself (the reference's ``_check_drill``)."""
    _, (_, res, _), _, _ = _both("drill-scatter")
    rows = provenance.decode_attributions(res["provenance"])
    sightings = [r for r in rows if r["subject"] == VICTIM
                 and r["transition"] == "SUSPECTED"]
    first = min(sightings, key=lambda r: (r["round"], r["observer"]))
    assert (first["observer"], first["channel"]) == (OBSERVER, "fd_direct")
    assert all(r["channel"] in ("gossip", "sync") for r in sightings
               if r["observer"] != OBSERVER)
    refutes = [r for r in rows if r["transition"] == "ALIVE_REFUTED"
               and r["observer"] == VICTIM and r["subject"] == VICTIM]
    assert refutes and all(r["channel"] == "self_refutation"
                           for r in refutes)


def test_blame_engine_matches_reference():
    """``blame_report``, ``channel_mix``, ``provenance_slos``,
    ``infection_paths`` and ``explain_belief`` give the reference's
    answers on the drill's rows; the verdict names the planted
    observer."""
    _, (_, res, _), _, _ = _both("drill-scatter")
    rows = provenance.decode_attributions(res["provenance"])
    report = query.blame_report(rows, VICTIM)
    assert report == jquery.blame_report(rows, VICTIM)
    assert (report["origin_observer"], report["origin_channel"],
            report["origin_first_hand"]) == (OBSERVER, "fd_direct", True)
    assert query.blame_report(rows, 15) == jquery.blame_report(rows, 15)
    mix = query.channel_mix(rows)
    assert mix == jquery.channel_mix(rows)
    assert sum(mix.values()) == pytest.approx(1.0, abs=1e-12)
    assert query.provenance_slos(rows) == jquery.provenance_slos(rows)
    assert query.infection_paths(rows, VICTIM) == jquery.infection_paths(
        rows, VICTIM)
    for rnd in (None, report["onset_round"], 0):
        assert query.explain_belief(rows, OBSERVER, VICTIM, rnd) == \
            jquery.explain_belief(rows, OBSERVER, VICTIM, rnd)
    answer = query.explain_belief(rows, OBSERVER, VICTIM,
                                  report["onset_round"])["answer"]
    assert (answer["channel"], answer["round"]) == ("fd_direct",
                                                    report["onset_round"])
    assert query.channel_mix([]) == {} and query.PROVENANCE_OVERHEAD_LIMIT \
        == jquery.PROVENANCE_OVERHEAD_LIMIT


# --------------------------------------------------------------------------
# The cascade and the record, function to function
# --------------------------------------------------------------------------


CASCADE = [  # (param overrides, fd, gossip, sync, code, ping_req, join)
    ({}, -1, (1, 3), -1, None, False, False),
    ({}, -1, (1, 3), (1, 3), None, False, False),
    ({}, -1, (1, 4), (1, 3), None, False, False),
    (dict(ping_req_members=0), (1, 3), (1, 3), (1, 3), None, False, False),
    (dict(ping_req_members=2), (1, 3), -1, -1, None, False, False),
    (dict(ping_req_members=2), (1, 3), -1, -1, None, True, False),
    (dict(ping_req_members=0), (1, 3), -1, -1, None, True, False),
    ({}, -1, (1, 3), -1, "REMOVED", False, False),
    ({}, -1, (2, 3), -1, "REMOVED", False, False),
    ({}, (0, 0), (0, 0), (0, 0), None, False, True),
    ({}, -1, -1, -1, None, False, False),
    (dict(int16_wire=True), -1, (2, 5), (1, 5), "REMOVED", False, False),
    (dict(open_world=True), (1, 2), (0, 9), -1, None, False, False),
]


def _key(params, rec):
    if rec == -1:
        return -1
    return int(jdelivery.pack_record(
        jnp.int8(rec[0]), jnp.int32(rec[1]), epoch_bits=params.epoch_bits,
        fmt=params.wire_format))


@pytest.mark.parametrize("case", range(len(CASCADE)))
def test_attribute_channels_matches_reference(case):
    """The cascade on the reference test's hand-built one-cell keys
    (gossip alone; SYNC over GOSSIP on a tie, not under a greater gossip
    key; FD over both; the ping-req split only with proxies; a REMOVED
    with and without a DEAD winner; join-rebirth over all; no evidence),
    on the int16 wire and under epoch-extended keys."""
    overrides, fd, gossip, sync, code, ping_req, join = CASCADE[case]
    jparams = _params(**overrides)
    code = int(TraceEventType[code or "SUSPECTED"]) + 1
    keys = {name: _key(jparams, rec) for name, rec in
            (("fd", fd), ("gossip", gossip), ("sync", sync))}
    wire = jparams.wire_format.dtype
    jprov_in = dict({k: jnp.full((1, 1), v, wire) for k, v in keys.items()},
                    ping_req=jnp.full((1,), ping_req, jnp.bool_))
    want = np.asarray(jprov.attribute_channels(
        jparams, jprov_in, jnp.full((1, 1), code, jnp.int8),
        jnp.full((1, 1), join, jnp.bool_)))
    params = port_params(jparams)
    dtype = params.wire_format.dtype
    got = provenance.attribute_channels(
        params, dict({k: torch.full((1, 1), v, dtype=dtype)
                      for k, v in keys.items()},
                     ping_req=torch.full((1,), ping_req)),
        torch.full((1, 1), code, dtype=torch.int8),
        torch.full((1, 1), join))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def _burst(seed, n, k, density=0.2):
    rng = np.random.default_rng(seed)
    codes = np.where(rng.random((n, k)) < density,
                     rng.integers(1, 6, (n, k)), 0).astype(np.int8)
    return (codes, rng.integers(0, 6, (n, k)).astype(np.int8),
            rng.integers(0, 4, (n, k)).astype(np.int32))


_jax_record = jax.jit(jprov.record_attributions,
                      static_argnames=("observer_offset",))

BURSTS = {  # name -> (n, k, capacity, [(seed, density)], offset)
    "fast_path": (12, 12, 512, [(r, 0.2) for r in range(4)], 0),
    "big_burst": (32, 32, 2048, [(None, 1.0)], 0),
    "overflow_prefix": (8, 8, 12, [(100 + r, 0.15) for r in range(3)], 5),
}


@pytest.mark.parametrize("name", list(BURSTS))
def test_record_attributions_matches_reference(name):
    """``record_attributions`` on the reference test's bursts (rounds
    under the fast-path window, a burst beyond it, a small buffer
    overflowing into its last window) gives the reference's lanes, count
    and dropped, the observer offset included; then
    ``decode_attributions`` and ``attributions_payload`` its rows."""
    n, k, cap, bursts, offset = BURSTS[name]
    jpv = jprov.ProvenanceState.empty(cap)
    pv = provenance.ProvenanceState.empty(cap)
    subjects = np.arange(k, dtype=np.int32)[::-1].copy()
    for r, (seed, density) in enumerate(bursts):
        if seed is None:
            burst = (np.ones((n, k), np.int8), np.zeros((n, k), np.int8),
                     np.zeros((n, k), np.int32))
        else:
            burst = _burst(seed, n, k, density)
        jpv = _jax_record(
            jpv, jnp.int32(r), *(jnp.asarray(x) for x in burst),
            jnp.asarray(subjects), observer_offset=offset)
        out = provenance.record_attributions(
            pv, r, *(torch.from_numpy(x) for x in burst),
            torch.from_numpy(subjects), observer_offset=offset)
        assert out is pv
        _assert_buffer_equal(jpv, pv)
    assert int(pv.count) > 0
    if name == "overflow_prefix":
        assert int(pv.count) == cap and int(pv.dropped) > 0
    assert provenance.decode_attributions(pv) == \
        jprov.decode_attributions(jpv)
    assert provenance.attributions_payload(pv) == \
        jprov.attributions_payload(jpv)


def test_observe_plain_version_matches_composition():
    """The kernel's plain version (one call a round) gives the rows of
    ``round_channel_records`` + ``record_attributions`` on the shift
    case's last round, and the plane's constants are the reference's."""
    _, _, p, w = _both("shift-wide-pingreq-sync-seeds")
    draws = _draws("shift-wide-pingreq-sync-seeds")
    state, _ = swim.run(0, p, w, 9, draws=draws, device="cpu")
    want = provenance.ProvenanceState.empty(256)
    got = provenance.ProvenanceState.empty(256)
    for r in range(9, 12):
        new, m = swim.swim_tick(state, r, p, w, draws(r))
        rc = compose.RoundCtx(p, w, swim.Knobs.from_params(p), r, state,
                              new, m, provenance=m.pop("_provenance"))
        provenance.record_attributions(
            want, r, *provenance.round_channel_records(rc), w.subject_ids)
        provenance.observe_round(got, rc)
        state = new
    assert int(got.count) > 0
    for name in ("lanes", "count", "dropped"):
        assert torch.equal(getattr(got, name), getattr(want, name))
    assert provenance.CHANNEL_NAMES == jprov.CHANNEL_NAMES
    assert (provenance.DEFAULT_CAPACITY, provenance.COMPACT_WINDOW) == (
        jprov.DEFAULT_CAPACITY, jprov.COMPACT_WINDOW)
    assert [getattr(provenance, f"CH_{c.upper()}") for c in
            jprov.CHANNEL_NAMES] == list(range(6))
    with pytest.raises(ValueError, match="provenance=True"):
        provenance.observe_round(
            got, compose.RoundCtx(p, w, None, 0, state, new, m))
    with pytest.raises(TypeError, match="int32 or torch.int16"):
        kprov.provenance_observe(
            got.lanes, got.count, got.dropped, state.status, new.status,
            *(torch.zeros(state.status.shape, dtype=torch.int8),) * 3,
            rc.provenance["ping_req"], state.self_inc, new.self_inc,
            w.leave_at, w.join_at, w.subject_ids, 0)


# --------------------------------------------------------------------------
# The off-switch, resume, interop, journals
# --------------------------------------------------------------------------


@pytest.mark.parametrize("overrides", [
    dict(delivery="scatter"), dict(delivery="shift"),
    dict(delivery="shift", k_block=8)], ids=["scatter", "shift", "k_block"])
def test_knob_on_is_knob_off(overrides):
    """Arming the knob changes no state and no metric in any tick body
    (the exposure is built beside the inbox), and the metrics carry no
    exposure key; without the plane the runner drops it."""
    jparams = _params(**overrides)
    on = port_params(jparams)
    off = dataclasses.replace(on, provenance=False)
    world = port_world(_chaos_world(jparams))
    s_on, m_on = swim.run(0, on, world, 20, draws=prng.TorchDraws(
        5, "cpu", on, world), device="cpu")
    s_off, m_off = swim.run(0, off, world, 20, draws=prng.TorchDraws(
        5, "cpu", off, world), device="cpu")
    for field in dataclasses.fields(swim.SwimState):
        assert torch.equal(getattr(s_on, field.name),
                           getattr(s_off, field.name)), field.name
    assert set(m_on) == set(m_off) and "_provenance" not in m_on
    for k in m_on:
        assert torch.equal(m_on[k], m_off[k]), k


def test_chunked_resume_and_interop_round_trip():
    """Two chunks resumed through ``ProvenancePlane(state=...)`` give the
    unbroken run's buffer (the caller's state untouched), and the buffer
    crosses ``provenance_to_arrays`` / ``provenance_from_arrays`` both
    ways, the reference's ``ProvenanceState`` included."""
    _, (_, res, _), p, w = _both("shift-wide-pingreq-sync-seeds")
    draws = _draws("shift-wide-pingreq-sync-seeds")
    split = 20
    state, first, _ = compose.run_composed(
        0, p, w, split, with_trace=False, with_metrics=False,
        with_monitor=False, with_provenance=True,
        provenance_capacity=CAPACITY,
        state=swim.initial_state(p, w, warm=False, device="cpu"),
        draws=draws, device="cpu")
    held = first["provenance"].clone()
    _, second, _ = compose.run_composed(
        0, p, w, ROUNDS - split, with_trace=False, with_metrics=False,
        with_monitor=False, with_provenance=True, state=state,
        start_round=split, provenance=first["provenance"], draws=draws,
        device="cpu")
    for name in ("lanes", "count", "dropped"):
        assert torch.equal(getattr(first["provenance"], name),
                           getattr(held, name))
        assert torch.equal(getattr(second["provenance"], name),
                           getattr(res["provenance"], name))
    arrays = interop.provenance_to_arrays(res["provenance"])
    back = interop.provenance_from_arrays(arrays, device="cpu")
    for name in ("lanes", "count", "dropped"):
        assert torch.equal(getattr(back, name),
                           getattr(res["provenance"], name))
    jpv = jprov.ProvenanceState(**{k: jnp.asarray(v)
                                   for k, v in arrays.items()})
    assert jprov.decode_attributions(jpv) == \
        provenance.decode_attributions(back)
    with pytest.raises(ValueError, match="int32"):
        interop.provenance_from_arrays(
            dict(arrays, count=arrays["count"].astype(np.int64)),
            device="cpu")
    with pytest.raises(KeyError, match="dropped"):
        interop.provenance_from_arrays(
            {k: arrays[k] for k in ("lanes", "count")}, device="cpu")


def test_plane_requires_knob_and_journal_reads_in_reference(tmp_path):
    """``ProvenancePlane.init`` raises the reference's ``ValueError`` with
    the knob off; a port journal's ``provenance`` records (two chunks)
    are the rows the reference's ``read_provenance`` and
    ``query.load_report`` read back."""
    p = port_params(_params())
    with pytest.raises(ValueError, match="provenance=True"):
        provenance.ProvenancePlane().init(
            dataclasses.replace(p, provenance=False),
            swim.SwimWorld.healthy(p, device="cpu"))
    _, (_, res, _), _, _ = _both("drill-scatter")
    payload = provenance.attributions_payload(res["provenance"])
    path = str(tmp_path / "journal.jsonl")
    with sink.TelemetrySink(path=path) as journal:
        journal.write_provenance(payload, batch=40)
    rows, acct = jsink.read_provenance(path)
    assert rows == payload["rows"] and acct == dict(
        recorded=payload["recorded"], dropped=0, capacity=CAPACITY)
    assert jquery.load_report(path).provenance == payload["rows"]
    assert sink.read_provenance(path) == (rows, acct)
