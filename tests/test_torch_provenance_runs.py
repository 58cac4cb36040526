"""The port's provenance plane against the JAX package, whole runs:
``run_composed`` with the trace, registry and provenance plane in four
configurations (the blame drill under scatter, shift wide with ping-req
and SYNC from a seeded cold start, ``k_block`` on the int16 wire, scatter
compact with a join), the drill's first-hand sighting, the blame engine,
the observe plain version against the composition, a chunked resume and
interop, and the plane's knob and journal.  The cases and the reference's
programs are ``tests/test_torch_provenance.py``'s.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from scalecube_cluster_tpu.models import provenance as jprov  # noqa: E402
from scalecube_cluster_tpu.telemetry import query as jquery  # noqa: E402
from scalecube_cluster_tpu.telemetry import sink as jsink  # noqa: E402
from scalecube_cluster_tpu_torch import interop  # noqa: E402
from scalecube_cluster_tpu_torch.kernels import provenance as kprov  # noqa: E402,E501
from scalecube_cluster_tpu_torch.models import compose, provenance, swim  # noqa: E402,E501
from scalecube_cluster_tpu_torch.telemetry import query, sink  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    assert_metrics_equal, assert_state_equal, one_torch_thread, port_params)
from tests.test_torch_provenance import (  # noqa: E402,F401
    CAPACITY, CASES, OBSERVER, ROUNDS, VICTIM, _assert_buffer_equal, _both,
    _draws, _params)

pytestmark = pytest.mark.torchport


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
