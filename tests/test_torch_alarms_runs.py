"""``stream_metered_run(..., alarm_specs=...)`` against the JAX package:
``bench.py --alarms --smoke``'s drill (``bench.py:2297-2313``: N = 24,
16-round windows, a loss-0.8 pulse over rounds [48, 96), 64 cool rounds,
threshold ``SMOKE_ALARM_THRESHOLD`` 1.18, seed 7) on the reference's
world and draws (``torch_port_helpers.jax_draws``), both arms.  Every
``metrics_window`` and ``alarm_transition`` row of the port's journal
equals the reference's, run ids aside; a journal cut after a window and
resumed in append mode ends with every row exactly once.  Exact, no
tolerance.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from scalecube_cluster_tpu.chaos import campaign as jcampaign  # noqa: E402
from scalecube_cluster_tpu.chaos import scenarios as jscenarios  # noqa: E402
from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu.telemetry import alarms as jalarms  # noqa: E402
from scalecube_cluster_tpu.telemetry import metrics as jmetrics  # noqa: E402
from scalecube_cluster_tpu.telemetry import sink as jsink  # noqa: E402
from scalecube_cluster_tpu_torch.models import swim  # noqa: E402
from scalecube_cluster_tpu_torch.telemetry import alarms  # noqa: E402
from scalecube_cluster_tpu_torch.telemetry import metrics, sink  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    jax_draws, one_torch_thread, port_params, port_world)

pytestmark = pytest.mark.torchport

SEED, N, WINDOW, ONSET, PULSE, COOL, LOSS, THRESHOLD = (
    7, 24, 16, 48, 48, 64, 0.8, 1.18)
KINDS = ("metrics_window", jalarms.TRANSITION_KIND)


@functools.lru_cache(maxsize=None)
def _drill():
    scen = jscenarios.alarm_drill_scenario(
        SEED, n=N, pulse_loss=LOSS, onset_round=ONSET, pulse_rounds=PULSE,
        cool_rounds=COOL)
    jparams = jswim.SwimParams.from_config(
        jcampaign.campaign_config(), n_members=N, delivery="scatter",
        ping_known_only=False)
    jworld, _ = scen.build(jparams)
    return scen, jparams, jworld


def _knobs(arm, pkg_swim, params, breach):
    return (pkg_swim.Knobs.from_params(params) if arm == "healthy"
            else breach(None, params))


def _rows(path):
    return [{k: v for k, v in r.items() if k != "run_id"}
            for r in jsink.read_records(path) if r["kind"] in KINDS]


@functools.lru_cache(maxsize=None)
def _reference_rows(arm, tmp):
    scen, jparams, jworld = _drill()
    path = f"{tmp}/ref_{arm}.jsonl"
    with jsink.TelemetrySink(path=path) as s:
        jmetrics.stream_metered_run(
            jax.random.key(SEED), jparams, jworld, scen.horizon, sink=s,
            window_rounds=WINDOW,
            alarm_specs=jalarms.default_specs(threshold=THRESHOLD),
            knobs=_knobs(arm, jswim, jparams, jcampaign.alarm_breach_knobs))
    return tuple(_rows(path))


def _port_stream(arm, path, n_rounds, append=False):
    from scalecube_cluster_tpu_torch.chaos import campaign

    _, jparams, jworld = _drill()
    params, world = port_params(jparams), port_world(jworld)
    with sink.TelemetrySink(path=path, append=append) as s:
        return metrics.stream_metered_run(
            SEED, params, world, n_rounds, sink=s, window_rounds=WINDOW,
            alarm_specs=alarms.default_specs(threshold=THRESHOLD),
            knobs=_knobs(arm, swim, params, campaign.alarm_breach_knobs),
            draws=_draws(), device="cpu")


@functools.lru_cache(maxsize=None)
def _draws():
    _, jparams, jworld = _drill()
    return jax_draws(jax.random.key(SEED), jparams, jworld)


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("alarm_ref"))


@pytest.mark.parametrize("arm", ["healthy", "breach"])
def test_drill_journal_matches_reference(arm, ref_dir, tmp_path):
    """Each arm's journal: every ``metrics_window`` and ``alarm_transition``
    row equal to the reference's, run ids aside; the breach arm fires
    within one window of the onset and resolves after the heal, as in
    the reference."""
    scen, _, _ = _drill()
    want = list(_reference_rows(arm, ref_dir))
    path = str(tmp_path / f"{arm}.jsonl")
    _, rows = _port_stream(arm, path, scen.horizon)
    assert _rows(path) == want
    assert [{"kind": "metrics_window", **r} for r in rows] == [
        r for r in want if r["kind"] == "metrics_window"]
    fired = [r for r in want if r["kind"] == alarms.TRANSITION_KIND
             and r["to"] == "firing"]
    if arm == "breach":
        assert (fired[0]["round_end"] - ONSET) / WINDOW <= 1
        assert any(r["to"] == "resolved" and r["round_end"] >= ONSET + PULSE
                   for r in want if r["kind"] == alarms.TRANSITION_KIND)
    else:
        assert not fired


@pytest.mark.parametrize("cut_windows", [2, 5])
def test_resumed_journal_writes_each_row_once(cut_windows, ref_dir,
                                              tmp_path):
    """The breach arm's journal cut after ``cut_windows`` windows (window
    2; window 5, past the firing transition of window 4) and resumed in
    append mode to the horizon: the reference's rows, each exactly
    once."""
    scen, _, _ = _drill()
    want = list(_reference_rows("breach", ref_dir))
    path = str(tmp_path / "cut.jsonl")
    _port_stream("breach", path, cut_windows * WINDOW)
    cut = _rows(path)
    assert cut == want[:len(cut)]
    assert sum(r["kind"] == "metrics_window" for r in cut) == cut_windows
    assert any(r["kind"] == alarms.TRANSITION_KIND
               for r in cut) == (cut_windows > 4)
    _port_stream("breach", path, scen.horizon, append=True)
    assert _rows(path) == want


def test_alarm_specs_need_a_sink():
    """``alarm_specs`` without a sink raises the reference's error."""
    _, jparams, jworld = _drill()
    with pytest.raises(ValueError) as want:
        jmetrics.stream_metered_run(
            jax.random.key(SEED), jparams, jworld, 1,
            alarm_specs=jalarms.default_specs())
    with pytest.raises(ValueError) as got:
        metrics.stream_metered_run(
            SEED, port_params(jparams), port_world(jworld), 1,
            alarm_specs=alarms.default_specs(), device="cpu")
    assert str(got.value) == str(want.value)
