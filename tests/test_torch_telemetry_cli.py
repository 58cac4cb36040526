"""The port's telemetry CLI (``python -m
scalecube_cluster_tpu_torch.telemetry``) against the JAX package's, run
in-process: each subcommand (``report``, ``diff``, ``watch``,
``explain``, ``regress``), in its ``--json`` and its table form, over the
committed journals and artifacts and over a journal the port writes,
prints what the reference prints and exits with its code; so do the
input errors (exit 2) and a failing regress (exit 1).  One subprocess
runs ``report`` with ``jax`` and the JAX package blocked.  Everything is
compared exactly, byte for byte.
"""

import contextlib
import functools
import io
import json
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from scalecube_cluster_tpu.telemetry import __main__ as jcli  # noqa: E402
from scalecube_cluster_tpu_torch.config import ClusterConfig  # noqa: E402
from scalecube_cluster_tpu_torch.models import swim  # noqa: E402
from scalecube_cluster_tpu_torch.telemetry import __main__ as cli  # noqa: E402
from scalecube_cluster_tpu_torch.telemetry import alarms, metrics  # noqa: E402
from scalecube_cluster_tpu_torch.telemetry import sink  # noqa: E402
from tests.torch_port_helpers import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torchport

BREACH = "artifacts/alarm_drill_breach.jsonl"
HEALTHY = "artifacts/alarm_drill_healthy.jsonl"
BLAME = "artifacts/provenance_blame_journal_smoke.jsonl"
SOAK = "artifacts/soak_journal_smoke.jsonl"


def _run(main, argv):
    """``main(argv)``'s exit code, standard output and standard error."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def _same(argv):
    """Run both CLIs on ``argv`` and hold the port's to the reference's;
    returns the reference's result."""
    want = _run(jcli.main, argv)
    assert _run(cli.main, argv) == want, argv
    return want


@functools.lru_cache(maxsize=None)
def _port_journal(directory):
    """A journal the port writes: 16 members at loss 0.3 with a crash,
    four 20-round metrics windows under a live alarm at a threshold they
    cross, and a summary."""
    cfg = ClusterConfig.default().replace(
        gossip_interval=100, ping_interval=200, ping_timeout=100,
        sync_interval=1_000, suspicion_mult=3)
    params = swim.SwimParams.from_config(cfg, 16, delivery="shift",
                                         loss_probability=0.3)
    world = swim.SwimWorld.healthy(params, device="cpu").with_crash(
        3, at_round=5)
    path = f"{directory}/port.jsonl"
    specs = alarms.default_specs(threshold=0.05)
    with sink.TelemetrySink(path=path) as s:
        s.write_manifest(params, label="cli parity")
        metrics.stream_metered_run(0, params, world, 80, sink=s,
                                   window_rounds=20, alarm_specs=specs,
                                   device="cpu")
        s.write_summary(metric="cli_parity")
    return path


@pytest.fixture(scope="module")
def port_journal(tmp_path_factory):
    return _port_journal(str(tmp_path_factory.mktemp("cli")))


def test_report_matches_reference(port_journal):
    """``report`` of one journal, of several merged, with and without
    ``--json`` and ``--windows``."""
    for paths in ([BREACH], [HEALTHY, BREACH], [SOAK], [port_journal],
                  [BLAME, port_journal]):
        for flags in ([], ["--json"], ["--windows"],
                      ["--json", "--windows"]):
            rc, out, _ = _same(["report", *paths, *flags])
            assert rc == 0 and out
    rc, out, _ = _same(["report", "--json", port_journal])
    assert json.loads(out)["counters"]


def test_diff_matches_reference(port_journal):
    """``diff`` of the drill's two arms and of the port's journal against
    a committed one, both forms."""
    for a, b in ((HEALTHY, BREACH), (port_journal, BREACH),
                 (SOAK, port_journal)):
        for flags in ([], ["--json"]):
            rc, out, _ = _same(["diff", a, b, *flags])
            assert rc == 0 and out


def test_watch_matches_reference(port_journal):
    """``watch --max-seconds 0`` over finished journals (a summary ends
    it; without one the single poll does), with the default specs,
    another threshold and 2-window hysteresis, both forms: the same
    windows, engine transitions, journaled transitions, unrendered kinds
    and alarm table."""
    for path in (BREACH, HEALTHY, BLAME, SOAK, port_journal):
        for flags in ([], ["--threshold", "1.2", "--for-windows", "2",
                           "--clear-windows", "2"]):
            for form in ([], ["--json"]):
                _same(["watch", path, "--max-seconds", "0", "--interval",
                       "0", *flags, *form])
    rc, out, _ = _same(["watch", port_journal, "--json", "--max-seconds",
                        "0", "--threshold", "0.05"])
    lines = [json.loads(line) for line in out.splitlines()]
    engine = [t for line in lines if line["kind"] == "window"
              for t in line["transitions"]]
    journaled = [{k: v for k, v in line.items() if k != "kind"}
                 for line in lines if line["kind"] == "journal_transition"]
    assert rc == 0 and lines[-1]["run_ended"]
    assert engine and [dict(t, run_id=None) for t in engine] == [
        dict(t, run_id=None) for t in journaled]


def test_explain_matches_reference():
    """``explain`` on the committed blame journal for the planted
    subject from several observers, at a round and without one, both
    forms."""
    for observer in (0, 3, 11, 15):
        for extra in ([], ["--round", "40"]):
            for form in ([], ["--json"]):
                rc, out, _ = _same(["explain", BLAME, "--observer",
                                    str(observer), "--subject", "11",
                                    *extra, *form])
                assert rc == 0 and out


def test_regress_matches_reference():
    """``regress`` over the default globs and given paths, both forms,
    and at a band that fails checks (exit 1)."""
    rc, out, _ = _same(["regress", "--json"])
    assert rc == 0 and json.loads(out)["ok"]
    _same(["regress"])
    rc, _, _ = _same(["regress", "BENCH_*.json", "MULTICHIP_*.json",
                      "artifacts/*.json", "--band", "0.0"])
    assert rc == 1
    _same(["regress", "MULTICHIP_*.json", "--json", "--band", "0.3"])


def test_input_errors_match_reference(tmp_path, port_journal):
    """Exit 2 with the reference's message: a missing journal, a
    malformed one, ``explain`` on a journal without provenance, a regress
    that matches nothing."""
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"kind": "histogram", "run_id": "x"}) + "\n")
    for argv in (["report", str(tmp_path / "missing.jsonl")],
                 ["diff", BREACH, str(tmp_path / "missing.jsonl")],
                 ["report", str(bad)],
                 ["explain", port_journal, "--observer", "0", "--subject",
                  "3"],
                 ["regress", str(tmp_path / "none_*.json")]):
        rc, _, err = _same(argv)
        assert rc == 2 and err, argv


def test_report_runs_with_jax_blocked():
    """``python -m scalecube_cluster_tpu_torch.telemetry report --json``
    in a process where importing jax or the JAX package fails: exit 0
    and the reference's output."""
    code = "\n".join([
        "import runpy, sys",
        "for blocked in ('jax', 'jaxlib', 'scalecube_cluster_tpu'):",
        "    sys.modules[blocked] = None",
        f"sys.argv = ['telemetry', 'report', '--json', {BREACH!r}]",
        "runpy.run_module('scalecube_cluster_tpu_torch.telemetry',"
        " run_name='__main__')",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout == _run(jcli.main, ["report", "--json", BREACH])[1]
