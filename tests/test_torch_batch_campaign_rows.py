"""The port's bucketed campaign against its serial campaign, row by row:
``run_campaign_vmapped`` gives the serial ``run_campaign``'s verdict rows
(its journal the reference's record kinds with one ``chaos_bucket`` row a
bucket), and ``run_weakened_slice`` the serial weakened runs' code
totals and first red row, on three rows of a ``generate_fuzz_campaign``
list at N = 16 (buckets of two and one).  The list is
``tests/test_torch_batch_campaign.py``'s.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scalecube_cluster_tpu_torch.chaos import campaign  # noqa: E402
from scalecube_cluster_tpu_torch.chaos import monitor  # noqa: E402
from scalecube_cluster_tpu_torch.telemetry import sink  # noqa: E402
from tests.torch_port_helpers import one_torch_thread  # noqa: E402,F401
from tests.test_torch_batch_campaign import (  # noqa: E402,F401
    N, ROWS, SEED, _buckets, _rows, _serial)

pytestmark = pytest.mark.torchport


def test_campaign_vmapped_rows_equal_serial_verdicts(tmp_path):
    """Each bucketed row's verdict row equals the serial run's; the
    journal holds a manifest, one ``chaos_bucket`` row a bucket, the
    scenario rows and the summary."""
    path = tmp_path / "fuzz.jsonl"
    with sink.TelemetrySink(path=str(path)) as journal:
        result = campaign.run_campaign_vmapped(
            _rows(), seed=SEED, buckets=_buckets(), sink=journal,
            device="cpu")
    for got, want in zip(result.verdicts, _serial()):
        assert got.to_json() == want.to_json(), want.scenario.name
    rows = sink.read_records(str(path))
    kinds = [r["kind"] for r in rows]
    assert kinds[:3] == ["manifest", "chaos_bucket", "chaos_bucket"]
    assert kinds[-1] == "chaos_verdict"
    assert kinds[3:-1] == ["chaos_scenario"] * len(ROWS)
    assert [r["scenarios"] for r in rows[1:3]] == [2, 1]
    assert result.buckets == [{"scenarios": 2, "n_members": N,
                               "horizon": 192},
                              {"scenarios": 1, "n_members": N,
                               "horizon": _rows()[1].horizon}]


def test_weakened_slice_equals_serial_weakened_runs():
    """The coverage arm's code totals over the completeness-promising
    rows and its first red row equal the serial weakened runs'."""
    cov, counts, first_red = campaign.run_weakened_slice(_buckets())
    serial = _serial(weakened=True)
    want = np.zeros(monitor.N_CODES, np.int64)
    for i in sorted(cov):
        want += np.array([serial[i].verdict["codes"][c.name]["violations"]
                          for c in monitor.InvariantCode])
    assert cov and cov <= set(range(len(ROWS)))
    np.testing.assert_array_equal(counts, want)
    assert counts[monitor.InvariantCode.COMPLETENESS] > 0
    reds = [i for b in _buckets() for i in b.indices
            if i in cov and not serial[i].green]
    assert first_red == reds[0]
