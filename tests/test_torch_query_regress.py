"""The port's ``regress`` gate (``telemetry/query.py``: ``expand_paths``,
``load_bench_payload``, ``regress``) against the JAX package's, over the
committed ``BENCH_*.json``, ``MULTICHIP_*.json`` and ``artifacts/*.json``
and over seeded mutations of them (numbers scaled, flags flipped, runs
marked failed or smoke), so that every check passes and fails in both.
Verdicts, rows and skip notes are equal exactly; where the reference
raises, the port raises the same exception type and message.
"""

import json
import os

import numpy as np
import pytest

from scalecube_cluster_tpu.telemetry import query as jquery
from scalecube_cluster_tpu_torch.telemetry import query

pytestmark = pytest.mark.torchport

GLOBS = ["BENCH_*.json", "MULTICHIP_*.json", "artifacts/*.json"]


def _outcome(fn, *args, **kwargs):
    """``("ok", result)`` or ``("raised", type name, message)``."""
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 - compared across packages
        return ("raised", type(e).__name__, str(e))


def test_expand_paths_matches_reference(tmp_path):
    """Globs, literal paths (missing ones kept), overlaps and repeats give
    the reference's sorted, de-duplicated list."""
    cases = [GLOBS, ["artifacts/*.json", "artifacts/alarm_*.json"],
             ["BENCH_r05.json", "BENCH_r0*.json", "no/such/file.json",
              "no/such/*.json", "BENCH_r05.json"], [],
             [str(tmp_path / "*.json")]]
    for patterns in cases:
        assert query.expand_paths(patterns) == jquery.expand_paths(patterns)
    assert len(query.expand_paths(GLOBS)) > 30


def test_load_bench_payload_matches_reference(tmp_path):
    """Every committed artifact's ``(payload, skip_note)``, and the
    wrapper forms: a failed round, a legacy stub, a null parse, a bare
    payload without measurement fields, and unreadable JSON."""
    paths = query.expand_paths(GLOBS)
    extra = {"failed.json": {"rc": 1, "parsed": {"value": 3.0}},
             "stub.json": {"rc": 0, "ok": True},
             "null.json": {"rc": 0, "parsed": None},
             "bare.json": {"metric": "x", "unit": "y"},
             "ratio.json": {"metric": "x", "fp_ratio": 0.4}}
    for name, doc in extra.items():
        (tmp_path / name).write_text(json.dumps(doc))
        paths.append(str(tmp_path / name))
    (tmp_path / "bad.json").write_text("{not json")
    paths.append(str(tmp_path / "bad.json"))
    skipped = 0
    for path in paths:
        want = _outcome(jquery.load_bench_payload, path)
        assert _outcome(query.load_bench_payload, path) == want, path
        skipped += want[0] == "ok" and want[1][0] is None
    assert skipped >= 4


@pytest.mark.parametrize("band", [query.DEFAULT_NOISE_BAND, 0.0, 0.5])
def test_regress_over_committed_artifacts_matches_reference(band):
    """``regress`` over every committed artifact at the default band, no
    band and a wide one: the verdict and every row equal the
    reference's (the no-band walk fails checks, the default passes)."""
    paths = query.expand_paths(GLOBS)
    want = jquery.regress(paths, band=band)
    assert query.regress(paths, band=band) == want
    assert len(want[1]) > 50
    if band == 0.0:
        assert not want[0]
    if band == query.DEFAULT_NOISE_BAND:
        assert want[0]


def _mutate(value, rng):
    """A copy of a JSON document with its numbers scaled (by 0, 0.5, 2 or
    -1), its flags flipped and its nulls kept, each leaf with probability
    1/4."""
    if isinstance(value, dict):
        return {k: _mutate(v, rng) for k, v in value.items()}
    if isinstance(value, list):
        return [_mutate(v, rng) for v in value]
    if rng.random() >= 0.25:
        return value
    if isinstance(value, bool):
        return not value
    if isinstance(value, (int, float)):
        scaled = value * float(rng.choice([0.0, 0.5, 2.0, -1.0]))
        return int(scaled) if isinstance(value, int) else scaled
    return value


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_regress_over_mutated_artifacts_matches_reference(seed, tmp_path):
    """Each committed artifact copied with seeded mutations (one in five
    also wrapped as a failed or smoke round): both packages give the
    same verdict and rows (or raise alike), over the whole set and over
    each series alone, and some mutation fails a check."""
    rng = np.random.default_rng(seed)
    paths = []
    for path in query.expand_paths(GLOBS):
        with open(path) as f:
            doc = json.load(f)
        doc = _mutate(doc, rng)
        if isinstance(doc, dict) and rng.random() < 0.2:
            doc = (dict(doc, smoke=True) if rng.random() < 0.5
                   else {"rc": int(rng.integers(0, 2)), "parsed": doc})
        out = tmp_path / os.path.dirname(path) / os.path.basename(path)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(doc))
        paths.append(str(out))
    want = _outcome(jquery.regress, paths)
    assert _outcome(query.regress, paths) == want
    failed = want[0] == "raised" or not want[1][0]
    for group in ("BENCH_", "MULTICHIP_", "artifacts"):
        subset = [p for p in paths if group in p]
        outcome = _outcome(jquery.regress, subset)
        assert _outcome(query.regress, subset) == outcome, group
        failed |= outcome[0] == "raised" or not outcome[1][0]
    assert failed
