"""The port's parameter sweep (``scalecube_cluster_tpu_torch/sweep.py``)
against the JAX package's ``sweep.py`` on a 2 x 2 grid (fanout x loss)
at N = 16.

- ``knob_grid``: the reference's points in its order, its ceiling error;
- ``sweep_run`` on the reference's draws (point i's key folded from the
  base key, every point's shifts from the base key): every metric equal,
  and so ``crash_curves``;
- ``run_crash_sweep``'s artifact equal to the reference's on the
  reference's draws, and the CLI's artifact (the port's own draws) equal
  to ``run_crash_sweep``'s with the reference's keys, grid and anchors.

Cost: two reference programs (the vmapped sweep at two grid shapes).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from scalecube_cluster_tpu import sweep as jsweep  # noqa: E402
from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu_torch import sweep  # noqa: E402
from tests.test_swim_model import fast_config  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    assert_metrics_equal, jax_draws, one_torch_thread, port_params,
    port_world)

pytestmark = pytest.mark.torchport

N, ROUNDS = 16, 60
GRID = dict(fanout=[2, 3], loss_probability=[0.0, 0.1])


def _point_draws(key, params, world, n_points):
    """The reference sweep's draws: point i under ``fold_in(key, i)``,
    its shifts under ``key``."""
    return [jax_draws(jax.random.fold_in(key, i), params, world,
                      shift_key=key) for i in range(n_points)]


def test_knob_grid_matches_reference():
    """The grid's points, in the reference's order and dtypes' values;
    a fanout above the params' channel count raises its error."""
    jparams = jswim.SwimParams.from_config(fast_config(), n_members=N)
    params = port_params(jparams)
    axes = dict(fanout=[2, 3], ping_every=[1, 2], loss_probability=[0.05])
    want = jsweep.knob_grid(jparams, **axes)
    got = sweep.knob_grid(params, **axes)
    assert len(got) == 4
    for name in sweep.GRID_AXES:
        assert [getattr(k, name) for k in got] == \
            np.asarray(getattr(want, name)).tolist(), name
    with pytest.raises(ValueError, match="exceeds the static channel"):
        sweep.knob_grid(params, fanout=[params.fanout + 1])


def test_sweep_run_and_curves_match_reference():
    """``sweep_run`` on the reference's draws equals the reference's
    vmapped sweep, metric for metric, and so do the curves."""
    jparams = jswim.SwimParams.from_config(fast_config(), n_members=N,
                                           fanout=3, delivery="shift")
    jworld = jswim.SwimWorld.healthy(jparams).with_crash(0, at_round=0)
    key = jax.random.key(7)
    jknobs = jsweep.knob_grid(jparams, **GRID)
    jm = jsweep.sweep_run(key, jparams, jworld, ROUNDS, jknobs)
    params = port_params(jparams)
    m = sweep.sweep_run(7, params, port_world(jworld), ROUNDS,
                        sweep.knob_grid(params, **GRID),
                        draws=_point_draws(key, jparams, jworld, 4),
                        device="cpu")
    assert_metrics_equal(jm, m)
    want = jsweep.crash_curves(jm, 0, ROUNDS, N)
    got = sweep.crash_curves(m, 0, ROUNDS, N)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)
    assert got["detection_rounds"].max() < ROUNDS


def test_crash_sweep_artifact_matches_reference_and_cli(tmp_path):
    """``run_crash_sweep`` on the reference's draws is the reference's
    artifact; the CLI writes ``run_crash_sweep``'s artifact on the port's
    own draws, with the reference's keys, grid and anchors."""
    cfg = fast_config()
    want = jsweep.run_crash_sweep(N, ROUNDS, config=cfg, seed=3, **GRID)
    jparams = jswim.SwimParams.from_config(cfg, n_members=N, fanout=3,
                                           delivery="shift")
    jworld = jswim.SwimWorld.healthy(jparams).with_crash(0, at_round=0)
    got = sweep.run_crash_sweep(
        N, ROUNDS, config=cfg, seed=3,
        draws=_point_draws(jax.random.key(3), jparams, jworld, 4),
        device="cpu", **GRID)
    assert got == json.loads(json.dumps(want))

    out = tmp_path / "curves.json"
    args = ["--n-members", str(N), "--n-rounds", "40", "--fanout", "2", "3",
            "--ping-every", "2", "--loss", "0.0", "0.1", "--device", "cpu",
            "--out", str(out)]
    sweep.main(args)
    artifact = json.loads(out.read_text())
    axes = dict(fanout=[2, 3], ping_every=[2], loss_probability=[0.0, 0.1],
                suspicion_rounds=[])
    assert artifact == json.loads(json.dumps(sweep.run_crash_sweep(
        N, 40, device="cpu", **axes)))
    ref = jsweep.run_crash_sweep(N, 40, **axes)
    assert set(artifact) == set(ref)
    assert {k: artifact[k] for k in ("n_members", "n_rounds", "delivery",
                                     "grid", "analytic")} == \
        json.loads(json.dumps({k: ref[k] for k in (
            "n_members", "n_rounds", "delivery", "grid", "analytic")}))
    assert set(artifact["curves"]) == set(ref["curves"])
