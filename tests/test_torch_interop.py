"""Crossing from the JAX package to the port, and the port's boundaries.

A JAX run checkpointed at round 40 with ``utils.checkpoint.save`` and
continued by the port for 40 rounds (``interop.load_jax_checkpoint``,
draws rebuilt from the stored key) must equal JAX's unbroken 80-round
run, state and metrics, exactly — both are integer traces driven by the
same float32 draws.  The port must import neither ``jax`` nor the JAX
package, and its entry points must default to CUDA.
"""

import ast
import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu.utils import checkpoint  # noqa: E402
from scalecube_cluster_tpu_torch import interop  # noqa: E402
from scalecube_cluster_tpu_torch.models import swim  # noqa: E402
from tests.test_swim_model import fast_config  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402
    assert_metrics_equal, assert_state_equal, jax_draws, one_torch_thread,
    port_params, port_world)

pytestmark = pytest.mark.torchport

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "scalecube_cluster_tpu_torch"


def test_port_resumes_a_jax_checkpoint(tmp_path):
    jparams = jswim.SwimParams.from_config(
        fast_config(), n_members=256, n_subjects=16, loss_probability=0.05,
        delivery="shift")
    jworld = jswim.SwimWorld.healthy(jparams).with_crash(
        3, at_round=5, until_round=60)
    key = jax.random.key(11)
    whole, m_whole = jswim.run(key, jparams, jworld, 80)
    half, _ = jswim.run(key, jparams, jworld, 40)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, half, 40, key=key, meta={"run": "interop"})

    state, next_round, key_data, meta = interop.load_jax_checkpoint(
        path, device="cpu")
    assert (next_round, meta) == (40, {"run": "interop"})
    resumed_key = jax.random.wrap_key_data(jax.numpy.asarray(key_data))
    final, metrics = swim.run(
        0, port_params(jparams), port_world(jworld), 40, state=state,
        start_round=next_round, draws=jax_draws(resumed_key, jparams),
        device="cpu")
    assert_state_equal(whole, final)
    assert_metrics_equal(m_whole, metrics, rounds=slice(40, 80))


def _imports(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_port_sources_import_neither_jax_nor_the_jax_package():
    sources = sorted(PACKAGE.rglob("*.py"))
    assert len(sources) >= 10
    for path in sources:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "scalecube_cluster_tpu"), \
                f"{path.relative_to(REPO)} imports {name}"


def test_port_runs_with_jax_blocked():
    """Every module imports, and a short CPU run completes, in a process
    where importing jax or the JAX package fails."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).replace(
            ".__init__", "")
        for p in PACKAGE.rglob("*.py"))
    code = "\n".join([
        "import importlib, sys",
        "for blocked in ('jax', 'jaxlib', 'scalecube_cluster_tpu'):",
        "    sys.modules[blocked] = None",
        f"for m in {modules!r}:",
        "    importlib.import_module(m)",
        "from scalecube_cluster_tpu_torch.config import ClusterConfig",
        "from scalecube_cluster_tpu_torch.models import swim",
        "p = swim.SwimParams.from_config(ClusterConfig.default(), 64, 8,"
        " delivery='shift', loss_probability=0.1)",
        "w = swim.SwimWorld.healthy(p, device='cpu').with_crash(1, 2)",
        "s, m = swim.run(0, p, w, 12, device='cpu')",
        "assert m['suspect'].shape == (12, 8)",
        "assert not any(k.startswith(('jax', 'scalecube_cluster_tpu.'))"
        " for k in sys.modules if sys.modules[k] is not None)",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_entry_points_default_to_cuda():
    for fn in (swim.initial_state, swim.run, swim.SwimWorld.healthy,
               interop.world_from_arrays, interop.state_from_arrays,
               interop.load_jax_checkpoint):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    params = swim.SwimParams.from_config(fast_config(), n_members=32,
                                         n_subjects=4, delivery="shift")
    if torch.cuda.is_available():
        assert swim.SwimWorld.healthy(params).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        swim.SwimWorld.healthy(params)
    world = swim.SwimWorld.healthy(params, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        swim.run(0, params, world, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        swim.initial_state(params, world)


def test_state_and_world_import_reject_unported_lanes():
    jparams = jswim.SwimParams.from_config(
        fast_config(), n_members=32, n_subjects=4, delivery="shift")
    jworld = jswim.SwimWorld.healthy(jparams)
    arrays = checkpoint.state_to_arrays(jswim.initial_state(jparams, jworld))
    state = interop.state_from_arrays(arrays, device="cpu")
    assert state.status.shape == (32, 4) and state.status.dtype == torch.int8
    lhm = dict(arrays, **{"state/lhm": np.ones(32, np.int32)})
    with pytest.raises(NotImplementedError, match="lhm"):
        interop.state_from_arrays(lhm, device="cpu")
    compact = dict(arrays, **{"state/inc": np.zeros((32, 4), np.int16)})
    with pytest.raises(NotImplementedError, match="compact_carry"):
        interop.state_from_arrays(compact, device="cpu")
    with pytest.raises(NotImplementedError, match="LinkFaults"):
        port_world(jworld.with_link_fault(0, 1, loss=0.5))
    with pytest.raises(NotImplementedError, match="seed_ids"):
        port_world(jworld.with_seeds([0]))
    with pytest.raises(NotImplementedError, match="delivery='scatter'"):
        port_params(jswim.SwimParams.from_config(fast_config(),
                                                 n_members=32))
