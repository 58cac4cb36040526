"""Crossing from the JAX package to the port, and the port's boundaries.

A JAX run checkpointed at round 40 with ``utils.checkpoint.save`` and
continued by the port for 40 rounds (``interop.load_jax_checkpoint``,
draws rebuilt from the stored key) must equal JAX's unbroken 80-round
run, state and metrics, exactly — both are integer traces driven by the
same float32 draws.  The port must import neither ``jax`` nor the JAX
package, and its entry points must default to CUDA.
"""

import ast
import dataclasses
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
    """Every module and ``chip_smoke.py`` import, and short CPU runs (the
    plain round, one with a block, delays and a user gossip, and one
    with a config push) complete, in a process where importing jax or
    the JAX package fails."""
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
        "import dataclasses",
        "q = dataclasses.replace(p, mean_delay_ms=50.0, max_delay_rounds=2,"
        " n_user_gossips=1)",
        "v = (swim.SwimWorld.healthy(q, device='cpu').with_block(3, (0, 64))"
        ".with_spread(0, 9, 1))",
        "s, m = swim.run(0, q, v, 12, device='cpu')",
        "assert s.inbox_ring.shape == (3, 64, 8)",
        "assert m['user_gossip_infected'].shape == (12, 1)",
        "r = swim.SwimParams.from_config(ClusterConfig.default(), 16,"
        " delivery='shift', metadata_keys=1, sync_interval=4)",
        "u = swim.SwimWorld.healthy(r, device='cpu')"
        ".with_metadata_push(3, 0, 641, 1)",
        "s, m = swim.run(0, r, u, 12, device='cpu')",
        "assert s.md.shape == (16, 16, 1) and m['metadata_divergent'].shape"
        " == (12,)",
        "from scalecube_cluster_tpu_torch.models import gossip",
        "g = gossip.GossipSimParams.from_config(ClusterConfig.default(), 64,"
        " 2, loss_probability=0.1, mean_delay_ms=200.0, max_delay_rounds=2)",
        "gs, gm = gossip.run(0, g, 12, device='cpu')",
        "assert gs.ring.shape == (3, 64, 2) and gm['infected_count'].shape"
        " == (12, 2)",
        "from scalecube_cluster_tpu_torch import chaos",
        "sc = chaos.Scenario('t', 16, 12, (chaos.Crash(3, 2),"
        " chaos.ConfigPush(5, 0, 9, 1)))",
        "v = chaos.run_scenario(sc, seed=1, device='cpu')",
        "assert v.verdict['codes']['COMPLETENESS']['violations'] == 0",
        "importlib.import_module('chip_smoke')",
        "assert not any(k.startswith(('jax', 'scalecube_cluster_tpu.'))"
        " for k in sys.modules if sys.modules[k] is not None)",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_entry_points_default_to_cuda():
    from scalecube_cluster_tpu_torch.chaos import campaign, scenarios
    from scalecube_cluster_tpu_torch.models import gossip

    for fn in (swim.initial_state, swim.run, swim.SwimWorld.healthy,
               interop.world_from_arrays, interop.state_from_arrays,
               interop.load_jax_checkpoint, gossip.initial_state, gossip.run,
               interop.gossip_state_from_arrays, scenarios.Scenario.build,
               campaign.run_scenario, campaign.run_campaign):
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
    # md lanes come across as given; a lane the params do not size (the
    # metadata plane needs full view) is refused when the run checks it.
    md = dict(arrays, **{"state/md": np.zeros((32, 4, 2), np.int32)})
    with pytest.raises(ValueError, match="metadata_keys"):
        swim.check_lanes(interop.state_from_arrays(md, device="cpu"),
                         port_params(jparams))
    # A compact lane in a state whose params name the wide carry.
    compact = dict(arrays, **{"state/inc": np.zeros((32, 4), np.int16)})
    with pytest.raises(ValueError, match="compact_carry"):
        interop.state_from_arrays(compact, device="cpu")
    # Link-fault rules and seeds carry over as the reference holds them.
    world = port_world(jworld.with_link_fault(0, (1, 9), loss=0.5,
                                              delay_ms=30.0, from_round=2)
                       .with_seeds([0, 3]))
    assert world.faults.n_rules == 1 and world.seed_ids.tolist() == [0, 3]
    assert world.faults.dst_hi.tolist() == [9]
    assert world.faults.delay_ms.dtype == torch.float32
    # A world with an inconsistent slot map is refused.
    arrays_w = {f.name: np.asarray(getattr(jworld, f.name))
                for f in dataclasses.fields(jworld)
                if f.name != "faults" and getattr(jworld, f.name) is not None}
    arrays_w["slot_of_node"] = np.roll(arrays_w["slot_of_node"], 1)
    with pytest.raises(ValueError, match="slot_of_node"):
        interop.world_from_arrays(arrays_w, device="cpu")
    # A scatter params (the reference's default) carries over field for
    # field.
    jscatter = jswim.SwimParams.from_config(fast_config(), n_members=32,
                                            n_subjects=4,
                                            ping_known_only=True,
                                            fused_wire=False)
    scatter = port_params(jscatter)
    assert scatter.delivery == "scatter" and not scatter.fused_wire
    assert dataclasses.asdict(scatter) == dataclasses.asdict(jscatter)


@pytest.mark.parametrize("compact", [False, True])
def test_lhm_lane_converts_both_ways(compact):
    """A reference state with the Lifeguard lane (multipliers set) comes
    across with its ``lhm``, and the port's state goes back through
    ``interop.state_to_arrays`` to the reference's
    ``checkpoint.state_from_arrays`` field for field."""
    jparams = jswim.SwimParams.from_config(
        fast_config(), n_members=32, n_subjects=4, delivery="shift",
        lhm_max=8, compact_carry=compact)
    jworld = jswim.SwimWorld.healthy(jparams)
    lhm = np.random.default_rng(0).integers(1, 9, 32).astype(np.int32)
    jstate = dataclasses.replace(jswim.initial_state(jparams, jworld),
                                 lhm=jax.numpy.asarray(lhm))
    state = interop.state_from_arrays(checkpoint.state_to_arrays(jstate),
                                      device="cpu",
                                      params=port_params(jparams))
    assert state.lhm.dtype == torch.int32 and state.lhm.tolist() == \
        lhm.tolist()
    swim.check_lanes(state, port_params(jparams))
    arrays = interop.state_to_arrays(state)
    back = checkpoint.state_from_arrays(
        {name[len("state/"):]: value for name, value in arrays.items()})
    for field in dataclasses.fields(jstate):
        want = np.asarray(getattr(jstate, field.name))
        got = np.asarray(getattr(back, field.name))
        assert got.dtype == want.dtype and got.shape == want.shape, field.name
        np.testing.assert_array_equal(got, want, err_msg=field.name)


@pytest.mark.parametrize("compact", [False, True])
def test_metadata_lanes_and_pushes_convert_both_ways(compact):
    """A reference world's config-push schedule and a reference state's
    ``md`` / ``md_spread`` lanes (set) come across, and the port's state
    goes back through ``interop.state_to_arrays`` to the reference's
    ``checkpoint.state_from_arrays`` field for field; a JAX checkpoint
    with the lanes loads and resumes in the port as the reference's
    unbroken run continues."""
    jparams = jswim.SwimParams.from_config(
        fast_config(), n_members=16, delivery="shift", sync_every=0,
        sync_interval=4, metadata_keys=2, compact_carry=compact)
    jworld = (jswim.SwimWorld.healthy(jparams)
              .with_metadata_push(3, 0, 641, 2).with_metadata_push(5, 1, 9, 2)
              .with_metadata_push(3, 0, 7, 12))
    world = port_world(jworld)
    for name in swim.SwimWorld.PUSH_FIELDS:
        np.testing.assert_array_equal(getattr(world, name).numpy(),
                                      np.asarray(getattr(jworld, name)))
    params = port_params(jparams)
    key = jax.random.key(3)
    jmid, _ = jswim.run(key, jparams, jworld, 10)
    assert np.asarray(jmid.md).any() and np.asarray(jmid.md_spread).any()
    state = interop.state_from_arrays(checkpoint.state_to_arrays(jmid),
                                      device="cpu", params=params)
    swim.check_lanes(state, params)
    assert_state_equal(jmid, state)
    back = checkpoint.state_from_arrays(
        {name[len("state/"):]: value
         for name, value in interop.state_to_arrays(state).items()},
        params=jparams)
    for field in dataclasses.fields(jmid):
        want = np.asarray(getattr(jmid, field.name))
        got = np.asarray(getattr(back, field.name))
        assert got.dtype == want.dtype and got.shape == want.shape, field.name
        np.testing.assert_array_equal(got, want, err_msg=field.name)
    jend, jmetrics = jswim.run(key, jparams, jworld, 10, state=jmid,
                               start_round=10)
    end, metrics = swim.run(0, params, world, 10, state=state,
                            start_round=10,
                            draws=jax_draws(key, jparams, jworld),
                            device="cpu")
    assert_state_equal(jend, end)
    assert_metrics_equal(jmetrics, metrics)
