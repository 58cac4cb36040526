"""The port's host-side metadata table (``utils/metadata.py``) and run log
(``utils/runlog.py``) against the JAX package's: the scenarios of the
reference's ``tests/test_tick_metadata.py`` (an update spreading under
both deliveries, a refutation bump resolving to the prior content, the
untracked-subject refusal, the compact carry) run by both packages on the
reference's draws, every fetch and every UPDATED event equal; and
``log_metrics_summary``'s line, ``get_logger``'s levels and ``profiled``
as the reference's.  Exact, no tolerance.
"""

import dataclasses
import functools
import logging

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu.utils import metadata as jmd  # noqa: E402
from scalecube_cluster_tpu.utils import runlog as jrunlog  # noqa: E402
from scalecube_cluster_tpu_torch.models import swim  # noqa: E402
from scalecube_cluster_tpu_torch.utils import metadata as md  # noqa: E402
from scalecube_cluster_tpu_torch.utils import runlog  # noqa: E402
from tests.test_swim_model import fast_config  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    assert_state_equal, jax_draws, one_torch_thread, port_params,
    port_world)

pytestmark = pytest.mark.torchport


class Twin:
    """One scenario in both packages: the reference's params and world,
    the port's copies, one metadata table each, and runs of the port on
    the reference's draws under the same key."""

    def __init__(self, jparams, jworld, key=0, n_put=None):
        self.jparams, self.jworld = jparams, jworld
        self.params, self.world = port_params(jparams), port_world(jworld)
        self.key = jax.random.key(key)
        self.draws = jax_draws(self.key, jparams, jworld)
        self.jstore, self.store = jmd.TickMetadataStore(), \
            md.TickMetadataStore()
        for i in range(jparams.n_members if n_put is None else n_put):
            for st in (self.jstore, self.store):
                st.put(i, 0, {"name": f"m{i}", "version": 0})
        self.jstate = jswim.initial_state(jparams, jworld)
        self.state = swim.initial_state(self.params, self.world,
                                        device="cpu")

    def run(self, start, n, step=20):
        """``n`` rounds from ``start`` in both packages, in ``step``-round
        calls (one reference program a scenario), the states held equal
        after each; returns both runs' metrics."""
        jms, ms = [], []
        for r in range(start, start + n, step):
            self.jstate, jm = jswim.run(self.key, self.jparams, self.jworld,
                                        step, state=self.jstate,
                                        start_round=r)
            self.state, m = swim.run(0, self.params, self.world, step,
                                     state=self.state, start_round=r,
                                     draws=self.draws, device="cpu")
            assert_state_equal(self.jstate, self.state)
            jms.append(jm)
            ms.append(m)
        return ({k: np.concatenate([np.asarray(jm[k]) for jm in jms])
                 for k in jms[0]},
                {k: torch.cat([m[k] for m in ms]) for k in ms[0]})

    def update(self, node, metadata, at):
        self.jstate = self.jstore.update(self.jstate, self.jparams,
                                         self.jworld, node, metadata, at)
        self.state = self.store.update(self.state, self.params, self.world,
                                       node, metadata, at)
        assert_state_equal(self.jstate, self.state)

    def view(self, observer, subject, round_idx=None):
        want = self.jstore.view(self.jstate, self.jparams, self.jworld,
                                observer, subject, round_idx=round_idx)
        got = self.store.view(self.state, self.params, self.world, observer,
                              subject, round_idx=round_idx)
        assert got == want, (observer, subject)
        return want


def _params(n, **overrides):
    return jswim.SwimParams.from_config(fast_config(), n_members=n,
                                        **overrides)


@pytest.mark.parametrize("delivery", ["scatter", "shift"])
def test_update_spreads_and_is_queryable(delivery):
    """Owner 3 updates between runs: before the spread others fetch
    version 0 and the owner version 1; 40 rounds later every observer
    fetches version 1, and the UPDATED events (n - 1 of them for node 3,
    0 -> 1) equal the reference's."""
    n = 32
    jparams = _params(n, delivery=delivery)
    t = Twin(jparams, jswim.SwimWorld.healthy(jparams))
    t.run(0, 20)
    t.update(3, {"name": "m3", "version": 1}, 20)
    assert t.view(9, 3, round_idx=20) == {"name": "m3", "version": 0}
    assert t.view(3, 3, round_idx=20)["version"] == 1
    jprev, prev = jax.device_get(t.jstate), t.state
    t.run(20, 40)
    for obs in (0, 9, 17, 31):
        assert t.view(obs, 3, round_idx=60)["version"] == 1
    want = jmd.updated_events(jprev, t.jstate, t.jworld)
    assert md.updated_events(prev, t.state, t.world) == want
    bumps = [e for e in want if e[1] == 3]
    assert len(bumps) == n - 1 and all(e[2:] == (0, 1) for e in bumps)
    assert md.updated_events(prev, t.state, t.world, max_events=5) == \
        jmd.updated_events(jprev, t.jstate, t.jworld, max_events=5)


@functools.lru_cache(maxsize=None)
def _revival():
    """24 members, shift, node 5 crashed over rounds [4, 40) and back, 120
    rounds in both packages: the twin and both runs' metrics."""
    jparams = _params(24, delivery="shift")
    t = Twin(jparams, jswim.SwimWorld.healthy(jparams).with_crash(
        5, at_round=4, until_round=40), key=1)
    return (t, *t.run(0, 120))


def test_refutation_bump_resolves_to_prior_content():
    """Node 5 crashed over rounds [4, 40) and back: its refutation bump
    travels with no new content, and every fetch of it resolves to its
    version-0 metadata, as in the reference."""
    t = _revival()[0]
    snap = swim.node_snapshot(t.state, t.params, t.world, 0)
    assert snap == jswim.node_snapshot(t.jstate, t.jparams, t.jworld, 0)
    assert 5 in snap["alive_members"] and snap["record_incarnations"][5] >= 1
    for obs in (0, 5, 11, 23):
        assert t.view(obs, 5)["name"] == "m5"


def test_update_requires_tracked_subject():
    """An update or a fetch of an untracked node (64 members, 8 tracked)
    raises the reference's ``ValueError``."""
    jparams = _params(64, n_subjects=8)
    t = Twin(jparams, jswim.SwimWorld.healthy(jparams), n_put=0)
    for call in (lambda st, *a: st.update(*a, 40, {"x": "y"}, 0),
                 lambda st, *a: st.view(*a, 0, 40)):
        with pytest.raises(ValueError) as want:
            call(t.jstore, t.jstate, t.jparams, t.jworld)
        with pytest.raises(ValueError) as got:
            call(t.store, t.state, t.params, t.world)
        assert str(got.value) == str(want.value)


def test_update_under_the_compact_carry():
    """The bump and the reopened window in the compact encodings: the
    carries equal the reference's after the update and 40 rounds on, and
    observer 11 fetches the new version."""
    jparams = dataclasses.replace(_params(24, delivery="shift"),
                                  compact_carry=True)
    t = Twin(jparams, jswim.SwimWorld.healthy(jparams), n_put=0)
    for st in (t.jstore, t.store):
        st.put(3, 0, {"v": 0})
    t.run(0, 20)
    t.update(3, {"v": 1}, 20)
    t.run(20, 40)
    assert t.view(11, 3, round_idx=60) == {"v": 1}


def _summary_lines(pkg, metrics, offset, caplog, name):
    logger = pkg.get_logger(name)
    logger.propagate = True
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=name):
        assert pkg.log_metrics_summary(logger, metrics,
                                       round_offset=offset) is None
    return [r.getMessage() for r in caplog.records]


def test_log_metrics_summary_matches_reference(caplog):
    """The summary of the same 120-round run (the revival's: the port's
    metrics on the reference's draws, as tensors) logs the reference's
    line, at two offsets; an empty dict logs its "no metrics" line."""
    _, jm, m = _revival()
    for offset in (0, 500):
        want = _summary_lines(jrunlog, jm, offset, caplog, "t_ref_summary")
        got = _summary_lines(runlog, m, offset, caplog, "t_port_summary")
        assert got == want and len(want) == 1
        assert f"rounds [{offset}, {offset + 119}]" in want[0]
        assert "refutations 0," not in want[0]
    want = _summary_lines(jrunlog, {}, 500, caplog, "t_ref_summary")
    assert _summary_lines(runlog, {}, 500, caplog, "t_port_summary") == want
    assert "no metrics" in want[0]


def test_logger_levels_and_profiled(monkeypatch, tmp_path):
    """``get_logger`` applies its level on every call (argument over the
    variable, names and constants) with one handler, as the reference
    does; ``profiled`` is a no-op without ``SCALECUBE_TPU_PROFILE_DIR``
    and writes a ``torch.profiler`` trace into it when set."""
    for pkg, name in ((jrunlog, "t_ref_levels"), (runlog, "t_port_levels")):
        monkeypatch.delenv("SCALECUBE_TPU_LOGLEVEL", raising=False)
        levels = [pkg.get_logger(name, level=lv).level
                  for lv in (logging.WARNING, logging.DEBUG, "ERROR", 0)]
        monkeypatch.setenv("SCALECUBE_TPU_LOGLEVEL", "WARNING")
        levels.append(pkg.get_logger(name).level)
        levels.append(pkg.get_logger(name, level="DEBUG").level)
        assert levels == [logging.WARNING, logging.DEBUG, logging.ERROR,
                          logging.NOTSET, logging.WARNING, logging.DEBUG]
        assert len(pkg.get_logger(name).handlers) == 1
    monkeypatch.delenv("SCALECUBE_TPU_PROFILE_DIR", raising=False)
    with runlog.profiled():
        torch.arange(8).sum()
    trace_dir = tmp_path / "prof"
    monkeypatch.setenv("SCALECUBE_TPU_PROFILE_DIR", str(trace_dir))
    with runlog.profiled(runlog.get_logger("t_port_profiled")):
        assert int(torch.arange(8).sum()) == 28
    assert any(p.suffix == ".json" for p in trace_dir.rglob("*"))
