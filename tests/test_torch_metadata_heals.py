"""The port's metadata KV plane against the JAX package, whole runs: the
quiesced heal converging only with the anti-entropy exchange (both
modes), suppression keeping words and versions across a resume, and a
join resetting its row and stamping the new epoch.  The runs and the
reference's programs are ``tests/test_torch_metadata.py``'s.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu_torch.models import metadata, swim  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402,F401
    assert_metrics_equal, assert_state_equal, jax_draws, one_torch_thread,
    port_params, port_world)
from tests.test_torch_metadata import (  # noqa: E402,F401
    HEAL_FILE, HEAL_N, JOIN_SLOT, _bound, _cells, _probes_match,
    _reference_programs, _run_both, _setup)

pytestmark = pytest.mark.torchport


@pytest.mark.parametrize("delivery", ["shift", "scatter"])
def test_quiesced_heal_converges_only_with_exchange(delivery):
    """A push inside the split, cold long before the heal: with the
    exchange every table holds it at the end; without it (the control,
    run in shift) the far half never does; each run exact against the
    reference."""
    on_ref, on_port, _, rounds = _run_both(f"heal:{delivery}-on")
    assert _probes_match(on_ref, on_port, rounds) == 0
    assert _cells(on_port[2], 0)[0] == [321] * HEAL_N
    if delivery == "shift":
        off_ref, off_port, _, _ = _run_both("heal:shift-control")
        assert _probes_match(off_ref, off_port, rounds) > 0


def test_suppression_keeps_words_and_versions_resume():
    """A dead owner's word stays with every observer through its
    suppression window (read mid-run, between the port's two segments),
    and its push after the revival lands at version 2 everywhere; the
    run exact against the reference's whole run."""
    jparams, jworld, rounds = _setup("suppress:")
    params, world = port_params(jparams), port_world(jworld)
    draws = jax_draws(jax.random.key(0), jparams, jworld)
    mid = 8 + _bound(jparams) + 12
    mid_state, m_a = swim.run(0, params, world, mid, draws=draws,
                              device="cpu")
    values, versions = _cells(mid_state, 2)
    assert all(v == 555 for i, v in enumerate(values) if i != 2)
    assert all(v == 1 for i, v in enumerate(versions) if i != 2)
    state, m_b = swim.run(0, params, world, rounds - mid, state=mid_state,
                          start_round=mid, draws=draws, device="cpu")
    jstate, jmetrics = _reference_programs(HEAL_FILE)["suppress:"](
        jax.random.key(0), jworld, state=jswim.initial_state(jparams, jworld),
        start_round=0)
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, {name: torch.cat([m_a[name], m_b[name]])
                                    for name in m_a})
    assert _cells(state, 2) == ([777] * 16, [2] * 16)
    assert _probes_match((jparams, jworld, jstate), (params, world, state),
                         rounds) == 0


def test_join_resets_the_row_and_stamps_the_new_epoch():
    """The compact open world: the joiner's row starts empty at its join
    (its other owners' words come back), the first identity's word is
    gone everywhere, and the new identity's push carries epoch 1 at
    version 1; exact against the reference."""
    ref, port, _, rounds = _run_both("join:")
    state = port[2]
    words = state.md[:, JOIN_SLOT, 0]
    assert metadata.word_value(words).tolist() == [6] * 16
    assert metadata.word_epoch(words).tolist() == [1] * 16
    assert metadata.word_version(words).tolist() == [1] * 16
    assert _cells(state, 7)[0] == [8] * 16
    assert _probes_match(ref, port, rounds) == 0
