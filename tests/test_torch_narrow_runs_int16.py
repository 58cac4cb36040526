"""The port's narrow layouts against the JAX package, whole runs under
``int16_wire`` (focal 256 x 16 in four worlds, full view 48 in two), and
the refutation bump saturating at the wire's incarnation cap (int16 wire
and compact + ``wire24``).  The worlds and the reference's programs are
``tests/test_torch_narrow.py``'s.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu.utils import checkpoint  # noqa: E402
from scalecube_cluster_tpu_torch import interop  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402
    assert_metrics_equal, assert_state_equal, one_torch_thread, port_params)
from tests import test_torch_narrow as narrow  # noqa: E402
from tests.test_torch_narrow import (  # noqa: E402,F401
    _jax_run, _jparams, _jworld, _port_run, quick_reference_compiles)

pytestmark = pytest.mark.torchport


@pytest.mark.parametrize("shape,world", narrow.RUN_CASES)
def test_narrow_run_matches_reference(shape, world):
    narrow.check_run("int16_wire", shape, world)


@pytest.mark.parametrize("layout,cap", [("int16_wire", 8191),
                                        ("compact_wire24", 32767)])
def test_refutation_at_the_incarnation_cap(layout, cap):
    """Every incarnation seeded AT the layout's cap (8191 on the int16
    wire; 32767, the int16 carry's, under wire24): the revived node's
    refutation bump saturates there, exactly as in the reference."""
    shape = "full_view_48"
    jparams = _jparams(layout, shape)
    jworld = _jworld(jparams, "crash")
    init = jswim.initial_state(jparams, jworld)
    jinit = dataclasses.replace(
        init, inc=jnp.full_like(init.inc, cap),
        self_inc=jnp.full_like(init.self_inc, cap))
    pinit = interop.state_from_arrays(
        checkpoint.state_to_arrays(jinit), device="cpu",
        params=port_params(jparams))
    jstate, jmetrics = _jax_run(jparams, jworld, state=jinit)
    state, metrics = _port_run(jparams, jworld, shape, state=pinit)
    assert_state_equal(jstate, state)
    assert_metrics_equal(jmetrics, metrics)
    assert int(metrics["refutations"].sum()) > 0
    assert int(state.self_inc.max()) == cap
    assert int(state.inc.max()) == cap
