"""The port's narrow layouts against the JAX package, whole runs under
``compact_carry`` (focal 256 x 16 in four worlds, full view 48 in two),
and a JAX compact-carry checkpoint resumed by the port.  The worlds and
the reference's programs are ``tests/test_torch_narrow.py``'s.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from scalecube_cluster_tpu.utils import checkpoint  # noqa: E402
from scalecube_cluster_tpu_torch import interop  # noqa: E402
from tests.torch_port_helpers import (  # noqa: E402
    assert_metrics_equal, assert_state_equal, one_torch_thread, port_params)
from tests import test_torch_narrow as narrow  # noqa: E402
from tests.test_torch_narrow import (  # noqa: E402,F401
    CARRY, ROUNDS, _carry_dtypes, _jax_run, _jparams, _jworld, _port_run,
    quick_reference_compiles)

pytestmark = pytest.mark.torchport


@pytest.mark.parametrize("shape,world", narrow.RUN_CASES)
def test_narrow_run_matches_reference(shape, world):
    narrow.check_run("compact", shape, world)


def test_port_resumes_a_jax_compact_checkpoint(tmp_path):
    """A JAX compact-carry run checkpointed at round 24 (int16/int8
    lanes) resumes in the port and matches JAX's own continuation."""
    shape = "focal_256x16"
    jparams = _jparams("compact", shape)
    jworld = _jworld(jparams, "crash")
    half, _ = _jax_run(jparams, jworld)
    path = str(tmp_path / "compact.npz")
    checkpoint.save(path, half, ROUNDS, key=jax.random.key(0),
                    meta={"run": "compact"})
    want, want_metrics = _jax_run(jparams, jworld, state=half,
                                  start_round=ROUNDS)

    state, next_round, _, meta = interop.load_jax_checkpoint(
        path, device="cpu", params=port_params(jparams))
    assert (next_round, meta) == (ROUNDS, {"run": "compact"})
    assert _carry_dtypes(state) == CARRY["compact"]
    final, metrics = _port_run(jparams, jworld, shape, state=state,
                               start_round=next_round)
    assert_state_equal(want, final)
    assert_metrics_equal(want_metrics, metrics)
    with pytest.raises(ValueError, match="compact_carry"):
        interop.load_jax_checkpoint(path, device="cpu")
