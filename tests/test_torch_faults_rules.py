"""The port's link-fault rules: ``LinkFaults.add``'s validation against the
JAX package's messages (ids and half-open ranges, loss, rounds).  The
rest of the network model is ``tests/test_torch_faults.py``'s.
"""

import pytest

torch = pytest.importorskip("torch")

from scalecube_cluster_tpu.models import swim as jswim  # noqa: E402
from scalecube_cluster_tpu_torch.models import swim  # noqa: E402
from tests.torch_port_helpers import one_torch_thread  # noqa: E402

pytestmark = pytest.mark.torchport


@pytest.mark.parametrize("args,match", [
    (((0, 4), 5, 1.5), "loss must be a probability"),
    (((0, 4), 5, -0.1), "loss must be a probability"),
    (((0, 4), 5, 0.5, -1.0), "delay_ms must be non-negative"),
    (((4, 4), 5, 0.5), "empty id range"),
    ((0, (9, 3), 0.5), "empty id range"),
    ((0, 5, 0.5, 0.0, 10, 10), "inverted round window"),
])
def test_link_faults_add_validation(args, match):
    """The reference's errors, message for message; a valid rule
    appends."""
    with pytest.raises(ValueError, match=match) as got:
        swim.LinkFaults.none().add(*args)
    with pytest.raises(ValueError) as want:
        jswim.LinkFaults.none().add(*args)
    assert str(got.value) == str(want.value)
    faults = swim.LinkFaults.none().add((0, 4), 5, 0.5, 20.0, 3, 9)
    assert faults.n_rules == 1 and faults.loss.dtype == torch.float32
    assert [int(faults.dst_lo[0]), int(faults.dst_hi[0])] == [5, 6]
