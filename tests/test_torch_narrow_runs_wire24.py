"""The port's narrow layouts against the JAX package, whole runs under
compact + ``wire24`` (focal 256 x 16 in four worlds, full view 48 in two).
The worlds and the reference's programs are
``tests/test_torch_narrow.py``'s.
"""

import pytest

torch = pytest.importorskip("torch")

from tests import test_torch_narrow as narrow  # noqa: E402
from tests.test_torch_narrow import quick_reference_compiles  # noqa: E402,F401
from tests.torch_port_helpers import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torchport


@pytest.mark.parametrize("shape,world", narrow.RUN_CASES)
def test_narrow_run_matches_reference(shape, world):
    narrow.check_run("compact_wire24", shape, world)
