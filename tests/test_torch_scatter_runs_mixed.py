"""The port's scatter delivery against the JAX package, whole runs: the
mixed probe cases (focal known-only, full view uniform), the network case
(wide and ``int16_wire`` on the fused wire, wide on the two-buffer wire)
and the seeded cold start.  The configurations, their checks and the
reference's programs are ``tests/test_torch_scatter.py``'s; this file
compiles only its own six programs.
"""

import pytest

torch = pytest.importorskip("torch")

from tests import test_torch_scatter as scatter  # noqa: E402
from tests.torch_port_helpers import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torchport

NAMES = scatter.RUN_FILES[1]


@pytest.mark.parametrize("name", NAMES)
def test_scatter_run_matches_reference(name):
    """Every state lane and stacked metric equal to JAX's ``run`` on the
    reference's draws, and the window holds what the configuration was
    built for."""
    scatter.check_run(name, NAMES)
