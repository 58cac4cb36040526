"""The failure detector's health-scaled probe budgets.

Counterpart of ``effective_probe_budgets`` in
``scalecube_cluster_tpu/models/fd.py``, the one piece of that module the
Lifeguard plane (``models/lifeguard.py``) needs.
"""

from __future__ import annotations

import torch


def effective_probe_budgets(params, lhm: torch.Tensor,
                            ping_timeout_ms=None):
    """``(ping_budget_ms, ping_req_budget_ms)`` [N] float32: the direct
    ping's budget ``pt * m`` and the proxy chains' ``(interval - pt) *
    m`` for each member's multiplier ``m`` (LHA Probe's timeout
    scaling), in float32 as the reference computes them.  ``pt`` is
    ``ping_timeout_ms`` (the round's clipped knob), or
    ``params.ping_timeout_ms`` when None.  At m = 1 both are the base
    budgets."""
    m = lhm.to(torch.float32)
    pt = params.ping_timeout_ms if ping_timeout_ms is None \
        else ping_timeout_ms
    pt = torch.tensor(pt, dtype=torch.float32, device=lhm.device)
    interval = torch.tensor(params.ping_interval_ms, dtype=torch.float32,
                            device=lhm.device)
    return pt * m, (interval - pt) * m
