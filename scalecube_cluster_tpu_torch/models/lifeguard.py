"""The Lifeguard health plane: health-aware probing and suspicion.

Counterpart of ``scalecube_cluster_tpu/models/lifeguard.py`` (Dadgar,
Hashemi & Currie, arXiv:1707.00788).  One integer a member, the Local
Health Multiplier (``SwimState.lhm`` [N] int32 in [1, lhm_max], 1 =
healthy), drives three mechanisms:

- LHA Probe: a member at multiplier ``m`` probes with probability
  ``1/m`` an fd round (:func:`probe_gate`) and its probe budgets scale
  by ``m`` (``models/fd.effective_probe_budgets``);
- LHA Suspicion: the deadline it arms for a new SUSPECT entry scales
  with ``m`` and the live count (:func:`suspicion_deadline_rounds`),
  handed to the merge kernel as one armed-rounds value a row;
- the buddy system: the refute push rides the probe's ack path, with or
  without the SYNC channel (``models/swim``).

A round's transition (:func:`update`): +1 for a probe whose direct ping
failed (timed out or proxy-rescued), +1 for refuting its own suspicion,
-1 for a clean direct ack, clamped; frozen members keep their value.
``SwimParams.lhm_max = 0`` (the default) leaves the plane out: the lane
is zero-size and no gate draw is taken.  With every member at 1 the
gate always passes and the budgets and deadlines are the base values.

The gate's uniforms come from the round's draws (``ops/prng``:
``lhm_gate_u``), not from a key.
"""

from __future__ import annotations

import torch

from scalecube_cluster_tpu_torch import swim_math
from scalecube_cluster_tpu_torch.models import fd

# This plane's row of models/compose.plane_registry.
PLANE = dict(
    name="lifeguard", kind="in-tick",
    knobs=("lhm_max", "dead_suppress_rounds"), lanes=("lhm",),
    doc="Local Health Multiplier lane driving LHA Probe/Suspicion and "
        "the buddy refute path (+ the dead-member suppression window)",
)


def initial_lhm(params, device) -> torch.Tensor:
    """The lane of a fresh state: [N] ones when the plane is on, a
    zero-size int32 tensor when ``lhm_max == 0``."""
    n = params.n_members if params.lhm_max > 0 else 0
    return torch.ones((n,), dtype=torch.int32, device=device)


def probe_gate(u: torch.Tensor, lhm: torch.Tensor) -> torch.Tensor:
    """[N] bool: does each member probe this fd round?  ``u`` [N]
    float32 uniforms in [0, 1): ``u * m < 1``, always true at m = 1."""
    return u * lhm.to(torch.float32) < 1.0


def lha_probe_setup(params, lhm: torch.Tensor, gate_u, ping_timeout_ms,
                    ping_req_ms=None):
    """``(ping_budget_ms, ping_req_budget_ms, gate)`` of one round's FD
    phase, the [N] health-scaled chain budgets and the probe gate, or
    ``(None, None, None)`` when the plane is off.  ``ping_timeout_ms``
    and ``ping_req_ms`` are the round's base budgets
    (``swim.knob_probe_budgets``)."""
    if params.lhm_max == 0:
        return None, None, None
    ping_budget, ping_req_budget = fd.effective_probe_budgets(
        params, lhm, ping_timeout_ms=ping_timeout_ms, ping_req_ms=ping_req_ms)
    return ping_budget, ping_req_budget, probe_gate(gate_u, lhm)


def suspicion_deadline_rounds(base: int, lhm: torch.Tensor,
                              n_live: torch.Tensor,
                              n_members: int) -> torch.Tensor:
    """LHA Suspicion: the rounds to DEAD each member arms for a new
    SUSPECT entry, ``base + (base * (lhm - 1) * ceil_log2(n_live)) //
    max(ceil_log2(N), 1)`` in int32 (the reference's integer schedule).
    ``n_live`` is the ground-truth live count as an int32 device scalar,
    so nothing syncs with the host.  At lhm = 1 it is ``base``; it never
    exceeds ``base * lhm_max``."""
    log_live = swim_math.ceil_log2_tensor(n_live)
    log_n = max(swim_math.ceil_log2(n_members), 1)
    base_t = torch.tensor(base, dtype=torch.int32, device=lhm.device)
    extra = torch.div(base_t * (lhm.to(torch.int32) - 1) * log_live, log_n,
                      rounding_mode="floor")
    return (base_t + extra).to(torch.int32)


def update(lhm: torch.Tensor, probe_fail: torch.Tensor,
           probe_clean: torch.Tensor, refuted: torch.Tensor,
           alive_here: torch.Tensor, lhm_max: int) -> torch.Tensor:
    """One round's transition: ``+probe_fail - probe_clean + refuted``,
    clamped to [1, lhm_max]; rows of frozen members keep their value."""
    delta = (probe_fail.to(torch.int32) - probe_clean.to(torch.int32)
             + refuted.to(torch.int32))
    bumped = torch.clamp(lhm + delta, 1, lhm_max)
    return torch.where(alive_here, bumped, lhm)
