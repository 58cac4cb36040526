"""Failure-detector-only model: the SWIM probe in isolation.

Counterpart of ``scalecube_cluster_tpu/models/fd.py``.  The full round
(``models/swim.py``) runs with the gossip channels masked off
(``Knobs.fanout = 0``) and SYNC never due (``sync_every = 0``), so what
remains each round is the probe phase (a direct ping within
``ping_timeout``, ping-req through the proxies within the rest of the
interval) and each observer's local SUSPECT/ALIVE verdicts, with no
dissemination between observers; suspicion timeouts still fire
locally.  :func:`run` is that configuration as one call, with the same
delivery modes, link faults and world schedules as the full model.

:func:`effective_probe_budgets` is the Lifeguard plane's health-scaled
probe budgets (``models/lifeguard.py``); :func:`probe_outcome_updates`
names the probe counters the metrics plane reads.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from scalecube_cluster_tpu_torch.models import swim


def fd_only_knobs(params: "swim.SwimParams") -> "swim.Knobs":
    """Knobs that silence gossip and SYNC, leaving only the probe phase.

    ``sync_every=0`` is the never-sync sentinel (the round gates the
    SYNC round on ``sync_every > 0``); it also turns off the FD's
    alive-on-suspected refute push, a SYNC issued by membership, so
    verdicts stay observer-local.  With the Lifeguard plane on
    (``lhm_max > 0``) the buddy refute push rides the FD ack path and is
    not silenced: an isolation that must stay verdict-local keeps
    ``lhm_max = 0``."""
    return dataclasses.replace(swim.Knobs.from_params(params),
                               sync_every=0, fanout=0)


def run(seed: int, params: "swim.SwimParams", world: "swim.SwimWorld",
        n_rounds: int, state: Optional["swim.SwimState"] = None,
        start_round: int = 0,
        draws: Optional[Callable[[int], object]] = None, device="cuda"):
    """``swim.run`` with gossip and SYNC silenced (module docstring).

    Returns ``(final_state, metrics)``; the ``suspect``/``alive`` traces
    are the per-period verdict stream summed over observers."""
    return swim.run(seed, params, world, n_rounds, state=state,
                    start_round=start_round, draws=draws,
                    knobs=fd_only_knobs(params), device=device)


def effective_probe_budgets(params, lhm: torch.Tensor,
                            ping_timeout_ms=None, ping_req_ms=None):
    """``(ping_budget_ms, ping_req_budget_ms)`` [N] float32: the direct
    ping's budget ``pt * m`` and the proxy chains' ``(interval - pt) *
    m`` for each member's multiplier ``m`` (LHA Probe's timeout
    scaling), in float32 as the reference computes them.  ``pt`` is
    ``ping_timeout_ms`` (the round's clipped knob, a float32 value whose
    complement is taken in float32 unless ``ping_req_ms`` gives it), or
    ``params.ping_timeout_ms`` when None (the complement then in
    float64, rounded once, as the reference's Python scalars).  At
    m = 1 both are the base budgets."""
    m = lhm.to(torch.float32)
    if ping_timeout_ms is None:
        pt = params.ping_timeout_ms
        rest = params.ping_interval_ms - pt
    else:
        pt = ping_timeout_ms
        rest = (ping_req_ms if ping_req_ms is not None else
                np.float32(params.ping_interval_ms) - np.float32(pt))
    return (torch.tensor(pt, dtype=torch.float32, device=lhm.device) * m,
            torch.tensor(float(rest), dtype=torch.float32,
                         device=lhm.device) * m)


def probe_outcome_updates(tick_metrics: dict) -> dict:
    """The FD's probe-outcome counters of the health registry
    (``telemetry/metrics.py``) from one round's metrics: probe volume
    (``fd_probes_sent``, the PINGs issued), indirect-probe escalation
    (``fd_ping_req_sent``, the proxy fan-out that fires when a direct
    ping failed) and tracked-subject verdicts (``fd_tracked_verdicts``),
    each an int32 device total.  A renaming of counters the round
    already computes."""
    out = {}
    for reg_name, key in (("fd_probes_sent", "messages_ping_sent"),
                          ("fd_ping_req_sent", "messages_ping_req_sent"),
                          ("fd_tracked_verdicts", "messages_ping")):
        if key in tick_metrics:
            out[reg_name] = torch.as_tensor(tick_metrics[key]).sum(
                dtype=torch.int32)
    return out
