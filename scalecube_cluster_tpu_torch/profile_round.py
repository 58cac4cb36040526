"""Where a main-path round spends its time on the card.

Runs the bench workload (LAN defaults, loss 0.02, node 3 crashed at
round 10, focal K subjects) at N members in one carry/wire layout
(``--layout``: wide, int16_wire, compact, compact_wire24): a warm-up
window, a window timed on the host clock (ending in a device sync), then
the same window again under ``torch.profiler``.  Reports, per round:
wall time, device busy time and idle share, kernel launches, device time
inside each phase range of ``models/swim.py`` (``swim.carry``/
``context``/``fd``/``delivery``/``merge``/``metrics``), and the top
kernels by device time.

Run on a card: ``python -m scalecube_cluster_tpu_torch.profile_round
[--n 1000000] [--layout wide [compact ...]]``.
Prints one JSON line per layout, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from scalecube_cluster_tpu_torch.config import ClusterConfig
from scalecube_cluster_tpu_torch.models import swim

PHASES = ("swim.carry", "swim.context", "swim.fd", "swim.delivery",
          "swim.merge", "swim.metrics")
# Knob settings of each carry/wire layout.
LAYOUTS = {"wide": {}, "int16_wire": dict(int16_wire=True),
           "compact": dict(compact_carry=True),
           "compact_wire24": dict(compact_carry=True, wire24=True)}
# Kernels launched through ctypes are no aten op's children, so the
# profiler does not attribute them to the enclosing range: the port's
# own kernels join their phase by name.
_OWN_KERNELS = {"merge_and_timers_kernel": "swim.merge",
                "carry_decode_kernel": "swim.carry",
                "carry_encode_kernel": "swim.carry"}


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def profile_window(params, world, state, start_round: int, rounds: int,
                   top: int = 12) -> dict:
    """Run ``rounds`` rounds from ``state`` at ``start_round`` twice: on
    the host clock (ending in a device sync), then under
    ``torch.profiler``.  Returns per-round wall ms, device busy ms, idle
    share, kernel launches, device ms per phase range, the top kernels
    and the window's peak device memory."""
    device = world.device

    def window():
        swim.run(0, params, world, rounds, state=state,
                 start_round=start_round, device=device)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    window()
    wall_ms = (time.perf_counter() - t0) / rounds * 1e3
    peak_bytes = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        window()

    rows = prof.key_averages()
    per_round = 1e-3 / rounds                         # us total -> ms/round
    kernels = [e for e in rows
               if e.device_type == DeviceType.CUDA and e.key not in PHASES]
    busy_ms = sum(e.device_time_total for e in kernels) * per_round
    phases = {e.key: e.device_time_total * per_round for e in rows
              if e.key in PHASES and e.device_type == DeviceType.CPU}
    for e in kernels:
        for kernel, phase in _OWN_KERNELS.items():
            if kernel in e.key:
                phases[phase] = (phases.get(phase, 0.0)
                                 + e.device_time_total * per_round)
    top_kernels = sorted(kernels, key=lambda e: e.device_time_total,
                         reverse=True)
    return dict(
        rounds=rounds, start_round=start_round,
        wall_ms_per_round=wall_ms,
        member_rounds_per_s=params.n_members / wall_ms * 1e3,
        device_busy_ms_per_round=busy_ms,
        device_idle_share=1.0 - busy_ms / wall_ms,
        kernel_launches_per_round=sum(e.count for e in kernels) / rounds,
        phase_device_ms_per_round=phases,
        peak_bytes_allocated=peak_bytes,
        top_kernels=[dict(name=e.key[:100],
                          ms_per_round=e.device_time_total * per_round,
                          launches_per_round=e.count / rounds)
                     for e in top_kernels[:top]],
    )


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--layout", choices=sorted(LAYOUTS), nargs="+",
                    default=["wide"],
                    help="one or more layouts, profiled in the order given "
                         "(repeat them, e.g. A B B A, to compare in turns)")
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_round needs a CUDA card")
    device = swim.resolve_device("cuda")
    card = _card()
    results = []
    for layout in args.layout:
        params = swim.SwimParams.from_config(
            ClusterConfig.default(), n_members=args.n, n_subjects=args.k,
            loss_probability=0.02, delivery="shift", **LAYOUTS[layout])
        world = swim.SwimWorld.healthy(params, device=device).with_crash(
            3, at_round=10)
        state, _ = swim.run(0, params, world, args.warmup, device=device)
        result = dict(card=card, n_members=args.n, n_subjects=args.k,
                      layout=layout,
                      **profile_window(params, world, state, args.warmup,
                                       args.rounds, args.top))
        print(json.dumps(result), flush=True)
        results.append(result)
    return results


if __name__ == "__main__":
    main()
