"""Where a main-path round spends its time on the card.

Runs the bench workload (LAN defaults, loss 0.02, node 3 crashed at
round 10, focal K subjects) at N members: a warm-up window, a window
timed on the host clock (ending in a device sync), then the same window
again under ``torch.profiler``.  Reports, per round: wall time, device
busy time and idle share, kernel launches, device time inside each phase
range of ``models/swim.py`` (``swim.context``/``fd``/``delivery``/
``merge``/``metrics``), and the top kernels by device time.

Run on a card:
``python -m scalecube_cluster_tpu_torch.profile_round [--n 1000000]``.
Prints one JSON line, with the card's name and power limit.
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

PHASES = ("swim.context", "swim.fd", "swim.delivery", "swim.merge",
          "swim.metrics")


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_round needs a CUDA card")
    device = swim.resolve_device("cuda")
    params = swim.SwimParams.from_config(
        ClusterConfig.default(), n_members=args.n, n_subjects=args.k,
        loss_probability=0.02, delivery="shift")
    world = swim.SwimWorld.healthy(params, device=device).with_crash(
        3, at_round=10)
    state, _ = swim.run(0, params, world, args.warmup, device=device)

    def window():
        swim.run(0, params, world, args.rounds, state=state,
                 start_round=args.warmup, device=device)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    window()
    wall_ms = (time.perf_counter() - t0) / args.rounds * 1e3
    peak_bytes = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        window()

    rows = prof.key_averages()
    per_round = 1e-3 / args.rounds                    # us total -> ms/round
    kernels = [e for e in rows
               if e.device_type == DeviceType.CUDA and e.key not in PHASES]
    busy_ms = sum(e.device_time_total for e in kernels) * per_round
    phases = {e.key: e.device_time_total * per_round for e in rows
              if e.key in PHASES and e.device_type == DeviceType.CPU}
    # A kernel launched through ctypes is no aten op's child, so the
    # profiler does not attribute it to the enclosing range: add the
    # port's own kernels to their phase by name.
    phases["swim.merge"] = phases.get("swim.merge", 0.0) + sum(
        e.device_time_total for e in kernels
        if "merge_and_timers_kernel" in e.key) * per_round
    top =sorted(kernels, key=lambda e: e.device_time_total, reverse=True)
    result = dict(
        card=_card(), n_members=args.n, n_subjects=args.k,
        rounds=args.rounds, start_round=args.warmup,
        wall_ms_per_round=wall_ms,
        member_rounds_per_s=args.n / wall_ms * 1e3,
        device_busy_ms_per_round=busy_ms,
        device_idle_share=1.0 - busy_ms / wall_ms,
        kernel_launches_per_round=sum(e.count for e in kernels) / args.rounds,
        phase_device_ms_per_round=phases,
        peak_bytes_allocated=peak_bytes,
        top_kernels=[dict(name=e.key[:100],
                          ms_per_round=e.device_time_total * per_round,
                          launches_per_round=e.count / args.rounds)
                     for e in top[:args.top]],
    )
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
