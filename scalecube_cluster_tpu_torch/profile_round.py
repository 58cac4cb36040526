"""Where a round spends its time on the card.

Runs the bench workload (LAN defaults, loss 0.02, node 3 crashed at
round 10, focal K subjects) at N members in one carry/wire layout
(``--layout``: wide, int16_wire, compact, compact_wire24) and delivery
mode (``--delivery``: shift, the bench's, or scatter), or with
``--network`` the network configuration instead (``network_params`` /
``network_world``: the same workload with a 50 ms mean link delay, a
4-slot delay ring, a six-window brownout, a two-way block of node 5
and four user gossips), and with ``--planes`` with the three tick-level
planes on (``with_planes``: the anti-entropy exchange every 32 rounds,
Lifeguard multipliers up to 8, a dead-member suppression window two
rounds past the spread window): a warm-up window, a window timed on the
host clock (ending in a device sync), then the same window again under
``torch.profiler``.  Reports, per round: wall time, device busy time and
idle share, kernel launches, device time and kernel launches inside
each phase range of ``models/swim.py`` (``swim.carry``/``context``/
``fd``/``delivery``/``merge``/``metrics``/``metadata``, in a traced
window, ``profile_window(..., trace_capacity=C)``, the trace's
``trace.record``: one ``trace_observe`` launch a round, and in an
instrumented one, ``profile_window(..., runner=...)``, the metrics
plane's ``metrics.observe``, the monitor's ``monitor.check`` and
``monitor.record`` (its ``trace_record`` launches) and the provenance
plane's ``provenance.observe``: one ``provenance_observe`` launch a
round), the top kernels
by device time, and the delay ring's bytes.

Run on a card: ``python -m scalecube_cluster_tpu_torch.profile_round
[--n 1000000] [--layout wide [compact ...]] [--delivery scatter]
[--network] [--planes]``.
Prints one JSON line per layout, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from scalecube_cluster_tpu_torch.config import ClusterConfig
from scalecube_cluster_tpu_torch.models import swim

PHASES = ("swim.carry", "swim.context", "swim.fd", "swim.delivery",
          "swim.merge", "swim.metrics", "swim.metadata", "trace.record",
          "provenance.observe", "metrics.observe", "monitor.check",
          "monitor.record")
# Knob settings of each carry/wire layout.
LAYOUTS = {"wide": {}, "int16_wire": dict(int16_wire=True),
           "compact": dict(compact_carry=True),
           "compact_wire24": dict(compact_carry=True, wire24=True)}
# Kernels launched through ctypes are no aten op's children, so the
# profiler does not add them to the enclosing range's device time: the
# port's own kernels join the phase range that holds their launch call
# (matched by correlation id), else their phase by name.
_OWN_KERNELS = {"merge_and_timers_kernel": "swim.merge",
                "carry_decode_kernel": "swim.carry",
                "carry_encode_kernel": "swim.carry",
                "trace_observe_kernel": "trace.record",
                "trace_record_kernel": "trace.record",
                "provenance_observe_kernel": "provenance.observe"}
INT32_MAX = 2**31 - 1
# The network configuration's schedule for a 600-round run (rounds scale
# with the run's length): a brownout of the links from the first tenth
# of the ids to the rest (chaos.Brownout(peak_loss=0.5,
# peak_delay_ms=400, from_round=100, ramp_rounds=60, hold_rounds=60,
# steps=3) as its six rule windows: from, until, loss, mean delay ms),
# node 5 blocked both ways, four user gossips spread at round 20.
BROWNOUT = ((100, 120, 0.5 * 1 / 3, 400.0 * 1 / 3),
            (120, 140, 0.5 * 2 / 3, 400.0 * 2 / 3),
            (140, 160, 0.5, 400.0),
            (160, 220, 0.5, 400.0),
            (220, 240, 0.5 * 2 / 3, 400.0 * 2 / 3),
            (240, 260, 0.5 * 1 / 3, 400.0 * 1 / 3))
BLOCKED, BLOCK_ROUNDS = 5, (300, 350)
SPREAD_AT = 20
NETWORK_ROUNDS = 600
# A round inside the brownout's hold window (one rule active at its peak
# loss and delay), where the profiled window of --network starts.
NETWORK_PEAK = 160


def with_planes(params: swim.SwimParams,
                sync_interval: int = 32) -> swim.SwimParams:
    """``params`` with the three tick-level planes on: the anti-entropy
    exchange every ``sync_interval`` rounds (``bench.py --sync``'s 32; 0
    leaves it off), Lifeguard with multipliers up to 8, and a suppression
    window of ``periods_to_spread + 2`` rounds."""
    return dataclasses.replace(
        params, sync_interval=sync_interval, lhm_max=8,
        dead_suppress_rounds=params.periods_to_spread + 2)


def bench_params(layout: str, n: int, k: int, delivery: str = "shift",
                 **overrides) -> swim.SwimParams:
    """The bench workload's params: LAN defaults, loss 0.02."""
    return swim.SwimParams.from_config(
        ClusterConfig.default(), n_members=n, n_subjects=k,
        loss_probability=0.02, delivery=delivery, **LAYOUTS[layout],
        **overrides)


def network_params(layout: str, n: int, k: int, delivery: str = "shift",
                   **overrides) -> swim.SwimParams:
    """The network configuration's params: the bench workload's with a
    mean link delay of 50 ms, a 4-slot delay ring, four user gossips."""
    return bench_params(layout, n, k, delivery, mean_delay_ms=50.0,
                        max_delay_rounds=3, n_user_gossips=4, **overrides)


def network_world(params: swim.SwimParams, device,
                  rounds: int = NETWORK_ROUNDS) -> swim.SwimWorld:
    """The network configuration's world for a run of ``rounds`` rounds
    (the schedule's rounds scaled by ``rounds / 600``): node 3 crashed at
    round 10, the brownout from ids [0, N/10) to [N/10, N), node 5
    blocked both ways, user gossips from nodes 7, N/4, N/2 and N - 1."""
    n = params.n_members

    def at(r):
        return r * rounds // NETWORK_ROUNDS

    edge = round(n / 10)
    world = swim.SwimWorld.healthy(params, device=device).with_crash(
        3, at_round=10)
    for lo, hi, loss, delay in BROWNOUT:
        world = world.with_link_fault((0, edge), (edge, n), loss,
                                      delay_ms=delay, from_round=at(lo),
                                      until_round=at(hi))
    lo, hi = (at(r) for r in BLOCK_ROUNDS)
    world = (world.with_block(BLOCKED, (0, n), lo, hi)
             .with_block((0, n), BLOCKED, lo, hi))
    for g, origin in enumerate((7, n // 4, n // 2, n - 1)):
        world = world.with_spread(g, origin, at(SPREAD_AT))
    return world


def _range_launches(prof, rounds: int) -> dict:
    """Kernel launches per round issued inside each phase range: the
    runtime's launch calls whose start falls in one of the range's host
    spans (this counts the ctypes launches of the port's kernels too)."""
    events = prof.events()
    launches = sorted(e.time_range.start for e in events
                      if e.name.startswith("cudaLaunchKernel"))
    out = {}
    for phase in PHASES:
        n = 0
        for e in events:
            if e.name == phase and e.device_type == DeviceType.CPU:
                lo = bisect.bisect_left(launches, e.time_range.start)
                hi = bisect.bisect_right(launches, e.time_range.end)
                n += hi - lo
        out[phase] = n / rounds
    return out


def _own_kernel_phases(prof) -> dict:
    """Device microseconds of the port's own kernels by phase: each
    kernel goes to the innermost phase range whose host span holds the
    runtime launch call with its correlation id, else to its phase in
    ``_OWN_KERNELS``."""
    events = prof.events()
    ranges = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in events
                    if e.name in PHASES and e.device_type == DeviceType.CPU)
    launch_at = {e.id: e.time_range.start for e in events
                 if e.name.startswith("cudaLaunchKernel")}
    out = {}
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        phase = next((p for k, p in _OWN_KERNELS.items() if k in e.name),
                     None)
        if phase is None:
            continue
        at = launch_at.get(e.id)
        if at is not None:
            holding = [r for r in ranges if r[0] <= at <= r[1]]
            if holding:
                phase = max(holding, key=lambda r: r[0])[2]
        out[phase] = out.get(phase, 0.0) + e.time_range.elapsed_us()
    return out


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def profile_window(params, world, state, start_round: int, rounds: int,
                   top: int = 12, trace_capacity: int = 0,
                   runner=None, traces: int = 5) -> dict:
    """Run ``rounds`` rounds from ``state`` at ``start_round`` twice: on
    the host clock (ending in a device sync), then under
    ``torch.profiler``.  Returns per-round wall ms, device busy ms, idle
    share, kernel launches, device ms per phase range, the top kernels
    the window's peak device memory, the kernel launches issued inside
    each phase range and the delay ring's bytes.  ``trace_capacity`` > 0
    runs the window traced (``swim.run_traced`` into a fresh buffer of
    that many events); ``runner(state, start_round, rounds)``, if given,
    runs it instead (an instrumented entry point: ``run_metered``,
    ``run_monitored``, ``run_composed``, or the gossip-only model's
    ``models.gossip.run``, with ``world`` None).  A profiled run that
    shows no device time is run again, up to ``traces`` times in all."""
    device = None if world is None else world.device

    def window():
        if runner is not None:
            runner(state, start_round, rounds)
        elif trace_capacity:
            swim.run_traced(0, params, world, rounds,
                            trace_capacity=trace_capacity, state=state,
                            start_round=start_round, device=device)
        else:
            swim.run(0, params, world, rounds, state=state,
                     start_round=start_round, device=device)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    window()
    wall_ms = (time.perf_counter() - t0) / rounds * 1e3
    peak_bytes = torch.cuda.max_memory_allocated()
    # The tracer now and then misses a whole window's device activity
    # (several in a row while the host's cores are busy): such a trace is
    # taken again after a pause.
    for attempt in range(traces):
        if attempt:
            time.sleep(0.5)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            window()
        rows = prof.key_averages()
        if any(e.device_type == DeviceType.CUDA and e.device_time_total > 0
               for e in rows):
            break
    else:
        raise RuntimeError(f"the profiler saw no device time in {traces} "
                           f"traces of the window")
    per_round = 1e-3 / rounds                         # us total -> ms/round
    kernels = [e for e in rows
               if e.device_type == DeviceType.CUDA and e.key not in PHASES]
    busy_ms = sum(e.device_time_total for e in kernels) * per_round
    phases = {e.key: e.device_time_total * per_round for e in rows
              if e.key in PHASES and e.device_type == DeviceType.CPU}
    for phase, us in _own_kernel_phases(prof).items():
        phases[phase] = phases.get(phase, 0.0) + us * per_round
    top_kernels = sorted(kernels, key=lambda e: e.device_time_total,
                         reverse=True)
    rings = (getattr(state, name, None)
             for name in ("inbox_ring", "flag_ring", "g_ring", "ring"))
    ring_bytes = sum(t.numel() * t.element_size() for t in rings
                     if t is not None)
    return dict(
        rounds=rounds, start_round=start_round,
        wall_ms_per_round=wall_ms,
        member_rounds_per_s=params.n_members / wall_ms * 1e3,
        device_busy_ms_per_round=busy_ms,
        device_idle_share=1.0 - busy_ms / wall_ms,
        kernel_launches_per_round=sum(e.count for e in kernels) / rounds,
        phase_device_ms_per_round=phases,
        phase_launches_per_round=_range_launches(prof, rounds),
        ring_bytes=ring_bytes,
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
    ap.add_argument("--warmup", type=int, default=None,
                    help="rounds run before the window (default 20; with "
                         f"--network {NETWORK_PEAK}, the brownout's peak)")
    ap.add_argument("--delivery", choices=("shift", "scatter"),
                    default="shift")
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--network", action="store_true",
                    help="profile the network configuration (delays, "
                         "rules, ring, user gossips) instead of the bench "
                         "workload")
    ap.add_argument("--planes", action="store_true",
                    help="with the three tick-level planes on "
                         "(with_planes)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_round needs a CUDA card")
    device = swim.resolve_device("cuda")
    card = _card()
    results = []
    for layout in args.layout:
        if args.network:
            params = network_params(layout, args.n, args.k, args.delivery)
            world = network_world(params, device)
        else:
            params = bench_params(layout, args.n, args.k, args.delivery)
            world = swim.SwimWorld.healthy(params, device=device).with_crash(
                3, at_round=10)
        if args.planes:
            params = with_planes(params)
        warmup = args.warmup
        if warmup is None:
            warmup = NETWORK_PEAK if args.network else 20
        state, _ = swim.run(0, params, world, warmup, device=device)
        result = dict(card=card, n_members=args.n, n_subjects=args.k,
                      layout=layout, delivery=args.delivery,
                      network=args.network, planes=args.planes,
                      **profile_window(params, world, state, warmup,
                                       args.rounds, args.top))
        print(json.dumps(result), flush=True)
        results.append(result)
    return results


if __name__ == "__main__":
    main()
