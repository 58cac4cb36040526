#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``scalecube_cluster_tpu_torch``) on one
NVIDIA GPU.

Phases, each raising on a failed check (the process then exits non-zero
and prints no result):

1. the card's name and power limit (``nvidia-smi``); no CUDA, no run;
2. build every CUDA kernel of the main path from ``csrc/`` with ``nvcc``;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shape (N = 1,000,000 x K = 16) on seeded planes with every edge
   case of the merge, exact equality, timed with CUDA events (median);
4. parity canary: 4,096 x 16 and full view 512 x 512, 200 rounds each,
   run on the card (kernel) and on the CPU (plain version) with the same
   CPU-made draws — state and metrics bit-identical, one launch a round;
5. the main path: LAN defaults, N = 1,000,000 members x K = 16 subjects,
   loss 0.02, node 3 crashed at round 10, the port's own device draws,
   600 rounds through ``models.swim.run`` — observers must suspect node 3
   within 50 rounds and >= 99% of live observers hold it DEAD by the end
   (its suspicion timeout is 500 rounds at this size);
6. one ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``.

Run from the repository root: ``python3 chip_smoke.py``.
"""

import json
import statistics
import subprocess
import sys
import time

import torch

from scalecube_cluster_tpu_torch import records
from scalecube_cluster_tpu_torch.config import ClusterConfig
from scalecube_cluster_tpu_torch.kernels import LAUNCHES, _build
from scalecube_cluster_tpu_torch.kernels import merge
from scalecube_cluster_tpu_torch.models import swim
from scalecube_cluster_tpu_torch.ops import prng

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the float32
# non-tensor rate, an upper limit on 32-bit integer issue (so the
# operation bound below stays a lower bound).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# 32-bit operations per cell of csrc/merge_timers.cu (index arithmetic,
# loads and stores, unpack, gate, refutation, timers, freeze, selects).
MERGE_OPS_PER_CELL = 60

MAIN_N, MAIN_K, MAIN_ROUNDS, CRASHED, CRASH_AT = 1_000_000, 16, 600, 3, 10
CANARY_ROUNDS = 200
CAP = 2**29 - 1
INT32_MAX = 2**31 - 1


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, samples=20, inner=10, warmup=3):
    """Median over ``samples`` of the mean milliseconds per call of
    ``inner`` back-to-back calls of ``fn()`` between two CUDA events (the
    batch hides the host's launch latency behind the queued work)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def merge_planes(n, k, seed, device, round_idx=37):
    """Seeded merge inputs reaching every branch: ABSENT and DEAD entries,
    the ABSENT opener with and without ALIVE arrivals, self cells
    overridden and not, frozen rows, timers pending/firing/none, and
    incarnations at the key's cap.  ``status``/``inc`` are pinned."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=device)

    def rand(shape):
        return torch.rand(shape, generator=g, device=device)

    def choice(values, shape):
        values = torch.tensor(values, dtype=torch.int64, device=device)
        return values[randint(0, len(values), shape)]

    subject_ids = torch.randperm(n, generator=g, device=device)[:k]
    slot_of_node = torch.full((n,), -1, dtype=torch.int32, device=device)
    slot_of_node[subject_ids] = torch.arange(k, dtype=torch.int32,
                                             device=device)
    is_self = (torch.arange(k, device=device)[None, :]
               == slot_of_node[:, None])
    small = [0, 0, 0, 1, 1, 2, 3, 5, CAP - 1, CAP]
    status = randint(0, 4, (n, k)).to(torch.int8)
    inc = choice(small, (n, k))
    self_inc = choice(small, (n,))
    delta = randint(-1, 2, (n, k))
    win_inc = torch.clamp(inc + delta, 0, CAP)
    win_inc = torch.where(rand((n, k)) < 0.1, CAP, win_inc)
    win_inc = torch.where(is_self, torch.clamp(self_inc[:, None] + delta, 0,
                                               CAP), win_inc)
    inbox = records.merge_key(randint(0, 4, (n, k)), win_inc)
    inbox = torch.where(rand((n, k)) < 0.15, -1, inbox).to(torch.int32)
    deadline = choice([INT32_MAX, INT32_MAX, round_idx - 3, round_idx,
                       round_idx + 4, 0], (n, k)).to(torch.int32)
    return dict(
        status=torch.where(is_self, records.ALIVE, status).to(torch.int8),
        inc=torch.where(is_self, self_inc[:, None], inc).to(torch.int32),
        spread_until=randint(0, 2 * round_idx, (n, k)).to(torch.int32),
        suspect_deadline=deadline,
        inbox=inbox,
        inbox_alive=rand((n, k)) < 0.5,
        self_inc=self_inc.to(torch.int32),
        alive_here=rand((n,)) < 0.8,
        slot_of_node=slot_of_node,
    )


def check_merge_kernel(device):
    """Phase 3: kernel vs plain version at the main path's shape."""
    planes = merge_planes(MAIN_N, MAIN_K, seed=1, device=device)
    params = swim.SwimParams.from_config(
        ClusterConfig.default(), n_members=MAIN_N, n_subjects=MAIN_K,
        delivery="shift")
    args = list(planes.values()) + [37, params.suspicion_rounds,
                                    params.periods_to_spread,
                                    swim._wire_inc_sat(params)]
    got = merge.merge_and_timers(*args)
    torch.cuda.synchronize()
    want = merge.merge_and_timers_reference(*args)
    names = ("status", "inc", "spread_until", "suspect_deadline", "self_inc",
             "refuted")
    max_err = 0
    for name, g, w in zip(names, got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"merge kernel {name}: {g.dtype}{tuple(g.shape)}"
                                 f" vs plain {w.dtype}{tuple(w.shape)}")
        max_err = max(max_err, int((g.to(torch.int64) - w.to(torch.int64))
                                   .abs().max()))
    if max_err != 0:
        raise AssertionError(f"merge kernel disagrees with its plain version "
                             f"(max abs err {max_err})")
    if not bool(got[5].any()):
        raise AssertionError("merge planes missed the refutation case")

    ms = time_ms(lambda: merge.merge_and_timers(*args))
    plain_ms = time_ms(lambda: merge.merge_and_timers_reference(*args),
                       inner=2)
    n_bytes = sum(t.numel() * t.element_size()
                  for t in list(planes.values()) + list(got))
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = MAIN_N * MAIN_K * MERGE_OPS_PER_CELL / OPS_PER_S * 1e3
    log(f"[kernel] merge_and_timers {MAIN_N}x{MAIN_K}: exact match, "
        f"{ms:.4f} ms (plain {plain_ms:.4f} ms), bound {bytes_ms:.4f} ms "
        f"({n_bytes} B moved; operation bound {ops_ms:.4f} ms)")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def canary(device, n, k, seed=5):
    """Phase 4: the same run on the card and on the CPU, same draws."""
    params = swim.SwimParams.from_config(
        ClusterConfig.default(), n_members=n, n_subjects=k,
        loss_probability=0.02, delivery="shift")
    draws = prng.TorchDraws(seed, "cpu", params)
    runs = []
    for dev in ("cpu", device):
        world = swim.SwimWorld.healthy(params, device=dev).with_crash(
            CRASHED, at_round=CRASH_AT)
        LAUNCHES.clear()
        state, metrics = swim.run(seed, params, world, CANARY_ROUNDS,
                                  draws=lambda r: draws(r).to(dev),
                                  device=dev)
        runs.append((state, metrics, LAUNCHES[merge.NAME]))
    (cs, cm, cpu_launches), (gs, gm, gpu_launches) = runs
    for name in ("status", "inc", "spread_until", "suspect_deadline",
                 "self_inc"):
        if not torch.equal(getattr(cs, name), getattr(gs, name).cpu()):
            raise AssertionError(f"canary {n}x{k}: state.{name} differs")
    for name, value in cm.items():
        if not torch.equal(value, gm[name].cpu()):
            raise AssertionError(f"canary {n}x{k}: metric {name} differs")
    if cpu_launches != 0 or gpu_launches != CANARY_ROUNDS:
        raise AssertionError(f"canary {n}x{k}: launches cpu={cpu_launches} "
                             f"card={gpu_launches}, want 0 and "
                             f"{CANARY_ROUNDS}")
    log(f"[canary] {n}x{k}, {CANARY_ROUNDS} rounds: card == CPU bit for bit, "
        f"{gpu_launches} launches; suspect@{CRASHED} peak "
        f"{int(cm['suspect'][:, CRASHED].max())}")


def main_path(device):
    """Phase 5: the 1M x 16 focal round for 600 rounds."""
    params = swim.SwimParams.from_config(
        ClusterConfig.default(), n_members=MAIN_N, n_subjects=MAIN_K,
        loss_probability=0.02, delivery="shift")
    world = swim.SwimWorld.healthy(params, device=device).with_crash(
        CRASHED, at_round=CRASH_AT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    state, metrics = swim.run(0, params, world, MAIN_ROUNDS, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    metrics = {name: value.cpu() for name, value in metrics.items()}

    for name, value in metrics.items():
        want = (MAIN_ROUNDS, MAIN_K) if value.dim() == 2 else (MAIN_ROUNDS,)
        if tuple(value.shape) != want:
            raise AssertionError(f"metric {name} has shape {tuple(value.shape)}")
    if tuple(state.status.shape) != (MAIN_N, MAIN_K):
        raise AssertionError("state has the wrong shape")
    if launches.get(merge.NAME, 0) != MAIN_ROUNDS:
        raise AssertionError(f"merge kernel launched {launches} times in "
                             f"{MAIN_ROUNDS} rounds")
    suspect = metrics["suspect"][:, CRASHED]
    dead = metrics["dead"][:, CRASHED]
    first_suspect = int(torch.nonzero(suspect > 0)[0]) \
        if bool((suspect > 0).any()) else None
    if first_suspect is None or first_suspect > CRASH_AT + 50:
        raise AssertionError(f"node {CRASHED} not suspected within 50 rounds "
                             f"of its crash (first at {first_suspect})")
    live_observers = MAIN_N - 1
    dead_share = int(dead[-1]) / live_observers
    if dead_share < 0.99:
        raise AssertionError(f"only {dead_share:.4f} of live observers hold "
                             f"node {CRASHED} DEAD at round {MAIN_ROUNDS}")
    ms_round = seconds / MAIN_ROUNDS * 1e3
    log(f"[main] {MAIN_N}x{MAIN_K}, {MAIN_ROUNDS} rounds in {seconds:.3f} s: "
        f"{ms_round:.4f} ms/round, "
        f"{MAIN_N * MAIN_ROUNDS / seconds:.6g} member-rounds/s, peak "
        f"{torch.cuda.max_memory_allocated()} B allocated")
    log(f"[main] node {CRASHED}: first SUSPECT at round {first_suspect}, "
        f"first DEAD at round {int(torch.nonzero(dead > 0)[0])}, "
        f"{dead_share:.6f} of live observers hold it DEAD at the end; "
        f"false_positives total {int(metrics['false_positives'].sum())}, "
        f"refutations {int(metrics['refutations'].sum())}")
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "smoke run needs a CUDA card")
    t_start = time.perf_counter()
    device = swim.resolve_device("cuda")
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = _build.build([merge.SOURCE])
    log(f"[build] {merge.SOURCE}.cu in {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        log(f"[build] nvcc {name}: {' '.join(text.split())}")

    merge_row = check_merge_kernel(device)
    canary(device, 4096, 16)
    canary(device, 512, 512)
    launches = main_path(device)

    kernels = [dict(
        name=merge.NAME, route="cuda",
        source="scalecube_cluster_tpu_torch/csrc/merge_timers.cu",
        replaces="experiments/merge_kernel_bench.py:102",
        launches=launches.get(merge.NAME, 0), library_ms=None, **merge_row)]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
