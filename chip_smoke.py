#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``scalecube_cluster_tpu_torch``) on one
NVIDIA GPU.

Phases, each raising on a failed check (the process then exits non-zero
and prints no result):

1. the card's name and power limit (``nvidia-smi``); no CUDA, no run;
2. build every CUDA source in ``csrc/`` with ``nvcc``, one process each,
   all started together;
3. each kernel against its plain PyTorch version on the card at the main
   path's shape (N = 1,000,000 x K = 16), exact equality, timed with
   CUDA events (median): the three merge instances (wide, wire16,
   wire24) on seeded planes with every edge case of the merge and
   incarnations at each format's cap, and the compact carry's decode and
   encode on planes with the sentinel, stale negative deadlines and the
   spread clip edges;
4. the probe path: ``python -m scalecube_cluster_tpu_torch.mosaic_probe``
   at [512, 128] and at [1,000,000, 16] (each probe once, checked against
   its plain version), then each probe timed at both shapes on the
   device clock (``torch.profiler``: a probe takes at most about 0.1 ms,
   near the host's time to issue one wrapper call, so CUDA events around
   back-to-back calls would time the host), with the one PyTorch
   call that computes the same function where there is one
   (``torch.add(x, 1, out=<int16>)`` for store16, ``torch.gt(x, y,
   out=<int32>)`` for cmp16), checked equal to the kernel.  The two
   vectorised probes (store16, cmp16) are also held exactly against
   their plain versions at ragged shapes ([999,999, 13], [3, 5]: the
   scalar tail runs) and must refuse a 16-byte-misaligned input with
   ``ValueError``;
5. parity canaries, card against CPU with the same CPU-made draws, 200
   rounds, state and metrics bit-identical: wide at 4,096 x 16 and full
   view 512 x 512, compact carry at both, int16 wire at 4,096 x 16;
6. the main path and the layout identity: LAN defaults, N = 1,000,000
   members x K = 16 subjects, loss 0.02, node 3 crashed at round 10, the
   port's own device draws, 600 rounds through ``models.swim.run`` in the
   wide layout and again under ``int16_wire``, ``compact_carry`` and
   ``compact_carry`` + ``wire24``.  Every run must suspect node 3 within
   50 rounds and have >= 99% of live observers hold it DEAD by the end
   (its suspicion timeout is 500 rounds at this size); each narrow run
   must give the wide run's per-round metrics and decoded final state
   exactly.  Each layout prints ms/round, member-rounds/s, kernel
   launches per round (a profiled 20-round window) and peak memory (and
   the bytes already allocated when its run began);
7. one ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``.

Run from the repository root: ``python3 chip_smoke.py``.
"""

import json
import statistics
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from scalecube_cluster_tpu_torch import mosaic_probe, profile_round, records
from scalecube_cluster_tpu_torch.config import ClusterConfig
from scalecube_cluster_tpu_torch.kernels import LAUNCHES, _build
from scalecube_cluster_tpu_torch.kernels import carry, merge, probes
from scalecube_cluster_tpu_torch.models import swim
from scalecube_cluster_tpu_torch.ops import delivery, prng

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the float32
# non-tensor rate, an upper limit on 32-bit integer issue (so the
# operation bound below stays a lower bound).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# 32-bit operations per cell of each kernel (index arithmetic, loads and
# stores, and the function's own integer work), read off the sources.
OPS_PER_CELL = {"merge": 60, "carry_decode": 10, "carry_encode": 20,
                "probe_load16": 6, "probe_store16": 6, "probe_cmp16": 7,
                "probe_load8": 6, "probe_merge_core": 25}

MAIN_N, MAIN_K, MAIN_ROUNDS, CRASHED, CRASH_AT = 1_000_000, 16, 600, 3, 10
CANARY_ROUNDS = 200
PROFILE_ROUNDS = 20
INT32_MAX = 2**31 - 1
LAYOUTS = profile_round.LAYOUTS
# Our kernels each layout's round launches, once a round.
ROUND_KERNELS = {
    "wide": (merge.NAMES["wide"],),
    "int16_wire": (merge.NAMES["wire16"],),
    "compact": (merge.NAMES["wire16"], carry.DECODE, carry.ENCODE),
    "compact_wire24": (merge.NAMES["wire24"], carry.DECODE, carry.ENCODE),
}
CSRC = "scalecube_cluster_tpu_torch/csrc/"


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


def device_ms(fn, calls=50, warmup=3):
    """Mean device milliseconds per call of ``fn()``: the summed time of
    the CUDA kernels (and copies) it runs, from a ``torch.profiler``
    trace of ``calls`` calls, without the host's time between them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    if us <= 0:
        raise AssertionError("the profiler saw no device time")
    return us / calls / 1e3


def library_store16(x):
    """One PyTorch call for ``probe_store16``: the add runs in int32 and
    narrows to int16 on the store."""
    return torch.add(x, 1, out=torch.empty(x.shape, dtype=torch.int16,
                                           device=x.device))


def library_cmp16(x, y):
    """One PyTorch call for ``probe_cmp16``: ``x > y`` stored as int32."""
    return torch.gt(x, y, out=torch.empty(x.shape, dtype=torch.int32,
                                          device=x.device))


# The probes one PyTorch call computes (the others convert and then do
# arithmetic the narrow type would wrap, so they take two calls).
PROBE_LIBRARY = {"probe_store16": library_store16,
                 "probe_cmp16": library_cmp16}
RAGGED_SHAPES = ((999_999, 13), (3, 5))


def layout_params(layout, n, k):
    return swim.SwimParams.from_config(
        ClusterConfig.default(), n_members=n, n_subjects=k,
        loss_probability=0.02, delivery="shift", **LAYOUTS[layout])


def max_abs_err(name, got, want):
    """Largest |kernel - plain| over the outputs; raises on a dtype or
    shape mismatch or any difference."""
    err = 0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{name}: {g.dtype}{tuple(g.shape)} vs "
                                 f"plain {w.dtype}{tuple(w.shape)}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                           .abs().max()))
    if err != 0:
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"(max abs err {err})")
    return err


def timed_row(name, kernel, plain, tensors, ops_key, shape_cells, err,
              library=None, clock="events"):
    """Kernel, plain and (where one exists) library times, and the bound
    from the bytes ``tensors`` (inputs and outputs) hold and the
    operations ``shape_cells`` cells need.  ``clock`` is ``"events"``
    (CUDA events around back-to-back calls) or ``"device"``
    (:func:`device_ms`, for shapes where the host's issue rate would
    set the event time)."""
    if clock == "device":
        ms, plain_ms = device_ms(kernel), device_ms(plain)
        library_ms = device_ms(library) if library else None
    else:
        ms, plain_ms = time_ms(kernel), time_ms(plain, inner=2)
        library_ms = time_ms(library) if library else None
    n_bytes = sum(t.numel() * t.element_size() for t in tensors)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = shape_cells * OPS_PER_CELL[ops_key] / OPS_PER_S * 1e3
    library_text = ("" if library_ms is None
                    else f", library {library_ms:.4f} ms")
    log(f"[kernel] {name}: exact match, {ms:.4f} ms (plain {plain_ms:.4f} "
        f"ms{library_text}; {clock} clock), bound "
        f"{max(bytes_ms, ops_ms):.4f} ms ({n_bytes} B moved; operation "
        f"bound {ops_ms:.4f} ms)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=library_ms)


def merge_planes(n, k, seed, device, fmt, cap, round_idx=37):
    """Seeded merge inputs reaching every branch: ABSENT and DEAD entries,
    the ABSENT opener with and without ALIVE arrivals, self cells
    overridden and not, frozen rows, timers pending/firing/none, and
    incarnations at ``cap``.  ``status``/``inc`` are pinned; the inbox is
    packed in ``fmt`` (its dtype)."""
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
    small = [0, 0, 0, 1, 1, 2, 3, 5, cap - 1, cap]
    status = randint(0, 4, (n, k)).to(torch.int8)
    inc = choice(small, (n, k))
    self_inc = choice(small, (n,))
    delta = randint(-1, 2, (n, k))
    win_inc = torch.clamp(inc + delta, 0, cap)
    win_inc = torch.where(rand((n, k)) < 0.1, cap, win_inc)
    win_inc = torch.where(is_self, torch.clamp(self_inc[:, None] + delta, 0,
                                               cap), win_inc)
    inbox = delivery.pack_record(randint(0, 4, (n, k)), win_inc, fmt=fmt)
    inbox = torch.where(rand((n, k)) < 0.15, -1, inbox)
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


def check_merge_kernel(device, layout):
    """Phase 3: one merge instance vs its plain version at 1M x 16."""
    params = layout_params(layout, MAIN_N, MAIN_K)
    fmt, cap = params.wire_format, swim._wire_inc_sat(params)
    planes = merge_planes(MAIN_N, MAIN_K, seed=1, device=device, fmt=fmt,
                          cap=cap)
    if planes["inbox"].dtype != fmt.dtype:
        raise AssertionError(f"{fmt.name} planes carry a "
                             f"{planes['inbox'].dtype} inbox")
    args = list(planes.values()) + [37, params.suspicion_rounds,
                                    params.periods_to_spread, cap]
    got = merge.merge_and_timers(*args, fmt=fmt)
    torch.cuda.synchronize()
    want = merge.merge_and_timers_reference(*args, fmt=fmt)
    name = merge.NAMES[fmt.name]
    err = max_abs_err(name, got, want)
    if not bool(got[5].any()):
        raise AssertionError(f"{name}: planes missed the refutation case")
    if int(got[4].max()) != cap:
        raise AssertionError(f"{name}: no self_inc at the cap {cap}")
    return timed_row(
        f"{name} {MAIN_N}x{MAIN_K} (inbox {fmt.dtype}, cap {cap})",
        lambda: merge.merge_and_timers(*args, fmt=fmt),
        lambda: merge.merge_and_timers_reference(*args, fmt=fmt),
        list(planes.values()) + list(got), "merge", MAIN_N * MAIN_K, err)


def check_codec(device, round_idx=300, inc_sat=8191):
    """Phase 3: the compact carry's decode and encode at 1M x 16."""
    g = torch.Generator(device=device).manual_seed(2)
    shape = (MAIN_N, MAIN_K)

    def pick(values):
        values = torch.tensor(values, dtype=torch.int64, device=device)
        idx = torch.randint(0, len(values), shape, generator=g, device=device)
        return values[idx].to(torch.int32)

    def full_range(dtype):
        info = torch.iinfo(dtype)
        return torch.randint(info.min, info.max + 1, shape, generator=g,
                             device=device, dtype=torch.int64).to(dtype)

    # decode: every int16/int8 value, the sentinel 32767 among them.
    narrow = (full_range(torch.int16), full_range(torch.int8),
              full_range(torch.int16))
    narrow[2].view(-1)[::7] = carry.DEADLINE_NONE16
    # encode: no timer, due, stale (past -32766 too), far ahead, spreads
    # below the cursor and beyond 127 ahead, incarnations past the cap.
    nxt = round_idx + 1
    wide = (pick([0, 1, 7, inc_sat - 1, inc_sat, inc_sat + 1, 32767, 40000]),
            nxt + torch.randint(-300, 300, shape, generator=g, device=device,
                                dtype=torch.int32),
            pick([INT32_MAX, nxt, nxt - 1, nxt - 500, nxt - 32766,
                  nxt - 40000, nxt + 1, nxt + 32765, nxt + 32766,
                  nxt + 32767, nxt + 90000]))
    rows = {}
    for name, fn, ref, ins, extra in (
            (carry.DECODE, carry.carry_decode, carry.carry_decode_reference,
             narrow, (round_idx,)),
            (carry.ENCODE, carry.carry_encode, carry.carry_encode_reference,
             wide, (round_idx, inc_sat))):
        got = fn(*ins, *extra)
        torch.cuda.synchronize()
        err = max_abs_err(name, got, ref(*ins, *extra))
        if name == carry.ENCODE:
            dl = got[2]
            if not (bool((dl == carry.DEADLINE_NONE16).any())
                    and bool((dl < 0).any()) and bool((got[1] == 0).any())
                    and bool((got[1] == 127).any())):
                raise AssertionError("encode planes missed a clip edge")
        rows[name] = timed_row(
            f"{name} {MAIN_N}x{MAIN_K}", lambda: fn(*ins, *extra),
            lambda: ref(*ins, *extra), list(ins) + list(got), name,
            MAIN_N * MAIN_K, err)
    return rows


def check_vectorised(device, name):
    """Phase 4: a vectorised probe exact at the ragged shapes, and
    refusing a misaligned input."""
    for rows_, cols in RAGGED_SHAPES:
        mosaic_probe.check(name, mosaic_probe.make_inputs(rows_, cols, 1,
                                                          device)[name])
    ins = mosaic_probe.make_inputs(4, 8, 1, device)[name]
    for field, t in zip("xy", ins):
        shifted = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
        shifted = shifted[1:].view(t.shape)
        shifted.copy_(t)
        bad = [shifted if u is t else u for u in ins]
        try:
            probes.PROBES[name](*bad)
        except ValueError as exc:
            if f" {field} " not in str(exc):
                raise AssertionError(f"{name}: the misalignment error does "
                                     f"not name {field}: {exc}") from exc
        else:
            raise AssertionError(f"{name}: a misaligned {field} launched")
    shapes = ", ".join(f"{r}x{c}" for r, c in RAGGED_SHAPES)
    log(f"[kernel] {name}: exact at {shapes}; a 16-byte-misaligned input "
        f"raises ValueError")


def probe_path(device):
    """Phase 4: the probe entry point at both shapes (counts read right
    after each run), then each probe timed at both shapes, and the
    vectorised probes' ragged shapes and alignment."""
    launches, rows = {}, {}
    for rows_, cols in ((512, 128), (MAIN_N, MAIN_K)):
        LAUNCHES.clear()
        results = mosaic_probe.main(["--rows", str(rows_), "--cols",
                                     str(cols), "--seed", "0"])
        torch.cuda.synchronize()
        for name in probes.NAMES:
            if LAUNCHES[name] != 1:
                raise AssertionError(f"{name} launched {LAUNCHES[name]} "
                                     f"times in one probe run")
            launches[name] = launches.get(name, 0) + LAUNCHES[name]
        if [r["probe"] for r in results] != list(probes.NAMES):
            raise AssertionError("the probe run skipped a probe")
        inputs = mosaic_probe.make_inputs(rows_, cols, 0, device)
        for name in probes.NAMES:
            ins = inputs[name]
            got = probes.PROBES[name](*ins)
            got = got if isinstance(got, tuple) else (got,)
            library = PROBE_LIBRARY.get(name)
            if library is not None:
                max_abs_err(f"{name} library call", got, (library(*ins),))
            row = timed_row(f"{name} {rows_}x{cols}",
                            lambda: probes.PROBES[name](*ins),
                            lambda: probes.REFERENCES[name](*ins),
                            list(ins) + list(got), name, rows_ * cols, 0,
                            library=library and (lambda: library(*ins)),
                            clock="device")
            if name in probes.VECTORISED and rows_ == MAIN_N:
                row.update(design=probes.VECTORISED[name],
                           library_ratio=row["ms"] / row["library_ms"])
                log(f"[kernel] {name} {rows_}x{cols}: design "
                    f"{row['design']}, {row['library_ratio']:.3f} x the "
                    f"library call's time")
            rows.setdefault(name, {})[f"{rows_}x{cols}"] = row
    for name in probes.VECTORISED:
        check_vectorised(device, name)
    return launches, rows


def canary(device, layout, n, k, seed=5):
    """Phase 5: the same run on the card and on the CPU, same draws."""
    params = layout_params(layout, n, k)
    draws = prng.TorchDraws(seed, "cpu", params)
    runs = []
    for dev in ("cpu", device):
        world = swim.SwimWorld.healthy(params, device=dev).with_crash(
            CRASHED, at_round=CRASH_AT)
        LAUNCHES.clear()
        state, metrics = swim.run(seed, params, world, CANARY_ROUNDS,
                                  draws=lambda r: draws(r).to(dev),
                                  device=dev)
        runs.append((state, metrics, dict(LAUNCHES)))
    (cs, cm, cpu_launches), (gs, gm, gpu_launches) = runs
    for name in ("status", "inc", "spread_until", "suspect_deadline",
                 "self_inc"):
        if not torch.equal(getattr(cs, name), getattr(gs, name).cpu()):
            raise AssertionError(f"canary {layout} {n}x{k}: state.{name} "
                                 f"differs")
    for name, value in cm.items():
        if not torch.equal(value, gm[name].cpu()):
            raise AssertionError(f"canary {layout} {n}x{k}: metric {name} "
                                 f"differs")
    want = {name: CANARY_ROUNDS for name in ROUND_KERNELS[layout]}
    if cpu_launches or gpu_launches != want:
        raise AssertionError(f"canary {layout} {n}x{k}: launches cpu="
                             f"{cpu_launches} card={gpu_launches}, want "
                             f"none and {want}")
    log(f"[canary] {layout} {n}x{k}, {CANARY_ROUNDS} rounds: card == CPU "
        f"bit for bit ({gs.inc.dtype} inc), launches {gpu_launches}; "
        f"suspect@{CRASHED} peak {int(cm['suspect'][:, CRASHED].max())}")


def run_layout(device, layout):
    """Phase 6: one layout of the 1M x 16 round for 600 rounds, with the
    detection gates; returns what the identity check and the kernel line
    need."""
    params = layout_params(layout, MAIN_N, MAIN_K)
    world = swim.SwimWorld.healthy(params, device=device).with_crash(
        CRASHED, at_round=CRASH_AT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    state, metrics = swim.run(0, params, world, MAIN_ROUNDS, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    metrics = {name: value.cpu() for name, value in metrics.items()}

    for name, value in metrics.items():
        want = (MAIN_ROUNDS, MAIN_K) if value.dim() == 2 else (MAIN_ROUNDS,)
        if tuple(value.shape) != want:
            raise AssertionError(f"{layout}: metric {name} has shape "
                                 f"{tuple(value.shape)}")
    if tuple(state.status.shape) != (MAIN_N, MAIN_K):
        raise AssertionError(f"{layout}: state has the wrong shape")
    want = {name: MAIN_ROUNDS for name in ROUND_KERNELS[layout]}
    if launches != want:
        raise AssertionError(f"{layout}: kernel launches {launches} in "
                             f"{MAIN_ROUNDS} rounds, want {want}")
    suspect = metrics["suspect"][:, CRASHED]
    dead = metrics["dead"][:, CRASHED]
    first_suspect = int(torch.nonzero(suspect > 0)[0]) \
        if bool((suspect > 0).any()) else None
    if first_suspect is None or first_suspect > CRASH_AT + 50:
        raise AssertionError(f"{layout}: node {CRASHED} not suspected within "
                             f"50 rounds of its crash (first at "
                             f"{first_suspect})")
    dead_share = int(dead[-1]) / (MAIN_N - 1)
    if dead_share < 0.99:
        raise AssertionError(f"{layout}: only {dead_share:.4f} of live "
                             f"observers hold node {CRASHED} DEAD at round "
                             f"{MAIN_ROUNDS}")
    window = profile_round.profile_window(params, world, state, MAIN_ROUNDS,
                                          PROFILE_ROUNDS)
    ms_round = seconds / MAIN_ROUNDS * 1e3
    log(f"[main] {layout} {MAIN_N}x{MAIN_K}, {MAIN_ROUNDS} rounds in "
        f"{seconds:.3f} s: {ms_round:.4f} ms/round, "
        f"{MAIN_N * MAIN_ROUNDS / seconds:.6g} member-rounds/s, peak {peak} "
        f"B allocated ({resident} B resident before the run); profiled "
        f"{PROFILE_ROUNDS} rounds: "
        f"{window['kernel_launches_per_round']:.2f} kernel launches/round, "
        f"device busy {window['device_busy_ms_per_round']:.4f} ms/round, "
        f"wall {window['wall_ms_per_round']:.4f} ms/round, idle share "
        f"{window['device_idle_share']:.4f}, phases "
        f"{json.dumps(window['phase_device_ms_per_round'])}")
    log(f"[main] {layout} node {CRASHED}: first SUSPECT at round "
        f"{first_suspect}, first DEAD at round "
        f"{int(torch.nonzero(dead > 0)[0])}, {dead_share:.6f} of live "
        f"observers hold it DEAD at the end; false_positives total "
        f"{int(metrics['false_positives'].sum())}, refutations "
        f"{int(metrics['refutations'].sum())}")
    return params, state, metrics, launches


def decoded(state, params):
    """The final state as absolute int32 planes.  ``spread_until`` is
    taken as the gossip gate reads it (``round < spread_until``), i.e.
    clipped below at the cursor: the compact carry stores a spread
    window that has passed as 0 rounds remaining."""
    deadline, spread = swim._wide_timer_fields(state, params, MAIN_ROUNDS)
    return dict(status=state.status, inc=state.inc.to(torch.int32),
                spread_until=torch.clamp(spread, min=MAIN_ROUNDS),
                suspect_deadline=deadline, self_inc=state.self_inc)


def main_path(device):
    """Phase 6: wide, then each narrow layout against it."""
    launches = {}
    wide_params, wide_state, wide_metrics, counts = run_layout(device, "wide")
    launches.update(counts)
    # Held on the host, so that no narrow run's peak counts it.
    want = {name: value.cpu()
            for name, value in decoded(wide_state, wide_params).items()}
    del wide_state
    for layout in ("int16_wire", "compact", "compact_wire24"):
        params, state, metrics, counts = run_layout(device, layout)
        for name, count in counts.items():
            launches[name] = launches.get(name, 0) + count
        for name, value in wide_metrics.items():
            if not torch.equal(metrics[name], value):
                raise AssertionError(f"{layout}: metric {name} differs from "
                                     f"the wide run")
        for name, value in decoded(state, params).items():
            if not torch.equal(value.cpu(), want[name]):
                raise AssertionError(f"{layout}: decoded final {name} "
                                     f"differs from the wide run")
        log(f"[identity] {layout}: per-round metrics and decoded final "
            f"state equal the wide run's ({state.inc.dtype} inc, "
            f"{params.wire_format.name} wire)")
        del state
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
    sources = [merge.SOURCE, carry.SOURCE, probes.SOURCE]
    logs = _build.build(sources)
    log(f"[build] {', '.join(s + '.cu' for s in sources)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        log(f"[build] nvcc {name}: {' '.join(text.split())}")

    merge_rows = {layout: check_merge_kernel(device, layout)
                  for layout in ("wide", "int16_wire", "compact_wire24")}
    codec_rows = check_codec(device)
    probe_launches, probe_rows = probe_path(device)
    for layout, n, k in (("wide", 4096, 16), ("wide", 512, 512),
                         ("compact", 4096, 16), ("compact", 512, 512),
                         ("int16_wire", 4096, 16)):
        canary(device, layout, n, k)
    launches = main_path(device)

    kernels = []
    for layout, fmt in (("wide", "wide"), ("int16_wire", "wire16"),
                        ("compact_wire24", "wire24")):
        kernels.append(dict(
            name=merge.NAMES[fmt], route="cuda",
            source=CSRC + "merge_timers.cu",
            replaces="experiments/merge_kernel_bench.py:102",
            launches=launches.get(merge.NAMES[fmt], 0),
            **merge_rows[layout]))
    for name, line in ((carry.DECODE, 1570), (carry.ENCODE, 1595)):
        kernels.append(dict(
            name=name, route="cuda", source=CSRC + "carry_codec.cu",
            replaces=f"scalecube_cluster_tpu/models/swim.py:{line}",
            launches=launches.get(name, 0),
            **codec_rows[name]))
    for name in probes.NAMES:
        small = probe_rows[name]["512x128"]
        kernels.append(dict(
            name=name, route="cuda", source=CSRC + "mosaic_probes.cu",
            replaces=f"experiments/mosaic_probe.py:{probes.REPLACES[name][1]}",
            launches=probe_launches[name],
            **probe_rows[name][f"{MAIN_N}x{MAIN_K}"],
            ms_512x128=small["ms"],
            plain_ms_512x128=small["plain_ms"],
            library_ms_512x128=small["library_ms"],
            bound_ms_512x128=small["bound_ms"]))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
