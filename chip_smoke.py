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
   spread clip edges; then each of the five in block form (the K-tiled
   round's): [36,864 x 4,096] planes, blocks of 1,024 columns at columns
   0, 1,024 and 3,072 read through strided views and written through
   views into sentinel-filled planes, exact against the plain version on
   the same views, every other column untouched, timed at one block (row
   stride 4,096); the merge instances again with both plane branches on
   (``planes_*`` and ``block_planes_*`` fields): per-row armed rounds
   from seeded multipliers in [1, 8], a 64-round suppression window, on
   planes with suppressed and unsuppressed tombstones and expiries at the
   round and one round either side, checked to reach each case; then
   each of the three in its open-world epoch form (``epoch_*``,
   ``epoch_planes_*``, ``block_epoch_*``, ``block_epoch_planes_*``),
   plane off and on, at 1M x 16 and in block form, on planes checked to
   reach a lower-epoch winner, higher-epoch ALIVE, SUSPECT and DEAD
   winners, a higher-epoch ALIVE over a suppressed tombstone, equal
   epochs at the format's epoch-reduced incarnation cap, a self cell
   with a winner of another epoch (no refutation), frozen rows and an
   epoch change alone.  The merge instances at 1M x 16 are timed on the
   device clock (:func:`device_ms`), and their wrapper calls on CUDA
   events too (``events_ms``, ``planes_events_ms``), which at this shape
   also time the wrapper's host-side checks; the codec's two kernels on
   both clocks (``device_ms``);
3b. the event trace's two kernels (``csrc/trace_record.cu``) against
   their plain versions at 1M x 16: the codes-in record
   (``kernels/trace.trace_record``) on seeded code planes, a dense round
   (every event fits), a sparse round, a round overflowing the
   65,536-row capacity partway, a start count one below the capacity and
   at it, lanes, count and dropped exact; the traced round's fused
   observe (``kernels/trace.trace_observe``) on seeded prev/new carries
   (``observe_inputs``): the wide carry, an int32 epoch lane, the
   compact carry's int16 incarnations with an int16 epoch lane, leave
   rows under an observer offset, then dense, sparse, overflowing, one
   below capacity and at capacity, lanes, count, dropped, first_suspect
   and first_removed exact; each case checked to reach its edge; each
   kernel's sparse round (11,000-16,000 events) timed on the device
   clock and on CUDA events into a buffer it never fills, its dense one
   on the device clock (the count reset before each call), each beside
   its byte bound;
3c. the invariant monitor's evidence record (``check_monitor_record``:
   ``chaos/monitor.record_round``, one codes-in ``trace_record`` launch a
   checked code and one a self lane, the self lanes' subject the
   observer) against the same pass on the plain version at 1M x 16 into
   the monitor's 4,096 rows: every code tripped, the self lanes alone,
   codes no longer fresh (nothing recorded), an overflow partway through
   the codes, a start one row below the capacity and at it; lanes, count
   and dropped exact, each case checked to reach its edge; the passive
   monitor's record pass of a green round, one launch on an empty plane
   and the every-code round timed on the device clock beside their byte
   bounds (``monitor_*`` fields of the ``trace_record`` row);
3d. the provenance plane's round (``check_provenance_observe``:
   ``kernels/provenance.provenance_observe``, the third front end of
   ``csrc/trace_record.cu``) against its plain version at 1M x 16 on
   seeded carries and key planes (``provenance_inputs``): wide int32
   keys with the ping-req split, the int16 wire's keys, an int32 epoch
   lane and the compact carry's int16 lanes with join-rebirth columns,
   no ping-req members, self refutations and leavers under an observer
   offset, then dense, sparse, overflowing, one below capacity and at
   capacity; lanes, count and dropped exact, each case checked to reach
   its edge (its channels, JOINED rows, the self refutations at the
   bumped self rows only, the timer's REMOVED rows); its sparse and dense
   rounds timed beside their byte bounds;
4. the probe path: ``python -m scalecube_cluster_tpu_torch.mosaic_probe``
   at [512, 128] and at [1,000,000, 16] (each probe once, checked against
   its plain version), then each probe timed at both shapes on the
   device clock (``torch.profiler``: a probe takes at most about 0.1 ms,
   near the host's time to issue one wrapper call, so CUDA events around
   back-to-back calls would time the host; a timing whose five traces
   all miss the device falls back to CUDA events, logged as ``[clock]``
   and counted before the kernels line), with the one PyTorch
   call that computes the same function where there is one
   (``torch.add(x, one)`` for load16 and ``torch.mul(x, two)`` for load8,
   with ``one`` and ``two`` int32 tensors of shape (1,),
   ``torch.add(x, 1, out=<int16>)`` for store16, ``torch.gt(x, y,
   out=<int32>)`` for cmp16), checked equal to the kernel.  The two
   widening probes (load16, load8) are also timed at 1M x 16 beside
   ``x.to(torch.int32)``, a one-call copy that moves exactly their bytes
   but skips their arithmetic (``copy_ms``).
   The four vectorised probes (all but the merge core) are also held
   exactly against their plain versions at ragged shapes ([999,999, 13],
   [3, 5]: the scalar tail runs) and must refuse a 16-byte-misaligned
   input with ``ValueError``.  After each stage the seconds since the
   start and the card's clocks, temperature and power draw are printed;
5. parity canaries, card against CPU with the same CPU-made draws, 80
   rounds, state (every lane) and metrics bit-identical, and the card's
   kernel launches one a round for each kernel of the layout.  The CPU
   half of every canary (5, 5b, 5c) and of the blame drill (5d) runs in
   ``CPU_WORKERS`` worker processes started first (``start_cpu_halves``),
   while the card builds, checks its kernels and runs the probes.  Shift:
   full view 512 x 512 wide and under the compact carry (wide, compact,
   ``int16_wire`` and compact + ``wire24`` at 4,096 x 16 are 5b's
   untraced runs); the network configuration
   (``profile_round.network_*``: eight link-fault rules, a 50 ms mean
   delay, a 4-slot delay ring, four user gossips; its schedule scaled to
   80 rounds) at 4,096 x 16 in the wide, int16-wire and compact +
   wire24 layouts; a seeded cold start (seeds 0, 1, 2, node 5 blocked)
   at full view 512 x 512.  Scatter: wide at 4,096 x 16, wide and
   compact carry at full view 512 x 512 (the known-only probe's Gumbel
   argmax), int16 wire at 4,096 x 16, the network configuration at
   4,096 x 16 on the fused wire and on the two-buffer wire (scatter wide
   at 4,096 x 16 is 5b's untraced run)
   (``fused_wire=False``), and the seeded cold start at 512 x 512;
   ``k_block=128`` at full view 512 x 512 in all four layouts (each
   kernel launched four times a round); ``link_counters`` on the network
   configuration at 4,096 x 16 under shift and scatter; the three
   tick-level planes on (``sync_interval=8``, ``lhm_max=8``,
   ``dead_suppress_rounds=64``) across a partition of rounds 0-63 at
   4,096 x 16 (shift and scatter) and ``k_block=128`` compact at 512 x
   512, and on the network configuration at 4,096 x 16; the open-world
   plane: the churn storm (below) at 4,096 x 16 with its schedule at that
   size, shift guard and naive arms, scatter guard, ``int16_wire`` and
   compact + ``wire24``, the network configuration with node 3 rejoining
   at round 60, and ``k_block=128`` compact at 512 x 512 with node 3
   rejoining at round 40 and the three planes on; the metadata plane
   (``md_canaries``: full view 512 x 512, two keys, the exchange every 8
   rounds, three pushes, one inside a partition of rounds 0-63): shift in
   the four layouts, scatter on both wires, the open world with node 3
   rejoining at round 40 and pushing again, the network configuration
   (md same-round only) and Lifeguard with a 64-round suppression
   window;
5b. the traced canaries (``traced_canaries``): ``run_traced`` at 4,096 x
    16, 80 rounds, node 3 crashed at round 10 and node 5 leaving at
    round 30, card against CPU with the same CPU-made draws: shift wide,
    ``int16_wire``, compact, compact + ``wire24``, scatter wide, wide
    into a 256-row buffer (it overflows), and the open world with node 3
    rejoining at round 60 (JOINED and LEAVING recorded); the trace
    (lanes, count, dropped, first_suspect, first_removed) card == CPU,
    the card's untraced run (the layout's canary: its kernels once a
    round) equal in state and metrics to the CPU's and to the card's
    traced run, which adds one ``trace_observe`` a round (and no
    ``trace_record``);
5c. the monitor canaries (``monitor_canaries``): ``run_monitored_metered``
    at 512 x 16, the telemetry scenario's sped-up timing, node 3 crashed
    at round 10, 100 rounds, the loss knob at 0.25 and the suspicion
    timeout knob at 10x, a spec promising a pristine network and node
    3's removal by round 10 + ``suspicion_rounds`` + 24: shift wide,
    shift compact + ``wire24`` and scatter wide, card against CPU with the
    same CPU-made draws: state, metrics, the whole monitor and the
    registry equal; FALSE_SUSPICION and COMPLETENESS tripped,
    ``chaos_violations`` the monitor's total; the layout's kernels (two
    more ``carry_decode`` a round under the compact carry, the checks'
    wide decodes) and seven ``trace_record`` a round;
5d. ``bench.py --blame``'s drill at its own size (``drill_path``: N =
    48, the chaos campaign's config, scatter, every member probing every
    round, no ping-req proxies, the SYNC exchange every 8 rounds, seed
    7, one ``loss=1.0`` link rule from victim 3 to observer 11 over rounds
    [32, 192), horizon 288; ``run_composed`` with the trace, the default
    registry and the provenance plane at 2,048 rows), on the card and on
    the CPU with the same CPU-made draws, and with the knob off: the
    port's ``telemetry/query.blame_report`` names observer 11 as origin
    via ``fd_direct``, first-hand; ``channel_mix`` sums to 1.0; no
    provenance or trace drop; ``explain_belief`` over the rows a journal
    gives back resolves with ``fd_direct`` at the onset round; the knob
    off gives the same state and metrics; card == CPU (buffer, trace,
    state, metrics); one ``provenance_observe`` a round;
6. the main path and the layout identity: LAN defaults, N = 1,000,000
   members x K = 16 subjects, loss 0.02, node 3 crashed at round 10, the
   port's own device draws, 600 rounds through ``models.swim.run`` in the
   wide layout and again under ``int16_wire``, ``compact_carry`` and
   ``compact_carry`` + ``wire24``.  Every run must suspect node 3 within
   50 rounds and have >= 99% of live observers hold it DEAD by the end
   (its suspicion timeout is 500 rounds at this size); each narrow run
   must give the wide run's per-round metrics and decoded final state
   exactly.  Each layout prints ms/round, member-rounds/s, kernel
   launches per round (a profiled 10-round window) and peak memory (and
   the bytes already allocated when its run began);
6a. ``bench.py``'s traced window at full width (``traced_window_path``):
    the main path's workload (wide, shift) for 256 rounds through
    ``telemetry/sink.stream_traced_run`` in 4 segments of 64 at 65,536
    rows a segment, ``decode=False``, against the untraced ``run`` of the
    same rounds and draws, each timed twice in turns: final state (every
    lane) and metrics equal; one ``trace_observe`` a round and no
    ``trace_record``; each segment's count + dropped equal to the nonzero
    codes the plain derivation gives over its rounds, and its events and
    the first-round matrices equal to what the reference's codes-in API
    (``trace.record_events``, one ``trace_record`` a round, and
    ``trace.update_first_rounds``) makes of those codes; both ms/round and
    ``traced_overhead_ratio`` (traced ms over untraced), peak bytes, and
    profiled windows from round 256, traced and untraced;
6b. ``bench.py``'s telemetry scenario (``telemetry_path``): 4,096 x 16,
    the sped-up timing, node 3 crashed at round 10,
    ``suspicion_rounds + 80`` rounds in segments of a third: no drop, and
    for node 3 the histogram identity (bucketed + undetected + suspected
    before the crash = N - 1) for detection and removal; the buckets;
6d. (after 6b) ``bench.py --compose``'s full instrumented stack at full
    width (``instrumented_stack_path``): the main path's workload (wide,
    shift) through ``models/compose.run_composed`` (trace at 65,536
    rows, passive monitor, default registry) for 256 rounds: its final
    status, trace lanes and count, monitor and registry (but
    ``chaos_violations``) equal to ``run_traced``'s, ``run_monitored``'s
    and ``run_metered``'s; the monitor green; one merge, one
    ``trace_observe`` and five ``trace_record`` a round; bare ``run``, the
    stack and ``run_metered`` timed in turns, ``full_stack_overhead_ratio``
    and ``metrics_overhead_ratio``; profiled windows from round 256
    (bare, the stack, the monitor alone, the metrics alone: device busy
    ms, launches, the ``metrics.observe``, ``monitor.check`` and
    ``monitor.record`` phases); ``metrics.stream_metered_run`` through a
    ``TelemetrySink`` in four windows, read back with
    ``sink.read_records``, summing to the single metered run;
6e. (after 6d) the provenance plane at full width
    (``provenance_crash_path``): the same workload through
    ``run_composed`` with the trace, the default registry and the
    provenance plane, both buffers at 4,194,304 rows, 600 rounds (node
    3's SUSPECTED and REMOVED waves), and with the knob off: no drop; the
    channel counts summing to the count, the trace's count plus the self
    refutations; every row of the earliest round with a SUSPECTED row
    about node 3 first-hand; most of node 3's rows via gossip or SYNC;
    the knob off giving the same state, stacked metrics, trace and
    registry; one ``provenance_observe`` a round; armed and unarmed timed
    in turns (``provenance_overhead_ratio``, reported only) and profiled
    20-round windows of both over the SUSPECTED wave (from round 10) and a
    quiet stretch (from round 200), with the ``provenance.observe`` phase;
6c. the churn storm at full width, the open-world plane's path: the
    reference's ``chaos.churn_growth_scenario`` geometry (``bench.py
    --churn``'s workload) at N = 1,000,000 x K = 16 focal subjects at
    ``arange(16) * 62,500``, the chaos campaign's config, shift, wide,
    its pools drawn from the subjects: 3 waves of 2 victims 16 rounds
    apart, each scared by 6 rounds of inbound loss 1.0 ending 14 rounds
    before its crash, 3 new identities a wave 10 rounds after its
    crashes, into 3 pre-dead arrival slots first; a horizon of the last
    join + ``completeness_bound`` (284) + 24, rounded up to 64; the
    port's own draws, through ``chaos/monitor.run_monitored`` with the
    join codes checked every round (``storm_spec``), as ``bench.py
    --churn`` runs it.  The guard arm, then under
    ``int16_wire`` and compact + ``wire24`` (each equal to the wide run's
    per-round metrics, decoded final state and codes), the naive arm
    (``epoch_guard=False``) on the same world and draws, and the guard
    arm under scatter delivery.  Gates: each guard arm's
    ``NO_RESURRECTION`` and ``JOIN_COMPLETENESS`` 0 and every eligible
    observer holding every joined slot ALIVE at epoch 1 at the end; the
    naive arm's joined rows burn incarnations (each above 0, the guard's
    0) and refute more than the guard's.  Prints the codes, the joined
    rows' incarnations, refutations, ms/round, peak bytes, and a
    profiled window after the storm and of the last join round.  Then
    ``bench.py --churn``'s own A/B at its size (N = 48, full view,
    seeds 3-5) through ``run_monitored``, on the card and on the CPU
    (card == CPU, the whole monitor): guard 0, naive ``NO_RESURRECTION``
    above 0;
7. the network path at full width: the network configuration at N =
   1,000,000 x K = 16 for 600 rounds (node 3 crashed at round 10, a
   brownout from ids [0, 100,000) to the rest over rounds 100-260 at up
   to 0.5 loss and 400 ms mean delay, node 5 blocked both ways over
   rounds 300-350, four user gossips spread at round 20), the port's own
   draws, wide and ``int16_wire``.  Each must suspect node 3 within 50
   rounds and have >= 99% of live observers hold it DEAD at the end,
   sum over 10x more SUSPECT entries about live subjects in rounds
   100-260 than in rounds 20-100 and at least BROWNOUT_FLOOR_SHARE of
   the browned-out senders' count for each live subject and round of
   the window (``brownout_floor``), have no live subject held DEAD by 1%
   or more of live observers at the end, and bring every user gossip to
   >= 99% of live members; the int16 wire must give the wide run's
   metrics and decoded state (rings unpacked) exactly; a run to round
   160 (the brownout's peak) must hold delayed messages in its ring.
   Each prints ms/round, member-rounds/s, peak memory, and launches per
   round from 10 rounds profiled from round 160 (device busy time and
   idle share, device time and launches per phase range, the ring's
   bytes);
8. the planes at full width: (a) the partition heal of ``bench.py
   --sync``'s scale arm (``bench.py:1625-1690``: the chaos campaign's
   config, N = 1,000,000, K = 16 subjects at ``arange(16) * 62,500``,
   shift, ``sync_every=0``, ``sync_interval=32``, seed 7; a half/half
   split of 320 rounds, then a 204-round window probed every 2 rounds):
   the split must leave divergent columns, the tables must agree inside
   the window, and the gossip-only control (``sync_interval=0``, 524
   rounds) must not; prints ``sync_rounds_to_converge``, ms/round,
   member-rounds/s, a profiled 10-round window and peak bytes; (b) the
   network configuration at 1M x 16, wide, 600 rounds, with
   ``lhm_max=8`` and ``dead_suppress_rounds = periods_to_spread + 2``:
   through ``run_monitored`` (passive spec), at every segment's end each
   live row's multiplier in [1, 8] and the monitor's TIMER_BOUND count 0
   (no timer past round + ``suspicion_rounds * 8``, checked every round),
   node 3 suspected within 50 rounds; prints its numbers (ms/round with
   the monitor) beside phase 7's wide run;
8c. the staged config rollout at full view N = K = 8,192 (cut for the
    time limit from the reference's unblocked ceiling, 16,384), the
    metadata plane's path (``rollout_path``): ``bench.py --rollout``'s scenario
    built by the port's DSL (``rollout_scenario``, ``rollout_world``:
    ``ChurnStorm``, ``RollingPartition``, ``StagedRollout`` through
    ``chaos.Scenario.build``, its eight match-nothing link rules
    included, so the FD chains run per hop as in the reference; the chaos
    campaign's config, shift, ``sync_every=0``, one key, the exchange
    every 8 rounds, seed 11; a revive storm of 4 nodes, a half/half split
    over rounds [240, 480), 3 stages of 4 owners pushing at rounds 360,
    472 and 584; horizon 768), the port's own draws.  The gated arm runs
    in segments of 2 rounds, reading the open pushes' owner columns on
    the device after each: every push must converge inside ``max(push,
    heal) + 112`` and the divergence probe read 0 at the horizon; a
    profiled 10-round window from round 360.  The gossip-only control
    (``sync_interval=0``) must still diverge at round 768.  Prints the
    p99, the control's
    count, each arm's ms/round, member-rounds/s, peak bytes and bytes
    per cell, and the window's device time per phase range
    (``swim.metadata`` among them).  Then ``bench_rollout_path``: the
    same rollout at the bench's N = 48, its three arms (the monitored
    composite through ``run_monitored`` with the scenario's spec, gated
    green; the gated arm; the control), on the card and on the CPU with
    the same CPU-made draws (card == CPU), its p99 and control count
    beside the reference's committed ones;
8d. (run last, after phase 13, when its CPU halves are done) the
    gossip-only simulator (``gossip_path``, ``models/gossip.py``) at
    N = 1,000,000 x G = 16 gossips, LAN defaults, 122 rounds
    (``gossip_periods_to_sweep(3, N)``), a lossy arm (loss 0.02) and a
    delayed arm (the same loss, a mean delay of one gossip interval, a
    4-slot ring): each card == CPU (every lane and metric) on CPU-made
    draws, then on the card's own draws; every gossip fully disseminated,
    each gossip's summed sends within ``max_messages_per_gossip_total``,
    the delayed arm's mean dissemination round no earlier than the lossy
    arm's; ms/round, a profiled window, peak bytes;
8e. ``bench.py --chaos`` at its defaults (``chaos_campaign_path``):
    ``generate_campaign(seed=100, n_scenarios=21, n=32)`` through
    ``chaos.run_campaign`` (shift, CPU-made draws, the journal through a
    ``TelemetrySink`` read back): each verdict row card == CPU, every
    scenario green but the stream effects named in ``CHAOS_STREAM_REDS``,
    each with its one code, subject and round;
8f. the fuzz coverage arm, serial (``fuzz_path``): the first campaign
    scenario of two ops or more that promises completeness, under
    ``weakened_knobs``: red with COMPLETENESS on the card and the CPU
    alike; ``minimize`` keeps every code; its ``repro()`` line, evaluated
    under the port's ``chaos``, reproduces the verdict;
8g. ``bench.py --lifeguard`` at its defaults (``lifeguard_path``): 3
    scenarios of ``asymmetric_degradation(11 + i, n=48)``, scatter,
    ``ping_known_only=False``, ``lhm_max`` 0 against 8, the degraded
    rack crashed at round 120, through ``run_metered``, card == CPU:
    ``fp_ratio`` <= 0.5 and the detection p99 delta <= +1 round;
8h. the DSL at scale (``dsl_scale_path``): ``generate_scenario(seed=100,
    n=4096, severity="severe")`` at full view 4,096 x 4,096 through
    ``run_monitored`` on the card: whole and one round at a time equal,
    the monitor's recorded + dropped rows equal to the cells of each
    code's first violating round; verdict, ms/round, busy, launches and
    bytes per cell printed (green not gated);
9. the seeded cold start at full view N = K = 4,096 (LAN defaults, loss
   0, seeds 0, 1, 2) for 12 x periods_to_spread rounds: every cell must
   be ALIVE at the end; prints the round membership became full;
10. the scatter main path (``delivery="scatter"``, the reference's
    default): phase 6's workload through ``models.swim.run`` for 600
    rounds, wide and then ``int16_wire``, under the same gates and the
    same identity check, printing phase 6's numbers and the shift
    path's first SUSPECT round and final DEAD share beside its own;
11. phase 9 under scatter delivery;
12. blocked == unblocked on the card: the capacity configuration below
    at N = K = 8,192 for 60 rounds, wide and compact, with
    ``k_block=1024`` and without; every state lane and metric equal;
    each run's peak bytes and bytes per cell; then compact again with
    the three planes on (the exchange every 8 rounds);
13. the full-view capacity path: the reference's configuration
    (``experiments/fullview_ceiling.py:88-94``: LAN defaults, N = K =
    36,864, compact carry, ``k_block=1024``, suspicion 6 rounds, ping
    every 2, SYNC every 4, aggregate metrics, loss 0, node 3 crashed at
    round 2) for 48 rounds (cut for the time limit from the reference's
    120): the wire16 merge, decode and encode each launched 36 times a
    round; at the end >= 99% of live observers hold
    node 3 DEAD; no false positive in any round; peak allocation <= 18
    B/cell (two carries and one block's transients); node 0's
    ``node_snapshot`` lists node 3 DEAD and equals the snapshot of its row
    made on the CPU.  Prints ms/round, record-updates/s (N^2 x rounds /
    s), peak bytes and bytes per cell, and a profiled 5-round window;
14. one ``{"kernels": [...]}`` line (the block-form times and bounds as
    ``block_*`` fields of their kernels' rows, the plane-on ones as
    ``planes_*`` / ``block_planes_*``, each trace kernel's dense round as
    ``dense_*``), then ``{"ok": true, "device": ...}``.

No phase catches its own failure, and nothing falls back to the CPU or
to a plain version.  Run from the repository root: ``python3
chip_smoke.py``.  ``--merge-baseline PATH`` adds :func:`merge_ab`, the
plane-off merge timed in turns against an earlier ``merge_timers.cu``.
"""

import argparse
import collections
import concurrent.futures
import ctypes
import dataclasses
import functools
import io
import json
import multiprocessing
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from scalecube_cluster_tpu_torch import mosaic_probe, profile_round, records
from scalecube_cluster_tpu_torch import swim_math
from scalecube_cluster_tpu_torch.chaos import campaign, monitor, scenarios
from scalecube_cluster_tpu_torch.config import ClusterConfig
from scalecube_cluster_tpu_torch.kernels import LAUNCHES, _build
from scalecube_cluster_tpu_torch.kernels import carry, merge, probes
from scalecube_cluster_tpu_torch.kernels import provenance as kprov
from scalecube_cluster_tpu_torch.kernels import trace as trace_kernel
from scalecube_cluster_tpu_torch.models import compose, gossip, lifeguard
from scalecube_cluster_tpu_torch.models import metadata
from scalecube_cluster_tpu_torch.models import provenance, swim
from scalecube_cluster_tpu_torch.models import sync as sync_plane
from scalecube_cluster_tpu_torch.ops import delivery, prng
from scalecube_cluster_tpu_torch.telemetry import metrics, query, sink
from scalecube_cluster_tpu_torch.telemetry import trace as ttrace
from scalecube_cluster_tpu_torch.telemetry.events import TraceEventType

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the float32
# non-tensor rate, an upper limit on 32-bit integer issue (so the
# operation bound below stays a lower bound).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# 32-bit operations per cell of each kernel (index arithmetic, loads and
# stores, and the function's own integer work), read off the sources.
OPS_PER_CELL = {"merge": 60, "carry_decode": 10, "carry_encode": 20,
                "probe_load16": 6, "probe_store16": 6, "probe_cmp16": 7,
                "probe_load8": 6, "probe_merge_core": 25, "trace_record": 8,
                "trace_observe": 12, "provenance_observe": 12}

MAIN_N, MAIN_K, MAIN_ROUNDS, CRASHED, CRASH_AT = 1_000_000, 16, 600, 3, 10
# The full-view capacity configuration (experiments/fullview_ceiling.py:
# 88-94): N = K, k_block column blocks, node 3 crashed at round 2; 48
# rounds, cut for the time limit from the reference's 60-round first
# window plus its 60 timed rounds (every live observer holds node 3 DEAD
# from round 16 on the card).
FULL_N, FULL_KB, FULL_ROUNDS, FULL_CRASH_AT = 36_864, 1_024, 48, 2
FULL_LAYOUT = "compact"
# A round's peak allocation may hold two compact carries (the input and
# the output) and the [N, Kb] transients of one block.
MAX_BYTES_PER_CELL = 18
# Blocked against unblocked on the card, at a size both fit.
PAIR_N, PAIR_ROUNDS = 8_192, 60
PROFILE_FULL_ROUNDS = 5
# The block-form kernel checks: a [FULL_N, BLOCK_CARRY_K] carry (the real
# row count, 1-4 KB row segments), blocks of FULL_KB columns at these
# offsets, timed at TIMED_COL0.
BLOCK_CARRY_K = 4_096
BLOCK_COLS = (0, 1_024, 3_072)
TIMED_COL0 = 1_024
CANARY_ROUNDS = 80
# The planes' canaries: the anti-entropy exchange every 8 rounds,
# multipliers up to 8, a 64-round suppression window, across a partition
# of rounds 0-63.
CANARY_PLANES = dict(sync_interval=8, lhm_max=8, dead_suppress_rounds=64)
CANARY_SPLIT = 64
# The partition heal at full width, bench.py --sync's scale arm
# (bench.py:1625-1690): the chaos campaign's config, N = 1M, 16 focal
# subjects at arange(16) * (N // 16), shift delivery, no per-round SYNC,
# the exchange every 32 rounds, seed 7.  The reference's
# quiesced_heal_scenario at this size (computed on the CPU): a half/half
# split of 320 rounds (RollingPartition: split, healed, healed phases of
# 320 rounds), horizon 844, so a post-heal window of 204 rounds, probed
# every 2.
HEAL_N, HEAL_K, HEAL_SEED, HEAL_SYNC_INTERVAL = 1_000_000, 16, 7, 32
HEAL_SPLIT, HEAL_HORIZON, HEAL_PROBE_STEP = 320, 844, 2
HEAL_WINDOW = HEAL_HORIZON - 2 * HEAL_SPLIT
# The Lifeguard network run's checkpoints (rounds), and the round its
# profiled window starts from (the plane-off network path's).
LIFEGUARD_SEGMENTS = (0, 50, 100, 160, 200, 260, 300, 400, 500, 600)
SEEDS = [0, 1, 2]
COLD_N = 4096
PROFILE_ROUNDS = 10
INT32_MAX = 2**31 - 1
INT32_MIN = -2**31
# The brownout's floor: each live subject held SUSPECT, on average over
# the window's rounds, by at least this share of the browned-out
# senders' count (rounds 100-260 at 1M x 16: 0.1 x 100,000 x 160 rounds
# x 15 live subjects = 24,000,000 entries, against 503,110,620 measured
# on the H100).
BROWNOUT_FLOOR_SHARE = 0.1
LAYOUTS = profile_round.LAYOUTS
# Our kernels each layout's round launches, once a round.
ROUND_KERNELS = {
    "wide": (merge.NAMES["wide"],),
    "int16_wire": (merge.NAMES["wire16"],),
    "compact": (merge.NAMES["wire16"], carry.DECODE, carry.ENCODE),
    "compact_wire24": (merge.NAMES["wire24"], carry.DECODE, carry.ENCODE),
}
CSRC = "scalecube_cluster_tpu_torch/csrc/"
# The merge kernel's plane branches in phase 3: multipliers in [1, 8], a
# 64-round suppression window, and deadlines (relative to the round; None
# = no timer) with expiries at the round and one round either side.
PLANE_LHM_MAX, PLANE_SUPPRESS = 8, 64
PLANE_DEADLINES = (None, None, -1, 0, 1, -3, 4, -37)
# The churn storm (the reference's chaos.churn_growth_scenario geometry,
# chaos/scenarios.py:996-1100, its pools drawn from the K focal
# subjects): 3 waves of 2 victims 16 rounds apart, each scared by an
# inbound blockade of 6 rounds; 3 new identities a wave, 10 rounds after
# its crashes, into 3 pre-dead arrival slots first; the monitor's join
# codes every 16 rounds from the first join and after the last round.
STORM_SEED, STORM_WAVES, STORM_WAVE_SIZE, STORM_JOINS = 3, 3, 2, 3
STORM_JOIN_LAG, STORM_SCARE = 10, 6
STORM_HORIZON_QUANTUM = 64
# The monitor's trace_record launches a storm round: INC_REGRESSION,
# TIMER_BOUND, WIRE_SATURATION, the two join codes and the two self lanes.
STORM_RECORDS = 7
JOIN_CODES = (monitor.InvariantCode.NO_RESURRECTION,
              monitor.InvariantCode.JOIN_COMPLETENESS)
# The network configuration's canary with a join: node 3 (crashed at
# round 10) rejoins at this round.
NETWORK_JOIN_AT = 60
# The metadata canaries (full view 512 x 512): two keys, the exchange
# every 8 rounds; pushes (node, key, value, round): node 3 before its
# crash at round 10, node 300 inside the partition of rounds 0-63, node 7
# after the heal; under the open world node 3 rejoins at round 40 and
# pushes again as the new identity.
MD_CANARY = dict(metadata_keys=2, sync_interval=8)
MD_PUSHES = ((3, 0, 641, 5), (300, 1, 77, 20), (7, 0, 9, 70))
MD_JOIN_AT, MD_JOIN_PUSH = 40, (3, 1, 1023, 50)
# The staged config rollout (bench.py --rollout, bench.py:1753-2040): the
# chaos campaign's config, full view, shift, sync_every=0, one key, the
# exchange every 8 rounds, seed 11; 3 stages of 4 owners pushing 641; a
# revive churn storm of 4 nodes (waves of 2 from round 8, every 24
# rounds, each down quiesce_bound rounds); a half/half split over
# [phase, 2 phase).  At N = 8,192: quiesce_bound 233 (245 at 16,384),
# phase 240, metadata_convergence_bound 112, stages at rounds 360, 472 and
# 584, horizon 768; at the bench's own N = 48: 137, 144, 64, rounds 216,
# 280 and 344, horizon 448.  The pushes are polled every 2 rounds.
# Full view at 8,192 x 8,192 on the card (cut for the time limit from the
# reference's unblocked ceiling, 16,384).
ROLLOUT_N, ROLLOUT_BENCH_N, ROLLOUT_SEED = 8_192, 48, 11
ROLLOUT_SYNC_INTERVAL, ROLLOUT_STAGES, ROLLOUT_STAGE_SIZE = 8, 3, 4
ROLLOUT_VALUE, ROLLOUT_PROBE_STEP = 641, 2
ROLLOUT_STORM, ROLLOUT_WAVE, ROLLOUT_STORM_START, ROLLOUT_WAVE_EVERY = (
    4, 2, 8, 24)
# The reference's committed rollout at N = 48 (README, "Metadata KV &
# config rollout"): p99 and the control's divergent cells.
ROLLOUT_REFERENCE_P99, ROLLOUT_REFERENCE_CONTROL = 4, 96
# The event record's kernel cases at 1M x 16 (label, event density, rows
# already recorded, capacity; None = one row a cell), the densities it is
# timed at, and the round its rows carry.
TRACE_CAPACITY = 65_536
TRACE_RECORD_CASES = (("dense", 0.9, 0, None),
                      ("sparse", 1e-3, 0, TRACE_CAPACITY),
                      ("overflow", 1e-2, 1_000, TRACE_CAPACITY),
                      ("one below capacity", 1e-3, TRACE_CAPACITY - 1,
                       TRACE_CAPACITY),
                      ("at capacity", 1e-3, TRACE_CAPACITY, TRACE_CAPACITY))
TRACE_SPARSE_DENSITY, TRACE_DENSE_DENSITY = 1e-3, 0.9
TRACE_RECORD_ROUND = 37
# The fused observe's cases at 1M x 16 (label, density of changed cells,
# rows already recorded, capacity, incarnation dtype, epoch dtype or
# None, observer offset).
TRACE_OBSERVE_OFFSET = 123_457
TRACE_OBSERVE_CASES = (
    ("wide", 1e-2, 0, None, torch.int32, None, 0),
    ("int32 epoch", 1e-2, 0, None, torch.int32, torch.int32, 0),
    ("compact int16 epoch", 1e-2, 0, None, torch.int16, torch.int16, 0),
    ("leave rows, offset", 1e-2, 0, None, torch.int32, None,
     TRACE_OBSERVE_OFFSET),
    ("dense", 0.9, 0, None, torch.int32, None, 0),
    ("sparse", 1e-3, 0, TRACE_CAPACITY, torch.int32, None, 0),
    ("overflow", 1e-2, 1_000, TRACE_CAPACITY, torch.int32, None, 0),
    ("one below capacity", 1e-3, TRACE_CAPACITY - 1, TRACE_CAPACITY,
     torch.int32, None, 0),
    ("at capacity", 1e-3, TRACE_CAPACITY, TRACE_CAPACITY, torch.int32, None,
     0))
# The traced canaries: node 5 leaves at round 30; the overflowing one's
# capacity.  bench.py's traced window (bench.py:475-540): 256 rounds in 4
# segments at traced_window_policy's capacity (65,536 at 1M); its
# telemetry scenario (bench.py:327-328, :666-720).
TRACE_LEAVER, TRACE_LEAVE_AT, TRACE_CANARY_SMALL_CAPACITY = 5, 30, 256
TRACE_ROUNDS, TRACE_SEGMENTS = 256, 4
# The monitor's record cases at 1M x 16 (label, density of violating cells
# a code, density of each self lane, rows already recorded, codes no
# longer fresh), into the monitor's default 4,096 rows.
MONITOR_CAPACITY = monitor.DEFAULT_CAPACITY
MONITOR_RECORD_CASES = (
    ("every code", 2e-5, 2e-4, 0, ()),
    ("self lanes", 0.0, 1e-3, 0, ()),
    ("not fresh", 2e-5, 2e-4, 0, (1, 2, 3)),
    ("overflow", 1e-4, 2e-4, 0, ()),
    ("one below capacity", 2e-5, 2e-4, MONITOR_CAPACITY - 1, ()),
    ("at capacity", 2e-5, 2e-4, MONITOR_CAPACITY, ()))
MONITOR_CANARY_N, MONITOR_CANARY_ROUNDS = 512, 100
# The instrumented stack's timed window (bench.py --metrics windows at a
# quarter of its rounds; 256 keeps every int32 counter far from wrapping).
STACK_ROUNDS, STACK_PROFILE_ROUNDS = 256, 20
TELEMETRY_N, TELEMETRY_CRASH_AT = 4_096, 10
# The provenance round's kernel cases at 1M x 16 (label, density of
# changed cells, rows already recorded, capacity, key dtype, epoch dtype
# or None, observer offset, ping-req split, join-rebirth columns, the
# channels it must record).
_EVERY_CHANNEL = ("fd_direct", "pingreq_proxy", "gossip", "sync",
                  "self_refutation")
PROVENANCE_OBSERVE_CASES = (
    ("wide int32 keys", 1e-2, 0, None, torch.int32, None, 0, True, False,
     _EVERY_CHANNEL),
    ("int16_wire keys", 1e-2, 0, None, torch.int16, None, 0, True, False,
     _EVERY_CHANNEL),
    ("int32 epoch, joins", 1e-2, 0, None, torch.int32, torch.int32, 0, True,
     True, _EVERY_CHANNEL + ("join_rebirth",)),
    ("compact int16 epoch, joins", 1e-2, 0, None, torch.int16, torch.int16,
     0, True, True, _EVERY_CHANNEL + ("join_rebirth",)),
    ("no ping-req members", 1e-2, 0, None, torch.int32, None, 0, False,
     False, ("fd_direct", "gossip", "sync", "self_refutation")),
    ("self refutations, offset", 1e-2, 0, None, torch.int32, None,
     TRACE_OBSERVE_OFFSET, True, False, _EVERY_CHANNEL),
    ("dense", 0.9, 0, None, torch.int32, None, 0, True, False,
     _EVERY_CHANNEL),
    ("sparse", 1e-3, 0, TRACE_CAPACITY, torch.int32, None, 0, True, False,
     ("gossip",)),
    ("overflow", 1e-2, 1_000, TRACE_CAPACITY, torch.int32, None, 0, True,
     False, ("gossip",)),
    ("one below capacity", 1e-3, TRACE_CAPACITY - 1, TRACE_CAPACITY,
     torch.int32, None, 0, True, False, ()),
    ("at capacity", 1e-3, TRACE_CAPACITY, TRACE_CAPACITY, torch.int32, None,
     0, True, False, ()))
# bench.py --blame's drill (bench.py:2486-2540, chaos/scenarios.py:942):
# N, seed, victim, observer, onset, pulse, horizon (onset + pulse + 96),
# provenance capacity.
DRILL_N, DRILL_SEED, DRILL_VICTIM, DRILL_OBSERVER = 48, 7, 3, 11
DRILL_ONSET, DRILL_PULSE, DRILL_HORIZON, DRILL_CAPACITY = 32, 160, 288, 2048
# The 1M x 16 attributed crash: both buffers' rows (node 3's SUSPECTED and
# REMOVED waves, about 2M rows, fit), the window, the quiet stretch's
# start, the profiled windows' rounds.
PROV_CRASH_CAPACITY, PROV_CRASH_ROUNDS = 4_194_304, 600
PROV_QUIET_AT, PROV_PROFILE_ROUNDS = 200, 20
# The gossip-only simulator at its docstring's scale (models/gossip.py):
# N members, G gossips, LAN defaults, the bench's loss; the delayed arm's
# ring depth; its seed.
GOSSIP_N, GOSSIP_G, GOSSIP_LOSS = 1_000_000, 16, 0.02
GOSSIP_DELAY_ROUNDS, GOSSIP_SEED = 3, 0
GOSSIP_LANES = ("infected", "spread_until", "ring")
# bench.py --chaos at its defaults (bench.py:835-880): seed, scenarios, N.
CHAOS_SEED, CHAOS_SCENARIOS, CHAOS_N = 100, 21, 32
# The campaign's red scenarios on the port's own draws (the CPU-made
# stream), each with the one code, subject and round of all its evidence:
# moderate-110's graceful leaver 25 still SUSPECT in six live tables at
# its completeness deadline, round 154.  A stream effect of the
# scenario's bound, not a port fault: on the reference's draws the port
# equals the reference's verdict (green), and the reference's own runs of
# the scenario are red with the same code, subject and round on 4 of 40
# keys (python -m tests.torch_chaos_reference).  Any other red fails.
CHAOS_STREAM_REDS = {
    "moderate-110-leave+churn+churn_arrivals": ("COMPLETENESS", 25, 154)}
# bench.py --lifeguard at its defaults (bench.py:2108-2135): N, first
# seed, scenarios, the plane's lhm_max, the degraded rack's crash round;
# the reference's committed CPU run (artifacts/lifeguard_fp.json):
# fp_ratio and the detection p99 delta.
LIFEGUARD_N, LIFEGUARD_SEED, LIFEGUARD_SCENARIOS = 48, 11, 3
LIFEGUARD_LHM, LIFEGUARD_CRASH_AT = 8, 120
LIFEGUARD_REFERENCE = (0.324763, -0.17)
# The DSL at scale: generate_scenario(seed, n, "severe") at full view.
DSL_SEED, DSL_N = 100, 4_096
# The CPU halves of the card-vs-CPU runs run in this many worker
# processes while the card works.
CPU_WORKERS = 6


_T0 = time.perf_counter()


def log(msg):
    """Print ``msg``; a tagged line (``[...]``) ends with the seconds
    since the script started."""
    if msg.startswith("["):
        msg = f"{msg} (at {time.perf_counter() - _T0:.1f} s)"
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def stage(label, t_start):
    """Log the seconds since ``t_start`` as ``label`` ends, and the card's
    clocks, temperature and power draw."""
    log(f"[stage] {label} done at {time.perf_counter() - t_start:.1f} s")
    log(clock_line())


def clock_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,"
         "power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return ("[card] clocks.sm, clocks.mem, temperature.gpu, power.draw: "
            + out.stdout.strip().splitlines()[0])


def time_ms(fn, samples=10, inner=10, warmup=3):
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


# Calls of device_ms whose traces all missed, timed with CUDA events.
EVENT_CLOCK_FALLBACKS = []


def device_ms(fn, calls=20, warmup=3, traces=5, pause_s=0.5):
    """Mean device milliseconds per call of ``fn()``: the summed time of
    the CUDA kernels (and copies) it runs, from a ``torch.profiler``
    trace of ``calls`` calls, without the host's time between them.  A
    trace that recorded no device activity at all (the tracer now and
    then misses a whole window, several in a row while the host's cores
    are busy) is taken again after ``pause_s``, up to ``traces`` times;
    if every trace misses, the calls are timed with CUDA events
    (:func:`time_ms`) instead, logged and listed in
    ``EVENT_CLOCK_FALLBACKS``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(traces):
        if attempt:
            time.sleep(pause_s)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / calls / 1e3
    ms = time_ms(fn)
    name = getattr(fn, "__qualname__", repr(fn))
    EVENT_CLOCK_FALLBACKS.append(name)
    log(f"[clock] the profiler saw no device time in {traces} traces of "
        f"{name}; {ms:.4f} ms on CUDA events instead")
    return ms


@functools.lru_cache(maxsize=None)
def int32_operand(value, device):
    """``value`` as an int32 tensor of shape (1,), made once a device: a
    dimensioned operand takes part in type promotion (a Python number or
    a 0-dim tensor would not), so an int8 or int16 plane's arithmetic
    with it runs in int32 and cannot wrap."""
    return torch.full((1,), value, dtype=torch.int32, device=device)


def library_load16(x):
    """One PyTorch call for ``probe_load16``: ``x + 1`` in int32."""
    return torch.add(x, int32_operand(1, x.device))


def library_load8(x):
    """One PyTorch call for ``probe_load8``: ``x * 2`` in int32."""
    return torch.mul(x, int32_operand(2, x.device))


def library_store16(x):
    """One PyTorch call for ``probe_store16``: the add runs in int32 and
    narrows to int16 on the store."""
    return torch.add(x, 1, out=torch.empty(x.shape, dtype=torch.int16,
                                           device=x.device))


def library_cmp16(x, y):
    """One PyTorch call for ``probe_cmp16``: ``x > y`` stored as int32."""
    return torch.gt(x, y, out=torch.empty(x.shape, dtype=torch.int32,
                                          device=x.device))


def widen_copy(x):
    """One PyTorch call that moves a widening probe's bytes (its input
    read, an int32 plane written) without its ``+ 1`` or ``* 2``."""
    return x.to(torch.int32)


# The probes one PyTorch call computes (the merge core takes a dozen).
PROBE_LIBRARY = {"probe_load16": library_load16,
                 "probe_store16": library_store16,
                 "probe_cmp16": library_cmp16,
                 "probe_load8": library_load8}
# The widening probes, timed beside the copy that moves their bytes.
PROBE_COPY = ("probe_load16", "probe_load8")
RAGGED_SHAPES = ((999_999, 13), (3, 5))


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


def merge_planes(n, k, seed, device, fmt, cap, round_idx=37,
                 deadlines=None):
    """Seeded merge inputs reaching every branch: ABSENT and DEAD entries,
    the ABSENT opener with and without ALIVE arrivals, self cells
    overridden and not, frozen rows, timers pending/firing/none, and
    incarnations at ``cap``.  ``status``/``inc`` are pinned; the inbox is
    packed in ``fmt`` (its dtype).  ``deadlines``: the deadline lane's
    values relative to the round (None: the plane-off set; the planes'
    set adds expiries one round either side of it)."""
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
    if deadlines is None:
        deadlines = (None, None, -3, 0, 4, -round_idx)
    deadline = choice([INT32_MAX if d is None else round_idx + d
                       for d in deadlines], (n, k)).to(torch.int32)
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


def plane_arguments(planes, params, seed, device):
    """The merge's plane arguments on seeded planes: ``armed_rounds`` of
    multipliers drawn in [1, PLANE_LHM_MAX] at the planes' live count,
    and the suppression window ``PLANE_SUPPRESS``."""
    g = torch.Generator(device=device).manual_seed(seed)
    n = planes["status"].shape[0]
    lhm = torch.randint(1, PLANE_LHM_MAX + 1, (n,), generator=g,
                        device=device, dtype=torch.int32)
    armed = lifeguard.suspicion_deadline_rounds(
        params.suspicion_rounds, lhm,
        planes["alive_here"].sum(dtype=torch.int32), n)
    return dict(armed_rounds=armed, dead_suppress_rounds=PLANE_SUPPRESS)


def check_plane_cases(name, planes, got, round_idx=37):
    """Raise unless the plane-on merge met suppressed tombstones that
    held against an ALIVE arrival, opened suppression windows, and armed
    timers of more than one length; returns the three counts."""
    status, deadline = planes["status"], planes["suspect_deadline"]
    live = planes["alive_here"][:, None]
    suppressed = (live & (status == records.DEAD)
                  & (deadline != INT32_MAX) & (round_idx < deadline))
    alive_in = planes["inbox_alive"] & (planes["inbox"] >= 0)
    held = int((suppressed & alive_in & (got[0] == records.DEAD)).sum())
    opened = int((live & (status != records.DEAD) & (got[0] == records.DEAD)
                  & (got[3] == round_idx + PLANE_SUPPRESS)).sum())
    armed = got[3][live & (got[0] == records.SUSPECT)
                   & (deadline == INT32_MAX) & (got[3] != INT32_MAX)]
    lengths = torch.unique(armed - round_idx).numel()
    if not (held and opened and lengths > 1):
        raise AssertionError(f"{name}: plane-on planes missed a case (held "
                             f"{held}, opened {opened}, armed lengths "
                             f"{lengths})")
    return held, opened, lengths


def epoch_inputs(planes, fmt, cap, seed, device):
    """The epoch form's inputs on seeded ``merge_planes``: a raw epoch
    lane and each row's own epoch in [0, 2] (clipped to the field), and
    the inbox re-packed with epochs at, one below and one above the
    entry's (pinned) epoch, some winners at the cap.  Returns the new
    inbox and the kernel's ``epoch`` / ``own_epoch`` arguments."""
    g = torch.Generator(device=device).manual_seed(seed)
    n, k = planes["status"].shape
    top = min(2, fmt.epoch_cap())

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=device)

    epoch = randint(0, top + 1, (n, k)).to(torch.int32)
    own = randint(0, top + 1, (n,)).to(torch.int32)
    is_self = (torch.arange(k, device=device)[None, :]
               == planes["slot_of_node"][:, None])
    pinned = torch.where(is_self, own[:, None], epoch)
    win_ep = torch.clamp(pinned + randint(-1, 2, (n, k)), 0, fmt.epoch_cap())
    win_status, win_inc = delivery.unpack_record(planes["inbox"], fmt=fmt)
    win_status = torch.where(planes["inbox"] < 0,
                             randint(0, 3, (n, k)).to(torch.int8), win_status)
    win_inc = torch.where(randint(0, 10, (n, k)) == 0, cap,
                          torch.clamp(win_inc, max=cap))
    inbox = delivery.pack_record(win_status, win_inc, fmt=fmt, epoch=win_ep,
                                 epoch_bits=fmt.epoch_bits)
    inbox = torch.where(randint(0, 100, (n, k)) < 15, -1, inbox)
    return inbox, dict(epoch=epoch, own_epoch=own)


def check_epoch_cases(name, planes, extra, got, fmt, cap, plane_on,
                      round_idx=37):
    """Raise unless the epoch-form planes reached every case (a lower-
    epoch winner, higher-epoch ALIVE, SUSPECT and DEAD winners, equal
    epochs at the epoch-reduced incarnation cap, a self cell with a
    winner of another epoch, frozen rows, an epoch change alone, and with
    the planes on a higher-epoch ALIVE over a suppressed tombstone) and
    each went as the gate says; returns the cases' counts."""
    eb = fmt.epoch_bits
    key, status = planes["inbox"], planes["status"]
    live = planes["alive_here"][:, None]
    is_self = (torch.arange(status.shape[1], device=status.device)[None, :]
               == planes["slot_of_node"][:, None])
    own = extra["own_epoch"][:, None]
    entry_ep = torch.where(is_self, own, extra["epoch"])
    win_status, win_inc = delivery.unpack_record(key, fmt=fmt, epoch_bits=eb)
    win_ep = delivery.unpack_epoch(key, fmt=fmt, epoch_bits=eb)
    other = live & ~is_self & (key >= 0)
    new_status, new_inc, new_ep = got[0], got[1], got[6]
    higher = other & (win_ep > entry_ep)
    cases = dict(
        lower=other & (win_ep < entry_ep),
        higher_alive=higher & (win_status == records.ALIVE),
        higher_suspect=higher & (win_status == records.SUSPECT),
        higher_dead=higher & (win_status == records.DEAD),
        at_cap=other & (win_ep == entry_ep) & (win_inc == cap),
        self_other_epoch=live & is_self & (key >= 0) & (win_ep != own)
        & records.is_overrides_array(win_status, win_inc, records.ALIVE,
                                     planes["self_inc"][:, None]),
        frozen=~live.expand_as(status),
        epoch_only=other & (new_status == status) & (new_inc == planes["inc"])
        & (new_ep != entry_ep))
    if plane_on:
        suppressed = ((status == records.DEAD)
                      & (planes["suspect_deadline"] != INT32_MAX)
                      & (round_idx < planes["suspect_deadline"]))
        cases["alive_over_tombstone"] = cases["higher_alive"] & suppressed
    counts = {c: int(m.sum()) for c, m in cases.items()}
    missed = [c for c, count in counts.items() if count == 0]
    wrong = []
    if bool((new_ep[cases["lower"]] != entry_ep[cases["lower"]]).any()):
        wrong.append("a lower-epoch winner was taken")
    if bool((new_ep[cases["higher_alive"]]
             != win_ep[cases["higher_alive"]]).any()):
        wrong.append("a higher-epoch ALIVE winner was refused")
    refused = cases["higher_suspect"] | cases["higher_dead"]
    if bool((new_ep[refused] != entry_ep[refused]).any()):
        wrong.append("a higher-epoch SUSPECT or DEAD winner was taken")
    if bool(got[5][cases["self_other_epoch"].any(dim=1)].any()):
        wrong.append("a self cell refuted a winner of another epoch")
    if bool((new_ep[cases["frozen"]] != entry_ep[cases["frozen"]]).any()):
        wrong.append("a frozen row changed its epochs")
    if bool((new_ep[is_self] != own.expand_as(status)[is_self]).any()):
        wrong.append("a self cell left its own epoch")
    if plane_on and bool((new_status[cases["alive_over_tombstone"]]
                          != records.ALIVE).any()):
        wrong.append("a suppressed tombstone held against a new identity")
    if missed or wrong:
        raise AssertionError(f"{name}: epoch planes missed {missed}; "
                             f"{wrong}")
    return counts


def check_merge_kernel(device, layout):
    """Phase 3: one merge instance vs its plain version at 1M x 16, plane
    off, then with both plane branches (``planes_*`` fields); then the
    epoch form, plane off and on (``epoch_*``, ``epoch_planes_*``)."""
    row = {}
    for epoch_form in (False, True):
        params = profile_round.bench_params(layout, MAIN_N, MAIN_K,
                                            open_world=epoch_form)
        fmt, cap = params.wire_format, swim._wire_inc_sat(params)
        name = merge.NAMES[fmt.name]
        for plane_on in (False, True):
            planes = merge_planes(
                MAIN_N, MAIN_K, seed=1 + 4 * plane_on + 8 * epoch_form,
                device=device, fmt=fmt, cap=cap,
                deadlines=PLANE_DEADLINES if plane_on else None)
            if planes["inbox"].dtype != fmt.dtype:
                raise AssertionError(f"{fmt.name} planes carry a "
                                     f"{planes['inbox'].dtype} inbox")
            extra = (plane_arguments(planes, params, 6, device) if plane_on
                     else {})
            if epoch_form:
                planes["inbox"], epochs = epoch_inputs(planes, fmt, cap, 9,
                                                       device)
                extra.update(epochs)
            args = list(planes.values()) + [37, params.suspicion_rounds,
                                            params.periods_to_spread, cap]
            got = merge.merge_and_timers(*args, fmt=fmt, **extra)
            torch.cuda.synchronize()
            want = merge.merge_and_timers_reference(*args, fmt=fmt, **extra)
            err = max_abs_err(name, got, want)
            if not bool(got[5].any()):
                raise AssertionError(f"{name}: planes missed the refutation "
                                     f"case")
            if int(got[4].max()) != cap:
                raise AssertionError(f"{name}: no self_inc at the cap {cap}")
            label = f"{name} {MAIN_N}x{MAIN_K} (inbox {fmt.dtype}, cap {cap})"
            if plane_on:
                cases = check_plane_cases(name, planes, got)
                label += (f" planes on (held {cases[0]}, opened {cases[1]}, "
                          f"{cases[2]} armed lengths)")
            if epoch_form:
                cases = check_epoch_cases(name, planes, extra, got, fmt, cap,
                                          plane_on)
                label += f" epoch form ({fmt.epoch_bits} bits, cases {cases})"

            def kernel():
                return merge.merge_and_timers(*args, fmt=fmt, **extra)

            timed = timed_row(
                label, kernel,
                lambda: merge.merge_and_timers_reference(*args, fmt=fmt,
                                                         **extra),
                list(planes.values()) + tensors_of(extra) + list(got),
                "merge", MAIN_N * MAIN_K, err, clock="device")
            prefix = "epoch_" * epoch_form + "planes_" * plane_on
            row.update(prefixed(timed, prefix) if prefix else timed)
            if epoch_form:
                continue
            # CUDA events around back-to-back wrapper calls, the clock of
            # the earlier rows: at this shape they time the wrapper's
            # host-side checks as much as the kernel.
            events_ms = time_ms(kernel)
            log(f"[kernel] {name} {MAIN_N}x{MAIN_K}"
                f"{' planes on' * plane_on}: {events_ms:.4f} ms a wrapper "
                f"call on CUDA events")
            row[f"{prefix}events_ms"] = events_ms
    return row


def tensors_of(extra):
    """The tensors among a merge call's keyword arguments (their bytes
    count toward the bound)."""
    return [v for v in extra.values() if isinstance(v, torch.Tensor)]


def codec_planes(shape, g, device, round_idx, inc_sat):
    """Seeded codec inputs of ``shape``: compact planes holding every
    int16/int8 value (the sentinel 32767 among them), and wide planes with
    no timer, due, stale (past -32766 too) and far-ahead deadlines,
    spreads below the cursor and beyond 127 ahead, incarnations past the
    cap."""
    def pick(values):
        values = torch.tensor(values, dtype=torch.int64, device=device)
        idx = torch.randint(0, len(values), shape, generator=g, device=device)
        return values[idx].to(torch.int32)

    def full_range(dtype):
        info = torch.iinfo(dtype)
        return torch.randint(info.min, info.max + 1, shape, generator=g,
                             device=device, dtype=torch.int64).to(dtype)

    narrow = (full_range(torch.int16), full_range(torch.int8),
              full_range(torch.int16))
    narrow[2].view(-1)[::7] = carry.DEADLINE_NONE16
    nxt = round_idx + 1
    wide = (pick([0, 1, 7, inc_sat - 1, inc_sat, inc_sat + 1, 32767, 40000]),
            nxt + torch.randint(-300, 300, shape, generator=g, device=device,
                                dtype=torch.int32),
            pick([INT32_MAX, nxt, nxt - 1, nxt - 500, nxt - 32766,
                  nxt - 40000, nxt + 1, nxt + 32765, nxt + 32766,
                  nxt + 32767, nxt + 90000]))
    return narrow, wide


def check_encode_edges(got):
    dl = got[2]
    if not (bool((dl == carry.DEADLINE_NONE16).any())
            and bool((dl < 0).any()) and bool((got[1] == 0).any())
            and bool((got[1] == 127).any())):
        raise AssertionError("encode planes missed a clip edge")


def check_codec(device, round_idx=300, inc_sat=8191):
    """Phase 3: the compact carry's decode and encode at 1M x 16."""
    g = torch.Generator(device=device).manual_seed(2)
    narrow, wide = codec_planes((MAIN_N, MAIN_K), g, device, round_idx,
                                inc_sat)
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
            check_encode_edges(got)
        rows[name] = timed_row(
            f"{name} {MAIN_N}x{MAIN_K}", lambda: fn(*ins, *extra),
            lambda: ref(*ins, *extra), list(ins) + list(got), name,
            MAIN_N * MAIN_K, err)
        # The device clock too: CUDA events around back-to-back wrapper
        # calls also time the wrapper's host-side checks.
        rows[name]["device_ms"] = device_ms(lambda: fn(*ins, *extra))
        log(f"[kernel] {name} {MAIN_N}x{MAIN_K}: "
            f"{rows[name]['device_ms']:.4f} ms on the device clock")
    return rows


def untouched(name, planes, blk, fill):
    """Raise unless every column of ``planes`` outside ``blk`` still
    holds ``fill``."""
    rest = torch.ones(planes[0].shape[1], dtype=torch.bool,
                      device=planes[0].device)
    rest[blk] = False
    for p in planes:
        if not bool((p[:, rest] == fill).all()):
            raise AssertionError(f"{name}: a column outside the block was "
                                 f"written")


def prefixed(row, prefix):
    """A timing row as ``<prefix>*`` fields of its kernel's row in the
    kernels line (block form: ``block_``; plane branches on:
    ``planes_``, ``block_planes_``)."""
    return {f"{prefix}{key}": row[key]
            for key in ("ms", "plain_ms", "bound_ms", "bound_by")}


def check_block_merge(device, layout):
    """Phase 3: one merge instance in block form: [36,864 x 4,096] planes,
    blocks of 1,024 columns at columns 0, 1,024 and 3,072 read through
    strided views and written through ``out`` views into sentinel-filled
    planes, exact against the plain version on the same views, every
    column outside the block untouched; timed at one block (row stride
    4,096); plane off, then with both plane branches, each in the
    epoch-free and the epoch form."""
    fields = {}
    for epoch_form in (False, True):
        params = profile_round.bench_params(layout, FULL_N, BLOCK_CARRY_K,
                                            open_world=epoch_form)
        fmt, cap = params.wire_format, swim._wire_inc_sat(params)
        name = merge.NAMES[fmt.name]
        for plane_on in (False, True):
            planes = merge_planes(
                FULL_N, BLOCK_CARRY_K, seed=3 + 4 * plane_on + 8 * epoch_form,
                device=device, fmt=fmt, cap=cap,
                deadlines=PLANE_DEADLINES if plane_on else None)
            extra = (plane_arguments(planes, params, 7, device) if plane_on
                     else {})
            epochs = {}
            if epoch_form:
                planes["inbox"], epochs = epoch_inputs(planes, fmt, cap, 10,
                                                       device)
            planes = list(planes.values())
            grids, vectors = planes[:6], planes[6:]
            scalars = (37, params.suspicion_rounds, params.periods_to_spread,
                       cap)
            lanes = grids[:4] + ([epochs["epoch"]] if epoch_form else [])
            targets = [torch.full((FULL_N, BLOCK_CARRY_K), -7, dtype=p.dtype,
                                  device=device) for p in lanes]
            refuted = 0
            for col0 in BLOCK_COLS:
                blk = slice(col0, col0 + FULL_KB)
                views = [p[:, blk] for p in grids]
                outs = [t[:, blk] for t in targets]
                block_extra = dict(extra)
                if epoch_form:
                    block_extra.update(epoch=epochs["epoch"][:, blk],
                                       own_epoch=epochs["own_epoch"])

                def kernel():
                    return merge.merge_and_timers(
                        *views, *vectors, *scalars, fmt=fmt, col0=col0,
                        out=outs, **block_extra)

                def plain():
                    return merge.merge_and_timers_reference(
                        *views, *vectors, *scalars, fmt=fmt, col0=col0,
                        **block_extra)

                got = kernel()
                torch.cuda.synchronize()
                label = (f"{name} block at column {col0}"
                         + " planes on" * plane_on
                         + " epoch form" * epoch_form)
                err = max_abs_err(label, got, plain())
                untouched(label, targets, blk, -7)
                refuted += int(got[5].sum())
                if col0 == TIMED_COL0:
                    row = timed_row(
                        f"{label}, {FULL_N}x{FULL_KB}, row stride "
                        f"{BLOCK_CARRY_K}", kernel, plain,
                        views + vectors + tensors_of(block_extra) + list(got),
                        "merge", FULL_N * FULL_KB, err)
                for t in targets:
                    t.fill_(-7)
            if refuted == 0:
                raise AssertionError(f"{name}: the blocks missed the "
                                     f"refutation case")
            log(f"[kernel] {name} block form{' planes on' * plane_on}"
                f"{' epoch form' * epoch_form}: exact at columns "
                f"{list(BLOCK_COLS)} of [{FULL_N}, {BLOCK_CARRY_K}], other "
                f"columns untouched, {refuted} refutations")
            fields.update(prefixed(row, "block_" + "epoch_" * epoch_form
                                   + "planes_" * plane_on))
    return fields


def check_block_codec(device, round_idx=300, inc_sat=8191):
    """Phase 3: decode from and encode into [36,864 x 1,024] column views
    of a [36,864 x 4,096] compact carry, exact against the plain versions
    on the same views, encode leaving the other columns untouched; timed
    at one block."""
    g = torch.Generator(device=device).manual_seed(4)
    narrow, _ = codec_planes((FULL_N, BLOCK_CARRY_K), g, device, round_idx,
                             inc_sat)
    _, wide = codec_planes((FULL_N, FULL_KB), g, device, round_idx, inc_sat)
    targets = [torch.full((FULL_N, BLOCK_CARRY_K), -5, dtype=t.dtype,
                          device=device) for t in narrow]
    rows = {}
    for col0 in BLOCK_COLS:
        blk = slice(col0, col0 + FULL_KB)
        views = [t[:, blk] for t in narrow]
        outs = [t[:, blk] for t in targets]
        for name, kernel, plain, ins in (
                (carry.DECODE,
                 lambda: carry.carry_decode(*views, round_idx),
                 lambda: carry.carry_decode_reference(*views, round_idx),
                 views),
                (carry.ENCODE,
                 lambda: carry.carry_encode(*wide, round_idx, inc_sat,
                                            out=outs),
                 lambda: carry.carry_encode_reference(*wide, round_idx,
                                                      inc_sat),
                 list(wide))):
            got = kernel()
            torch.cuda.synchronize()
            err = max_abs_err(f"{name} block at column {col0}", got, plain())
            if name == carry.ENCODE:
                check_encode_edges(got)
                untouched(f"{name} block at column {col0}", targets, blk, -5)
            if col0 == TIMED_COL0:
                rows[name] = prefixed(timed_row(
                    f"{name} block {FULL_N}x{FULL_KB} at column {col0}, row "
                    f"stride {BLOCK_CARRY_K}", kernel, plain,
                    ins + list(got), name, FULL_N * FULL_KB, err), "block_")
        for t in targets:
            t.fill_(-5)
    log(f"[kernel] codec block form: exact at columns {list(BLOCK_COLS)} of "
        f"[{FULL_N}, {BLOCK_CARRY_K}], encode leaves other columns untouched")
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
                row["design"] = probes.VECTORISED[name]
                log(f"[kernel] {name} {rows_}x{cols}: design "
                    f"{row['design']}")
            if library is not None and rows_ == MAIN_N:
                row["library_ratio"] = row["ms"] / row["library_ms"]
                log(f"[kernel] {name} {rows_}x{cols}: "
                    f"{row['library_ratio']:.3f} x the library call's time")
            if name in PROBE_COPY and rows_ == MAIN_N:
                copy = widen_copy(ins[0])
                if copy.dtype != got[0].dtype or copy.shape != got[0].shape:
                    raise AssertionError(f"{name}: the copy yardstick moves "
                                         f"other bytes than the kernel")
                row["copy_ms"] = device_ms(lambda: widen_copy(ins[0]))
                row["copy_ratio"] = row["ms"] / row["copy_ms"]
                log(f"[kernel] {name} {rows_}x{cols}: same-bytes copy "
                    f"x.to(torch.int32) {row['copy_ms']:.4f} ms, kernel "
                    f"{row['copy_ratio']:.3f} x it; copy at "
                    f"{row['bound_ms'] / row['copy_ms']:.3f} of the byte "
                    f"bound")
            rows.setdefault(name, {})[f"{rows_}x{cols}"] = row
    for name in probes.VECTORISED:
        check_vectorised(device, name)
    return launches, rows


def crash_world(params, device):
    """The bench workload's world: node 3 crashed at round 10."""
    return swim.SwimWorld.healthy(params, device=device).with_crash(
        CRASHED, at_round=CRASH_AT)


def seeded_world(params, device):
    """Seeds 0, 1 and 2; node 5 blocked both ways over rounds 50-120."""
    n = params.n_members
    return (swim.SwimWorld.healthy(params, device=device).with_seeds(SEEDS)
            .with_block(5, (0, n), 50, 120).with_block((0, n), 5, 50, 120))


def blocks_of(params):
    """Column blocks a round merges (and codes) one by one: K / k_block,
    or 1 for the unblocked round."""
    return params.n_subjects // params.k_block if params.k_block else 1


def canary_run(params, make_world, dev, warm=True, seed=5):
    """One canary run on ``dev`` with the CPU-made draws: ``(state,
    metrics, launches)``."""
    draws = prng.TorchDraws(seed, "cpu", params, make_world(params, "cpu"))
    world = make_world(params, dev)
    state = swim.initial_state(params, world, warm=warm, device=dev)
    LAUNCHES.clear()
    state, metrics = swim.run(seed, params, world, CANARY_ROUNDS,
                              state=state, draws=lambda r: draws(r).to(dev),
                              device=dev)
    return state, metrics, dict(LAUNCHES)


def canary(device, label, layout, params, make_world, warm=True, seed=5):
    """Phase 5: the same run on the card and on the CPU, same draws (the
    CPU's made in a worker process, :func:`cpu_half`)."""
    cs, cm, cpu_launches = cpu_half("run", label)
    gs, gm, gpu_launches = canary_run(params, make_world, device, warm,
                                      seed)
    n, k = params.n_members, params.n_subjects
    for field in dataclasses.fields(swim.SwimState):
        if not torch.equal(getattr(cs, field.name),
                           getattr(gs, field.name).cpu()):
            raise AssertionError(f"canary {label} {n}x{k}: state."
                                 f"{field.name} differs")
    for name, value in cm.items():
        if not torch.equal(value, gm[name].cpu()):
            raise AssertionError(f"canary {label} {n}x{k}: metric {name} "
                                 f"differs")
    want = {name: CANARY_ROUNDS * blocks_of(params)
            for name in ROUND_KERNELS[layout]}
    if cpu_launches or gpu_launches != want:
        raise AssertionError(f"canary {label} {n}x{k}: launches cpu="
                             f"{cpu_launches} card={gpu_launches}, want "
                             f"none and {want}")
    md = (f", md cells set {int((cs.md != 0).sum())}, metadata_divergent "
          f"max {int(cm['metadata_divergent'].max())} final "
          f"{int(cm['metadata_divergent'][-1])}"
          if params.metadata_keys else "")
    log(f"[canary] {label} {n}x{k}, {CANARY_ROUNDS} rounds: card == CPU "
        f"bit for bit, every state lane and metric ({gs.inc.dtype} inc), "
        f"launches {gpu_launches}; ring cells held at the end "
        f"{int((cs.inbox_ring >= 0).sum())}, final absent "
        f"{int(cm['absent'][-1].sum())}{md}")


class Split:
    """``make_world`` with its members split half/half over rounds
    [0, split), then healed (a picklable world factory)."""

    def __init__(self, make_world, split=CANARY_SPLIT):
        self.make_world, self.split = make_world, split

    def __call__(self, params, device):
        n = params.n_members
        part = torch.zeros((4, n), dtype=torch.int8)
        part[0, :n // 2] = 1
        return self.make_world(params, device).with_partition_schedule(
            part, self.split)


class Joined:
    """``make_world`` with ``node`` joined by a new identity at round
    ``at`` (a picklable world factory)."""

    def __init__(self, make_world, node, at):
        self.make_world, self.node, self.at = make_world, node, at

    def __call__(self, params, device):
        return self.make_world(params, device).with_join(self.node, self.at)


class Pushed:
    """``make_world`` with the config pushes ``(node, key, value, at)``
    (a picklable world factory)."""

    def __init__(self, make_world, pushes=MD_PUSHES):
        self.make_world, self.pushes = make_world, pushes

    def __call__(self, params, device):
        world = self.make_world(params, device)
        for node, key, value, at in self.pushes:
            world = world.with_metadata_push(node, key, value, at)
        return world


NETWORK_CANARY_WORLD = functools.partial(profile_round.network_world,
                                         rounds=CANARY_ROUNDS)


def canary_cases():
    """Phase 5's canaries, ``(label, layout, params, make_world, warm)``.
    The crash canaries at 4,096 x 16 (shift in the four layouts, scatter
    wide) are the traced canaries' untraced runs (:func:`traced_canary`:
    the same params and draws, their world with a leave added)."""
    cases = [(f"{layout}", layout,
              profile_round.bench_params(layout, 512, 512), crash_world,
              True) for layout in ("wide", "compact")]
    cases += [(f"network {layout}", layout,
               profile_round.network_params(layout, 4096, 16),
               NETWORK_CANARY_WORLD, True)
              for layout in ("wide", "int16_wire", "compact_wire24")]
    cases.append(("seeded cold start", "wide",
                  profile_round.bench_params("wide", 512, 512),
                  seeded_world, False))
    cases += [(f"scatter {layout}", layout,
               profile_round.bench_params(layout, n, k, "scatter"),
               crash_world, True)
              for layout, n, k in (("wide", 512, 512), ("compact", 512, 512),
                                   ("int16_wire", 4096, 16))]
    cases += [(f"scatter network wide{label}", "wide",
               profile_round.network_params("wide", 4096, 16, "scatter",
                                            **overrides),
               NETWORK_CANARY_WORLD, True)
              for label, overrides in (("", {}), (" two-buffer wire",
                                                  dict(fused_wire=False)))]
    cases.append(("scatter seeded cold start", "wide",
                  profile_round.bench_params("wide", 512, 512, "scatter"),
                  seeded_world, False))
    cases += [(f"k_block=128 {layout}", layout,
               profile_round.bench_params(layout, 512, 512, k_block=128),
               crash_world, True) for layout in LAYOUTS]
    cases += [(f"{delivery} network wide link_counters", "wide",
               profile_round.network_params("wide", 4096, 16, delivery,
                                            link_counters=True),
               NETWORK_CANARY_WORLD, True)
              for delivery in ("shift", "scatter")]
    # The three tick-level planes on, across a partition healed at round
    # 64.
    cases += [(f"{delivery} planes", "wide",
               profile_round.bench_params("wide", 4096, 16, delivery,
                                          **CANARY_PLANES),
               Split(crash_world), True) for delivery in ("shift", "scatter")]
    cases.append(("k_block=128 compact planes", "compact",
                  profile_round.bench_params("compact", 512, 512,
                                             k_block=128, **CANARY_PLANES),
                  Split(crash_world), True))
    cases.append(("network wide planes", "wide",
                  profile_round.network_params("wide", 4096, 16,
                                               **CANARY_PLANES),
                  NETWORK_CANARY_WORLD, True))
    # The open-world plane: the churn storm at 4,096 x 16 (its schedule at
    # this size), both arms, scatter and the narrow layouts; the network
    # configuration with node 3 rejoining; k_block compact with a join and
    # the three planes on.
    cases += [(label, layout, storm_params(4096, 16, layout, delivery,
                                           guard), storm_world_of, True)
              for label, layout, delivery, guard in (
                  ("storm", "wide", "shift", True),
                  ("storm naive", "wide", "shift", False),
                  ("scatter storm", "wide", "scatter", True),
                  ("storm int16_wire", "int16_wire", "shift", True),
                  ("storm compact_wire24", "compact_wire24", "shift", True))]
    cases.append(("network wide join", "wide",
                  profile_round.network_params("wide", 4096, 16,
                                               open_world=True),
                  Joined(NETWORK_CANARY_WORLD, CRASHED, NETWORK_JOIN_AT),
                  True))
    cases.append(("k_block=128 compact planes join", "compact",
                  profile_round.bench_params("compact", 512, 512,
                                             k_block=128, open_world=True,
                                             **CANARY_PLANES),
                  Joined(Split(crash_world), CRASHED, CANARY_SPLIT - 24),
                  True))
    return cases + md_canary_cases()


def md_canary_cases():
    """The metadata plane's canaries at full view 512 x 512 (two keys,
    the exchange every 8 rounds, node 3 crashed at round 10, three
    pushes, one inside the partition of rounds 0-63): shift in the four
    layouts, scatter on both wires, the open world with node 3 rejoining
    at round 40 (its md row reset) and pushing as the new identity, the
    network configuration (delays, rules, the ring: md same-round only),
    and Lifeguard with the suppression window."""
    split = Pushed(Split(crash_world))
    cases = [(f"metadata {layout}", layout,
              profile_round.bench_params(layout, 512, 512, **MD_CANARY),
              split, True) for layout in LAYOUTS]
    cases += [(f"scatter metadata wide{label}", "wide",
               profile_round.bench_params("wide", 512, 512, "scatter",
                                          **MD_CANARY, **overrides),
               split, True)
              for label, overrides in (("", {}), (" two-buffer wire",
                                                  dict(fused_wire=False)))]
    cases.append(("metadata open world join", "wide",
                  profile_round.bench_params("wide", 512, 512,
                                             open_world=True, **MD_CANARY),
                  Pushed(Joined(Split(crash_world), CRASHED, MD_JOIN_AT),
                         MD_PUSHES + (MD_JOIN_PUSH,)), True))
    cases.append(("network metadata wide", "wide",
                  profile_round.network_params("wide", 512, 512,
                                               **MD_CANARY),
                  Pushed(NETWORK_CANARY_WORLD), True))
    cases.append(("metadata lifeguard suppression", "wide",
                  profile_round.bench_params("wide", 512, 512, lhm_max=8,
                                             dead_suppress_rounds=64,
                                             **MD_CANARY), split, True))
    return cases


def canaries(device):
    """Phase 5: the canaries of :func:`canary_cases`."""
    for label, layout, params, make_world, warm in canary_cases():
        canary(device, label, layout, params, make_world, warm=warm)


def run_layout(device, layout, delivery="shift"):
    """Phases 6 and 10: one layout of the 1M x 16 round for 600 rounds, with
    the detection gates; returns what the identity check and the kernel
    line need, and the detection round and DEAD share."""
    tag = "main" if delivery == "shift" else f"{delivery} main"
    params = profile_round.bench_params(layout, MAIN_N, MAIN_K, delivery)
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
    log(f"[{tag}] {layout} {MAIN_N}x{MAIN_K}, {MAIN_ROUNDS} rounds in "
        f"{seconds:.3f} s: {ms_round:.4f} ms/round, "
        f"{MAIN_N * MAIN_ROUNDS / seconds:.6g} member-rounds/s, peak {peak} "
        f"B allocated ({resident} B resident before the run); profiled "
        f"{PROFILE_ROUNDS} rounds: "
        f"{window['kernel_launches_per_round']:.2f} kernel launches/round, "
        f"device busy {window['device_busy_ms_per_round']:.4f} ms/round, "
        f"wall {window['wall_ms_per_round']:.4f} ms/round, idle share "
        f"{window['device_idle_share']:.4f}, phases "
        f"{json.dumps(window['phase_device_ms_per_round'])}, launches "
        f"{json.dumps(window['phase_launches_per_round'])}")
    log(f"[{tag}] {layout} node {CRASHED}: first SUSPECT at round "
        f"{first_suspect}, first DEAD at round "
        f"{int(torch.nonzero(dead > 0)[0])}, {dead_share:.6f} of live "
        f"observers hold it DEAD at the end; false_positives total "
        f"{int(metrics['false_positives'].sum())}, refutations "
        f"{int(metrics['refutations'].sum())}")
    return params, state, metrics, launches, dict(
        first_suspect=first_suspect, dead_share=dead_share, window=window)


def decoded(state, params):
    """The final state as absolute int32 planes.  ``spread_until`` is
    taken as the gossip gate reads it (``round < spread_until``), i.e.
    clipped below at the cursor: the compact carry stores a spread
    window that has passed as 0 rounds remaining."""
    deadline, spread = swim._wide_timer_fields(state, params, MAIN_ROUNDS)
    return dict(status=state.status, inc=state.inc.to(torch.int32),
                spread_until=torch.clamp(spread, min=MAIN_ROUNDS),
                suspect_deadline=deadline, self_inc=state.self_inc)


def main_path(device, delivery="shift",
              narrow=("int16_wire", "compact", "compact_wire24")):
    """Phases 6 and 10: wide, then each ``narrow`` layout against it;
    returns the launches and the wide run's detection summary."""
    launches = {}
    wide_params, wide_state, wide_metrics, counts, summary = run_layout(
        device, "wide", delivery)
    launches.update(counts)
    # Held on the host, so that no narrow run's peak counts it.
    want = {name: value.cpu()
            for name, value in decoded(wide_state, wide_params).items()}
    del wide_state
    for layout in narrow:
        params, state, metrics, counts, _ = run_layout(device, layout,
                                                       delivery)
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
        log(f"[identity] {delivery} {layout}: per-round metrics and decoded "
            f"final state equal the wide run's ({state.inc.dtype} inc, "
            f"{params.wire_format.name} wire)")
        del state
    return launches, summary


def network_run(device, layout):
    """Phase 7: one layout of the network configuration at 1M x 16 for 600
    rounds, with its gates; returns what the identity check and the
    kernel line need, and a summary the planes' network run prints
    beside its own."""
    params = profile_round.network_params(layout, MAIN_N, MAIN_K)
    world = profile_round.network_world(params, device)
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
    want = {name: MAIN_ROUNDS for name in ROUND_KERNELS[layout]}
    if launches != want:
        raise AssertionError(f"network {layout}: kernel launches {launches} "
                             f"in {MAIN_ROUNDS} rounds, want {want}")
    live_observers = MAIN_N - 1
    suspect, dead = metrics["suspect"], metrics["dead"]
    onset = torch.nonzero(suspect[:, CRASHED] > 0)
    first_suspect = int(onset[0]) if onset.numel() else None
    if first_suspect is None or first_suspect > CRASH_AT + 50:
        raise AssertionError(f"network {layout}: node {CRASHED} not suspected "
                             f"within 50 rounds (first at {first_suspect})")
    dead_share = int(dead[-1, CRASHED]) / live_observers
    if dead_share < 0.99:
        raise AssertionError(f"network {layout}: only {dead_share:.4f} of "
                             f"live observers hold node {CRASHED} DEAD")
    live = torch.arange(MAIN_K) != CRASHED
    brownout = int(suspect[100:260, live].sum())
    before = int(suspect[20:100, live].sum())
    floor = brownout_floor(MAIN_N, int(live.sum()), 260 - 100)
    if not (brownout > 10 * before and brownout >= floor):
        raise AssertionError(f"network {layout}: SUSPECT entries about live "
                             f"subjects, rounds 100-260: {brownout}, rounds "
                             f"20-100: {before} (want more than 10x, and at "
                             f"least {floor})")
    stale = dead[-1, live].max().item() / live_observers
    if stale >= 0.01:
        raise AssertionError(f"network {layout}: a live subject is held DEAD "
                             f"by {stale:.4f} of live observers at the end")
    reach = []
    for g in range(params.n_user_gossips):
        held = metrics["user_gossip_infected"][:, g]
        full = torch.nonzero(held >= 0.99 * live_observers)
        if not full.numel():
            raise AssertionError(f"network {layout}: user gossip {g} reached "
                                 f"{int(held[-1])} of {live_observers} live "
                                 f"members")
        reach.append(int(full[0]))
    # The brownout's peak: a run to round 160 must hold delayed messages
    # in its ring, and the profiled window starts there.
    peak_round = profile_round.NETWORK_PEAK
    mid, _ = swim.run(0, params, world, peak_round, device=device)
    cells = int((mid.inbox_ring >= 0).sum())
    if cells == 0:
        raise AssertionError(f"network {layout}: the ring is empty at round "
                             f"{peak_round}")
    window = profile_round.profile_window(params, world, mid, peak_round,
                                          PROFILE_ROUNDS)
    del mid
    ms_round = seconds / MAIN_ROUNDS * 1e3
    log(f"[network] {layout} {MAIN_N}x{MAIN_K}, {MAIN_ROUNDS} rounds in "
        f"{seconds:.3f} s: {ms_round:.4f} ms/round, "
        f"{MAIN_N * MAIN_ROUNDS / seconds:.6g} member-rounds/s, peak {peak} B "
        f"allocated ({resident} B resident before the run); {cells} ring "
        f"cells hold a delayed message at round {peak_round}; profiled "
        f"rounds {peak_round}-{peak_round + PROFILE_ROUNDS}: "
        f"{window['kernel_launches_per_round']:.2f} kernel launches/round "
        f"({window['phase_launches_per_round']['swim.delivery']:.2f} in "
        f"swim.delivery), device busy "
        f"{window['device_busy_ms_per_round']:.4f} ms/round, wall "
        f"{window['wall_ms_per_round']:.4f} ms/round, idle share "
        f"{window['device_idle_share']:.4f}, ring {window['ring_bytes']} B, "
        f"phases {json.dumps(window['phase_device_ms_per_round'])}, "
        f"launches {json.dumps(window['phase_launches_per_round'])}")
    log(f"[network] {layout} node {CRASHED}: first SUSPECT at round "
        f"{first_suspect}, {dead_share:.6f} of live observers hold it DEAD at "
        f"the end; SUSPECT entries about live subjects {before} in rounds "
        f"20-100, {brownout} in rounds 100-260 (floor {floor}); largest DEAD "
        f"share of a live "
        f"subject at the end {stale:.6f}; user gossips reach 99% of live "
        f"members at rounds {reach}")
    summary = dict(ms_round=ms_round, window=window, brownout=brownout,
                   dead_share=dead_share, first_suspect=first_suspect)
    return params, state, metrics, launches, summary


def brownout_floor(n, live_subjects, rounds):
    """The least SUSPECT entries about live subjects the brownout's
    window must hold: ``BROWNOUT_FLOOR_SHARE`` of the browned-out
    senders (ids [0, N/10), ``profile_round.network_world``) for each
    live subject and round."""
    senders = round(n / 10)
    return int(BROWNOUT_FLOOR_SHARE * senders * live_subjects * rounds)


def network_state(state, params):
    """The final state as absolute int32 planes, the ring unpacked."""
    ring_status, ring_inc = delivery.unpack_record(state.inbox_ring,
                                                   fmt=params.wire_format)
    return dict(decoded(state, params), ring_status=ring_status,
                ring_inc=ring_inc, flag_ring=state.flag_ring,
                g_infected=state.g_infected,
                g_spread_until=state.g_spread_until, g_ring=state.g_ring)


def network_path(device):
    """Phase 7: wide, then int16_wire against it; returns the launches
    and the wide run's summary."""
    launches = {}
    wide_params, wide_state, wide_metrics, counts, summary = network_run(
        device, "wide")
    launches.update(counts)
    want = {name: value.cpu() for name, value in
            network_state(wide_state, wide_params).items()}
    del wide_state
    params, state, metrics, counts, _ = network_run(device, "int16_wire")
    for name, count in counts.items():
        launches[name] = launches.get(name, 0) + count
    for name, value in wide_metrics.items():
        if not torch.equal(metrics[name], value):
            raise AssertionError(f"network int16_wire: metric {name} "
                                 f"differs from the wide run")
    for name, value in network_state(state, params).items():
        if not torch.equal(value.cpu(), want[name]):
            raise AssertionError(f"network int16_wire: final {name} differs "
                                 f"from the wide run")
    log(f"[identity] network int16_wire: per-round metrics and final state "
        f"(rings unpacked) equal the wide run's")
    return launches, summary


def heal_params(sync_interval):
    return swim.SwimParams.from_config(
        campaign.campaign_config(), n_members=HEAL_N, n_subjects=HEAL_K,
        delivery="shift", sync_every=0, sync_interval=sync_interval)


def heal_world(params, device):
    """Focal subjects spread over the ids, split half/half over rounds
    [0, 320), then healed (the reference's RollingPartition phases)."""
    n = params.n_members
    world = swim.SwimWorld.healthy(
        params, subject_ids=torch.arange(HEAL_K, dtype=torch.int32)
        * (n // HEAL_K), device=device)
    part = torch.zeros((3, n), dtype=torch.int8)
    part[0, :n // 2] = 1
    return world.with_partition_schedule(part, HEAL_SPLIT)


def heal_path(device):
    """Phase 8 (a), the planes at full width: the partition heal of
    ``bench.py --sync``'s scale arm.  The split's 320 rounds, then 2 at a
    time with the divergence probe after each, until the tables agree
    or the 204-round window ends; then the gossip-only control (no
    exchange) over the split and the whole window.  Gates: the split
    left divergent columns, the plane converges inside the window, the
    control does not."""
    params = heal_params(HEAL_SYNC_INTERVAL)
    world = heal_world(params, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    state, _ = swim.run(HEAL_SEED, params, world, HEAL_SPLIT, device=device)
    at_heal = int(sync_plane.divergence_probe(state, params, world,
                                              HEAL_SPLIT))
    converge_at, r = None, HEAL_SPLIT
    while r < HEAL_SPLIT + HEAL_WINDOW:
        state, _ = swim.run(HEAL_SEED, params, world, HEAL_PROBE_STEP,
                            state=state, start_round=r, device=device)
        r += HEAL_PROBE_STEP
        if int(sync_plane.divergence_probe(state, params, world, r)) == 0:
            converge_at = r - HEAL_SPLIT
            break
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check_launches("heal", params, launches, r, "wide")
    if at_heal == 0:
        raise AssertionError("heal: no divergent column at the heal")
    if converge_at is None:
        raise AssertionError(f"heal: the tables did not agree within "
                             f"{HEAL_WINDOW} rounds of the heal")
    window = profile_round.profile_window(params, world, state, r,
                                          PROFILE_ROUNDS)
    del state
    control = dataclasses.replace(params, sync_interval=0)
    c_state, _, c_seconds, c_launches, c_peak = timed_run(
        control, world, HEAL_SPLIT + HEAL_WINDOW, device, seed=HEAL_SEED)
    check_launches("heal control", control, c_launches,
                   HEAL_SPLIT + HEAL_WINDOW, "wide")
    c_div = int(sync_plane.divergence_probe(c_state, control, world,
                                            HEAL_SPLIT + HEAL_WINDOW))
    del c_state
    if c_div == 0:
        raise AssertionError("heal: the gossip-only control converged")
    ms_round = seconds / r * 1e3
    c_ms = c_seconds / (HEAL_SPLIT + HEAL_WINDOW) * 1e3
    log(f"[heal] {HEAL_N}x{HEAL_K} shift, split {HEAL_SPLIT} rounds, "
        f"sync_interval {HEAL_SYNC_INTERVAL}, seed {HEAL_SEED}: divergent "
        f"columns at the heal {at_heal}; sync_rounds_to_converge "
        f"{converge_at} (window {HEAL_WINDOW}); {r} rounds in {seconds:.3f} "
        f"s with a probe every {HEAL_PROBE_STEP}: {ms_round:.4f} ms/round, "
        f"{HEAL_N * r / seconds:.6g} member-rounds/s, peak {peak} B; "
        f"profiled {PROFILE_ROUNDS} rounds from round {r}: "
        f"{window['kernel_launches_per_round']:.2f} kernel launches/round, "
        f"device busy {window['device_busy_ms_per_round']:.4f} ms/round, "
        f"wall {window['wall_ms_per_round']:.4f} ms/round, idle share "
        f"{window['device_idle_share']:.4f}, phases "
        f"{json.dumps(window['phase_device_ms_per_round'])}")
    log(f"[heal] gossip-only control (sync_interval 0), "
        f"{HEAL_SPLIT + HEAL_WINDOW} rounds in {c_seconds:.3f} s: "
        f"{c_ms:.4f} ms/round, peak {c_peak} B; divergent columns at heal + "
        f"{HEAL_WINDOW}: {c_div}")
    for name, count in c_launches.items():
        launches[name] = launches.get(name, 0) + count
    return launches


def lifeguard_network_path(device, plane_off):
    """Phase 8 (b), the planes at full width: the network configuration
    at 1M x 16 (wide, 600 rounds) with Lifeguard (multipliers up to 8)
    and a suppression window of periods_to_spread + 2 rounds, run in
    segments through ``chaos.monitor.run_monitored`` (the passive spec).
    Gates at every segment's end: every live row's multiplier in [1, 8]
    and the monitor's TIMER_BOUND count 0 (checked every round: no timer
    past round + ``suspicion_rounds * 8``, none on a non-SUSPECT entry
    but a DEAD one inside its suppression window); and node 3 suspected
    within 50 rounds of its crash.  The run's ms/round includes the
    monitor.  Prints its numbers beside the
    plane-off network run's (``plane_off``, phase 7's wide summary), the
    SUSPECT entries about live subjects in the brownout window and the
    share of live observers holding node 3 DEAD at the end."""
    params = profile_round.with_planes(
        profile_round.network_params("wide", MAIN_N, MAIN_K),
        sync_interval=0)
    world = profile_round.network_world(params, device)
    spec = monitor.MonitorSpec.passive(params, device=device)
    timer_code = monitor.InvariantCode.TIMER_BOUND
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    state, mon, rows, seconds, mid = None, None, [], 0.0, None
    for lo, hi in zip(LIFEGUARD_SEGMENTS, LIFEGUARD_SEGMENTS[1:]):
        t0 = time.perf_counter()
        state, mon, metrics = monitor.run_monitored(
            0, params, world, spec, hi - lo, state=state, start_round=lo,
            monitor=mon, device=device)
        torch.cuda.synchronize()
        seconds += time.perf_counter() - t0
        rows.append({name: value.cpu() for name, value in metrics.items()})
        lhm = state.lhm
        if int(lhm.min()) < 1 or int(lhm.max()) > params.lhm_max:
            raise AssertionError(f"lifeguard: lhm outside [1, "
                                 f"{params.lhm_max}] at round {hi}")
        timer = int(mon.code_counts[timer_code])
        if timer:
            raise AssertionError(f"lifeguard: the monitor counts {timer} "
                                 f"TIMER_BOUND cells by round {hi}")
        if hi == profile_round.NETWORK_PEAK:
            mid = state
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check_monitor_launches("lifeguard", params, launches, MAIN_ROUNDS,
                           "wide", 5)
    metrics = {name: torch.cat([row[name] for row in rows])
               for name in rows[0]}
    suspect, dead = metrics["suspect"], metrics["dead"]
    onset = torch.nonzero(suspect[:, CRASHED] > 0)
    first_suspect = int(onset[0]) if onset.numel() else None
    if first_suspect is None or first_suspect > CRASH_AT + 50:
        raise AssertionError(f"lifeguard: node {CRASHED} not suspected "
                             f"within 50 rounds (first at {first_suspect})")
    live = torch.arange(MAIN_K) != CRASHED
    brownout = int(suspect[100:260, live].sum())
    dead_share = int(dead[-1, CRASHED]) / (MAIN_N - 1)
    window = profile_round.profile_window(params, world, mid,
                                          profile_round.NETWORK_PEAK,
                                          PROFILE_ROUNDS)
    del mid, state
    ms_round = seconds / MAIN_ROUNDS * 1e3
    off_window = plane_off["window"]
    log(f"[lifeguard] network wide {MAIN_N}x{MAIN_K}, lhm_max "
        f"{params.lhm_max}, dead_suppress_rounds "
        f"{params.dead_suppress_rounds}, {MAIN_ROUNDS} rounds: "
        f"{ms_round:.4f} ms/round (planes off {plane_off['ms_round']:.4f}), "
        f"{MAIN_N * MAIN_ROUNDS / seconds:.6g} member-rounds/s, peak {peak} B;"
        f" profiled rounds {profile_round.NETWORK_PEAK}-"
        f"{profile_round.NETWORK_PEAK + PROFILE_ROUNDS}: device busy "
        f"{window['device_busy_ms_per_round']:.4f} ms/round (off "
        f"{off_window['device_busy_ms_per_round']:.4f}), "
        f"{window['kernel_launches_per_round']:.2f} kernel launches/round "
        f"(off {off_window['kernel_launches_per_round']:.2f}), wall "
        f"{window['wall_ms_per_round']:.4f} ms/round, idle share "
        f"{window['device_idle_share']:.4f}, phases "
        f"{json.dumps(window['phase_device_ms_per_round'])}, launches "
        f"{json.dumps(window['phase_launches_per_round'])}")
    log(f"[lifeguard] lhm in [1, {params.lhm_max}] at rounds "
        f"{list(LIFEGUARD_SEGMENTS[1:])} and the monitor's TIMER_BOUND 0 "
        f"every round (monitor codes "
        f"{codes_of(mon)}"
        f"); node {CRASHED}: "
        f"first SUSPECT at round {first_suspect} (off "
        f"{plane_off['first_suspect']}), {dead_share:.6f} of live observers "
        f"hold it DEAD at the end (off {plane_off['dead_share']:.6f}); "
        f"SUSPECT entries about live subjects in rounds 100-260: {brownout} "
        f"(off {plane_off['brownout']}); final lhm: mean "
        f"{float(lhm.double().mean()):.4f}, max {int(lhm.max())}, rows above "
        f"1: {int((lhm > 1).sum())}")
    return launches


def cold_start_path(device, delivery="shift"):
    """Phases 9 and 11: the seeded cold start at full view 4,096 x
    4,096."""
    params = swim.SwimParams.from_config(
        ClusterConfig.default(), n_members=COLD_N, loss_probability=0.0,
        delivery=delivery)
    world = swim.SwimWorld.healthy(params, device=device).with_seeds(SEEDS)
    state = swim.initial_state(params, world, warm=False, device=device)
    rounds = 12 * params.periods_to_spread
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    state, metrics = swim.run(0, params, world, rounds, state=state,
                              device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    want = {name: rounds for name in ROUND_KERNELS["wide"]}
    if launches != want:
        raise AssertionError(f"cold start: kernel launches {launches} in "
                             f"{rounds} rounds, want {want}")
    if not bool((state.status == records.ALIVE).all()):
        raise AssertionError(
            f"cold start: {int((state.status != records.ALIVE).sum())} cells "
            f"are not ALIVE after {rounds} rounds")
    known = metrics["alive"].sum(dim=1).cpu()
    full_at = int(torch.nonzero(known == COLD_N * (COLD_N - 1))[0])
    log(f"[cold start] {delivery} full view {COLD_N}x{COLD_N}, seeds {SEEDS}, "
        f"{rounds} "
        f"rounds (12 x periods_to_spread) in {seconds:.3f} s: "
        f"{seconds / rounds * 1e3:.4f} ms/round, peak "
        f"{torch.cuda.max_memory_allocated()} B; cells known ALIVE "
        f"{int(known[0])} after round 0, membership full from round "
        f"{full_at}")
    return launches


def capacity_params(n, layout, k_block):
    """The reference's full-view capacity configuration
    (experiments/fullview_ceiling.py:88-94): LAN defaults, N = K, shift,
    suspicion 6 rounds, ping every 2, SYNC every 4, aggregate metrics,
    loss 0."""
    return swim.SwimParams.from_config(
        ClusterConfig.default_local(), n_members=n, delivery="shift",
        suspicion_rounds=6, ping_every=2, sync_every=4,
        per_subject_metrics=False, k_block=k_block, **LAYOUTS[layout])


def capacity_world(params, device):
    return swim.SwimWorld.healthy(params, device=device).with_crash(
        CRASHED, at_round=FULL_CRASH_AT)


def timed_run(params, world, rounds, device, seed=0):
    """``rounds`` rounds from a fresh state made inside ``run`` (so no
    caller holds it), timed on the host clock ending in a device sync.
    Returns the state, metrics on the host, seconds, launches and the
    peak bytes allocated during the run."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    state, metrics = swim.run(seed, params, world, rounds, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    return (state, {name: value.cpu() for name, value in metrics.items()},
            seconds, launches, peak)


def check_launches(label, params, launches, rounds, layout):
    want = {name: rounds * blocks_of(params)
            for name in ROUND_KERNELS[layout]}
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches} in "
                             f"{rounds} rounds, want {want}")


def blocked_pair(device, planes=False):
    """Phase 12: the capacity configuration at N = 8,192 for 60 rounds,
    wide and compact, blocked (k_block=1,024) and unblocked: per-round
    metrics and every state lane equal; peak bytes printed.  ``planes``:
    compact only, with the three tick-level planes on (the exchange
    every 8 rounds)."""
    launches = {}
    for layout in ("compact",) if planes else ("wide", "compact"):
        runs = {}
        for k_block in (FULL_KB, 0):
            params = capacity_params(PAIR_N, layout, k_block)
            if planes:
                params = profile_round.with_planes(params, sync_interval=8)
                layout_label = f"{layout} planes"
            else:
                layout_label = layout
            world = capacity_world(params, device)
            state, metrics, seconds, counts, peak = timed_run(
                params, world, PAIR_ROUNDS, device)
            label = f"pair {layout_label} k_block={k_block}"
            check_launches(label, params, counts, PAIR_ROUNDS, layout)
            for name, count in counts.items():
                launches[name] = launches.get(name, 0) + count
            runs[k_block] = ({f.name: getattr(state, f.name).cpu()
                              for f in dataclasses.fields(state)}, metrics)
            del state
            log(f"[pair] {layout_label} {PAIR_N}x{PAIR_N} k_block={k_block}, "
                f"{PAIR_ROUNDS} rounds in {seconds:.3f} s: "
                f"{seconds / PAIR_ROUNDS * 1e3:.4f} ms/round, peak {peak} B "
                f"allocated, {peak / PAIR_N ** 2:.3f} B/cell; launches "
                f"{counts}")
        (blocked, m_blocked), (flat, m_flat) = runs[FULL_KB], runs[0]
        for name, value in flat.items():
            if not torch.equal(value, blocked[name]):
                raise AssertionError(f"pair {layout_label}: state.{name} "
                                     f"differs between blocked and unblocked")
        for name, value in m_flat.items():
            if not torch.equal(value, m_blocked[name]):
                raise AssertionError(f"pair {layout_label}: metric {name} "
                                     f"differs between blocked and unblocked")
        log(f"[pair] {layout_label}: blocked == unblocked, every state lane "
            f"and metric over {PAIR_ROUNDS} rounds; final dead "
            f"{int(m_flat['dead'][-1])}")
    return launches


def row_state(state, node):
    """Row ``node`` of ``state`` copied to the host as a one-row state
    (``node_snapshot`` of it reads row 0)."""
    rows = {name: getattr(state, name)[node:node + 1].cpu()
            for name in ("status", "inc", "spread_until", "suspect_deadline",
                         "self_inc")}
    return dataclasses.replace(state, **rows)


def capacity_path(device):
    """Phase 13: the full-width capacity path, 36,864 x 36,864 compact
    with k_block=1,024, ``FULL_ROUNDS`` rounds, with its gates."""
    params = capacity_params(FULL_N, FULL_LAYOUT, FULL_KB)
    world = capacity_world(params, device)
    cells = FULL_N * FULL_N
    state, metrics, seconds, launches, peak = timed_run(
        params, world, FULL_ROUNDS, device)
    check_launches("capacity", params, launches, FULL_ROUNDS, FULL_LAYOUT)
    live_observers = FULL_N - 1
    dead = metrics["dead"]
    if int(dead[-1]) < 0.99 * live_observers:
        raise AssertionError(f"capacity: {int(dead[-1])} DEAD entries at "
                             f"round {FULL_ROUNDS}, want at least 0.99 x "
                             f"{live_observers}")
    false_positives = int(metrics["false_positives"].sum())
    if false_positives != 0:
        raise AssertionError(f"capacity: {false_positives} false-positive "
                             f"observer-rounds (loss 0, no delay)")
    if peak > MAX_BYTES_PER_CELL * cells:
        raise AssertionError(f"capacity: peak {peak} B allocated, over "
                             f"{MAX_BYTES_PER_CELL} B/cell")
    full = torch.nonzero(dead == live_observers)
    snapshot = swim.node_snapshot(state, params, world, 0,
                                  round_idx=FULL_ROUNDS)
    if CRASHED not in snapshot["dead_tombstones"]:
        raise AssertionError(f"capacity: node 0's snapshot does not hold "
                             f"node {CRASHED} DEAD")
    on_host = swim.node_snapshot(row_state(state, 0), params,
                                 capacity_world(params, "cpu"), 0,
                                 round_idx=FULL_ROUNDS)
    if snapshot != on_host:
        raise AssertionError("capacity: node 0's snapshot differs from the "
                             "one made from its row on the CPU")
    window = profile_round.profile_window(params, world, state, FULL_ROUNDS,
                                          PROFILE_FULL_ROUNDS)
    del state
    ms_round = seconds / FULL_ROUNDS * 1e3
    log(f"[capacity] {FULL_LAYOUT} {FULL_N}x{FULL_N} k_block={FULL_KB}, "
        f"{FULL_ROUNDS} rounds in {seconds:.3f} s: {ms_round:.4f} ms/round, "
        f"{cells * FULL_ROUNDS / seconds:.6g} record-updates/s, peak {peak} B "
        f"allocated, {peak / cells:.4f} B/cell; launches {launches}")
    log(f"[capacity] node {CRASHED} crashed at round {FULL_CRASH_AT}: held "
        f"DEAD by every live observer from round "
        f"{int(full[0]) if full.numel() else None}, "
        f"{int(dead[-1])} of {live_observers} at the end; false positives 0; "
        f"node 0's snapshot: {len(snapshot['alive_members'])} alive, "
        f"dead {snapshot['dead_tombstones']}, equal to the CPU's")
    log(f"[capacity] profiled {PROFILE_FULL_ROUNDS} rounds from round "
        f"{FULL_ROUNDS}: {window['kernel_launches_per_round']:.2f} kernel "
        f"launches/round, device busy {window['device_busy_ms_per_round']:.4f}"
        f" ms/round, wall {window['wall_ms_per_round']:.4f} ms/round, idle "
        f"share {window['device_idle_share']:.4f}, phases "
        f"{json.dumps(window['phase_device_ms_per_round'])}, launches "
        f"{json.dumps(window['phase_launches_per_round'])}")
    return launches


def storm_params(n, k, layout="wide", delivery="shift", guard=True):
    """The storm's params: the chaos campaign's config with the open-world
    plane on (``epoch_guard=False``: the naive-reuse arm), loss 0."""
    return swim.SwimParams.from_config(
        campaign.campaign_config(), n_members=n, n_subjects=k,
        delivery=delivery,
        open_world=True, epoch_guard=guard, **LAYOUTS[layout])


def storm_world(params, device, seed=STORM_SEED):
    """The churn storm's world, the reference's ``churn_growth_scenario``
    geometry with its pools drawn from the K focal subjects (spread over
    the ids): waves of victims, each scared first (inbound loss 1.0 for
    6 rounds, ending 14 rounds before its crash, so it dies at
    incarnation >= 1), new identities joining mid-suspicion into the
    free slots in FIFO order (the pre-dead arrivals first).  Returns
    ``(world, horizon, disruption_end, joins)`` with the horizon the
    last join + ``completeness_bound`` + 24, rounded up to 64, and
    ``joins`` the (slot, round) schedule."""
    n, k = params.n_members, params.n_subjects
    subjects = [c * (n // k) for c in range(k)]
    world = swim.SwimWorld.healthy(
        params, subject_ids=torch.tensor(subjects, dtype=torch.int32),
        device=device)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x10E6]))
    pool = [subjects[int(i)] for i in rng.permutation(k)]
    n_pool = STORM_WAVES * STORM_WAVE_SIZE
    nodes = pool[:n_pool]
    arrivals = pool[n_pool:n_pool + STORM_WAVES * (STORM_JOINS
                                                  - STORM_WAVE_SIZE)]
    wave_every = max(STORM_JOIN_LAG + 2, 16)
    scare_gap = min(params.suspicion_rounds - STORM_SCARE - 2, 14)
    scare_lead = STORM_SCARE + max(scare_gap, 6)
    start = scare_lead + int(rng.integers(4, 11))
    disruption_end = 0
    for w in range(STORM_WAVES):
        at = start + w * wave_every
        for v in nodes[w * STORM_WAVE_SIZE:(w + 1) * STORM_WAVE_SIZE]:
            until = at - scare_lead + STORM_SCARE
            world = world.with_link_fault((0, n), v, 1.0,
                                          from_round=at - scare_lead,
                                          until_round=until)
            disruption_end = max(disruption_end, until)
    world = world.with_crash(arrivals, 0)
    free, joins = [(slot, 0) for slot in arrivals], []
    for w in range(STORM_WAVES):
        at = start + w * wave_every
        wave = nodes[w * STORM_WAVE_SIZE:(w + 1) * STORM_WAVE_SIZE]
        world = world.with_crash(wave, at)
        free += [(slot, at) for slot in wave]
        join_at = at + STORM_JOIN_LAG
        for _ in range(STORM_JOINS):
            if not free or free[0][1] >= join_at:
                raise AssertionError(f"storm wave {w} cannot fill its joins")
            joins.append((free.pop(0)[0], join_at))
    for slot, at in joins:
        world = world.with_join(slot, at)
    last_join = max(at for _, at in joins)
    horizon = -(-(last_join + scenarios.completeness_bound(params, n) + 24)
                // STORM_HORIZON_QUANTUM) * STORM_HORIZON_QUANTUM
    return world, horizon, disruption_end, joins


def storm_world_of(params, device):
    """``storm_world``'s world alone (the canaries' ``make_world``)."""
    return storm_world(params, device)[0]


def joined_unknown(state, world, joins, round_idx):
    """Eligible observer cells (alive at ``round_idx``, continuously since
    the join, not the slot itself) that do not hold a joined slot ALIVE
    at epoch 1 after round ``round_idx``."""
    alive = world.alive_at(round_idx)
    missing = 0
    for slot, at in joins:
        col = int(world.slot_of_node[slot])
        eligible = alive & ~((world.down_from <= round_idx)
                             & (world.down_until > at))
        eligible[slot] = False
        held = ((state.status[:, col] == records.ALIVE)
                & (state.epoch[:, col].to(torch.int32) == 1))
        missing += int((eligible & ~held).sum())
    return missing


def storm_spec(params, known_by, device):
    """The churn storm's monitor spec: the join codes checked against
    ``known_by`` (``monitor.join_deadlines``), no completeness deadline,
    no pristine-network promise."""
    return monitor.MonitorSpec(
        complete_by=torch.full((params.n_subjects,), INT32_MAX,
                               dtype=torch.int32, device=device),
        check_joins=True, join_known_by=known_by)


def codes_of(mon):
    """Every code's violation total of a monitor, by name."""
    return {code: d["violations"]
            for code, d in monitor.verdict(mon)["codes"].items()}


def join_code_counts(mon):
    """The two join codes' totals of a monitor, by name."""
    counts = mon.code_counts.cpu()
    return {code.name: int(counts[code]) for code in JOIN_CODES}


def monitor_launches(params, rounds, layout, records):
    """The launches of a monitored run: the layout's round kernels, two
    more ``carry_decode`` a round under the compact carry (the wide
    decodes of the round's input and output carries the checks read) and
    ``records`` ``trace_record`` a round (its checked codes and two self
    lanes)."""
    want = {name: rounds * blocks_of(params)
            for name in ROUND_KERNELS[layout]}
    if params.compact_carry:
        want[carry.DECODE] += 2 * rounds
    want[trace_kernel.NAME] = records * rounds
    return want


def check_monitor_launches(label, params, launches, rounds, layout,
                           records):
    want = monitor_launches(params, rounds, layout, records)
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches} in "
                             f"{rounds} rounds, want {want}")


def storm_run(device, layout="wide", delivery="shift", guard=True,
              profile=False, join_round=False):
    """One arm of the 1M x 16 churn storm through
    ``chaos.monitor.run_monitored`` (the port's own draws on the card),
    as ``bench.py --churn`` runs it: the monitor checks every round, the
    join codes against the reference's deadlines (``storm_spec``).
    ``profile``: also a profiled window after the storm; ``join_round``:
    and of the last join round.  Returns the params, world, final state,
    metrics, launches and a summary."""
    params = storm_params(MAIN_N, MAIN_K, layout, delivery, guard)
    world, horizon, disruption_end, joins = storm_world(params, device)
    known_by, check = monitor.join_deadlines(params, world, disruption_end)
    if not check:
        raise AssertionError("storm: no join is checkable")
    spec = storm_spec(params, known_by, device)
    last_join = max(at for _, at in joins)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    state, mon, rows, cursor, at_last_join = None, None, [], 0, None
    t0 = time.perf_counter()
    for stop in sorted({last_join, horizon}):
        state, mon, metrics = monitor.run_monitored(
            0, params, world, spec, stop - cursor, state=state,
            start_round=cursor, monitor=mon, device=device)
        rows.append(metrics)
        cursor = stop
        if cursor == last_join and join_round:
            at_last_join = state
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check_monitor_launches(f"storm {layout}", params, launches, horizon,
                           layout, STORM_RECORDS)
    metrics = {name: torch.cat([row[name] for row in rows]).cpu()
               for name in rows[0]}
    joined = [slot for slot, _ in joins]
    summary = dict(
        horizon=horizon, codes=join_code_counts(mon), monitor=mon,
        all_codes=codes_of(mon),
        seconds=seconds, ms_round=seconds / horizon * 1e3, peak=peak,
        joins=joins, joined_self_inc=state.self_inc[joined].tolist(),
        refutations=int(metrics["refutations"].sum()),
        unknown=joined_unknown(state, world, joins, horizon - 1)
        if params.epoch_bits else None)
    if profile:
        summary["window"] = profile_round.profile_window(
            params, world, state, horizon, PROFILE_ROUNDS)
    if join_round:
        summary["join_round"] = profile_round.profile_window(
            params, world, at_last_join, last_join, 1)
        del at_last_join
    arm = "guard" if guard else "naive"
    log(f"[storm] {delivery} {layout} {arm} {MAIN_N}x{MAIN_K}, joins "
        f"{joins}, horizon {horizon} (deadlines {known_by.unique().tolist()}"
        f"), {horizon} rounds in {seconds:.3f} s: "
        f"{summary['ms_round']:.4f} ms/round, peak {peak} B; monitor codes "
        f"every round {summary['all_codes']}; joined rows' self_inc "
        f"{summary['joined_self_inc']}, refutations "
        f"{summary['refutations']}; eligible cells not holding a joined "
        f"slot ALIVE at epoch 1 at the end: {summary['unknown']}")
    return params, world, state, metrics, launches, summary


def storm_path(device, shift_main):
    """The new path: the 1M x 16 churn storm.  The guard arm (shift wide,
    profiled), the naive arm on the same world and draws, the guard arm
    under ``int16_wire`` and compact + ``wire24`` (each equal to the wide
    run's decoded states and metrics exactly), and under scatter
    delivery.  Gates: the guard arms' ``NO_RESURRECTION`` and
    ``JOIN_COMPLETENESS`` are 0 and every eligible observer holds every
    joined slot ALIVE at epoch 1 at the end; the naive arm's
    ``NO_RESURRECTION`` is above 0.  Prints each arm's counts, the joined
    rows' incarnations and refutations, ms/round, peak bytes, and for
    the wide guard arm a profiled window after the storm beside the
    shift wide main path's (``shift_main``) and its last join round."""
    launches = {}

    def add(counts):
        for name, count in counts.items():
            launches[name] = launches.get(name, 0) + count

    def guard_gates(label, summary):
        codes = summary["codes"]
        if any(codes.values()) or summary["unknown"]:
            raise AssertionError(f"storm {label}: codes {codes}, "
                                 f"{summary['unknown']} eligible cells do "
                                 f"not hold a joined slot at epoch 1")

    params, world, state, metrics, counts, wide = storm_run(
        device, profile=True, join_round=True)
    add(counts)
    guard_gates("wide", wide)
    want = {name: value.cpu() for name, value in
            storm_state(state, params, wide["horizon"]).items()}
    del state
    for layout in ("int16_wire", "compact_wire24"):
        p, _, s, m, counts, summary = storm_run(device, layout)
        add(counts)
        guard_gates(layout, summary)
        for name, value in metrics.items():
            if not torch.equal(m[name], value):
                raise AssertionError(f"storm {layout}: metric {name} "
                                     f"differs from the wide run")
        for name, value in storm_state(s, p, wide["horizon"]).items():
            if not torch.equal(value.cpu(), want[name]):
                raise AssertionError(f"storm {layout}: decoded final {name} "
                                     f"differs from the wide run")
        if summary["all_codes"] != wide["all_codes"]:
            raise AssertionError(f"storm {layout}: codes differ")
        log(f"[identity] storm {layout}: per-round metrics, decoded final "
            f"state (epoch lane included) and codes equal the wide run's")
        del s
    _, _, s, _, counts, naive = storm_run(device, guard=False, profile=True)
    add(counts)
    del s
    # At this width a joiner hears its predecessor's records in its join
    # round and outbids them at once, so the incarnation forensics find
    # no ghost at any round (the reference's own per-round monitor counts
    # none either, at 65,536 x 16 on the CPU): the naive hazard shows as
    # the joiners' incarnation burn, the reference's second naive pin
    # (tests/test_open_world.py:384-386).  bench_churn_path holds
    # NO_RESURRECTION > 0 at the reference's bench size.
    if (min(naive["joined_self_inc"]) < 1
            or max(wide["joined_self_inc"]) != 0
            or naive["refutations"] <= wide["refutations"]):
        raise AssertionError(
            f"storm naive: joined rows' self_inc {naive['joined_self_inc']}"
            f" (guard {wide['joined_self_inc']}), refutations "
            f"{naive['refutations']} (guard {wide['refutations']}): the "
            f"epoch-blind arm burns no incarnation")
    _, _, s, _, counts, scatter = storm_run(device, delivery="scatter")
    add(counts)
    guard_gates("scatter", scatter)
    del s
    window, join_round = wide["window"], wide["join_round"]
    main_window, naive_window = shift_main["window"], naive["window"]
    log(f"[storm] guard / naive: NO_RESURRECTION "
        f"{wide['codes']['NO_RESURRECTION']} / "
        f"{naive['codes']['NO_RESURRECTION']}, JOIN_COMPLETENESS "
        f"{wide['codes']['JOIN_COMPLETENESS']} / "
        f"{naive['codes']['JOIN_COMPLETENESS']}; joined rows' self_inc "
        f"{wide['joined_self_inc']} / {naive['joined_self_inc']}; "
        f"refutations {wide['refutations']} / {naive['refutations']}; "
        f"scatter guard {scatter['codes']}, {scatter['ms_round']:.4f} "
        f"ms/round")
    log(f"[storm] wide guard, profiled {PROFILE_ROUNDS} rounds from round "
        f"{wide['horizon']}: device busy "
        f"{window['device_busy_ms_per_round']:.4f} ms/round (naive arm, no "
        f"epoch lane, {naive_window['device_busy_ms_per_round']:.4f}; shift "
        f"wide main path {main_window['device_busy_ms_per_round']:.4f}), "
        f"{window['kernel_launches_per_round']:.2f} kernel launches/round "
        f"(naive {naive_window['kernel_launches_per_round']:.2f}, main "
        f"{main_window['kernel_launches_per_round']:.2f}), wall "
        f"{window['wall_ms_per_round']:.4f} ms/round, idle share "
        f"{window['device_idle_share']:.4f}, phases "
        f"{json.dumps(window['phase_device_ms_per_round'])}, launches "
        f"{json.dumps(window['phase_launches_per_round'])}; naive phases "
        f"{json.dumps(naive_window['phase_device_ms_per_round'])}; the last "
        f"join round ({join_round['start_round']}): busy "
        f"{join_round['device_busy_ms_per_round']:.4f} ms, "
        f"{join_round['kernel_launches_per_round']:.0f} launches, wall "
        f"{join_round['wall_ms_per_round']:.4f} ms, phases "
        f"{json.dumps(join_round['phase_device_ms_per_round'])}, launches "
        f"{json.dumps(join_round['phase_launches_per_round'])}, top kernels "
        f"{json.dumps(join_round['top_kernels'][:8])}")
    return launches


def churn_scenario(seed, n, guard, device):
    """``bench.py --churn``'s workload built by the port's DSL:
    ``chaos.churn_growth_scenario(seed, n)`` under the campaign params
    (shift, the open world, ``epoch_guard=guard``).  Returns the
    scenario, params, world, monitor spec and the (slot, round) joins."""
    scen = scenarios.churn_growth_scenario(seed, n=n)
    params = campaign.campaign_params(scen, delivery="shift",
                                      epoch_guard=guard)
    world, spec = scen.build(params, device=device)
    joins = [(slot, at) for slot, at in enumerate(world.join_at.tolist())
             if at < INT32_MAX]
    return scen, params, world, spec, joins


def bench_churn_path(device):
    """``bench.py --churn``'s own A/B on the card (``bench.py:2911-3090``:
    N = 48, full view, shift, ``churn_growth_scenario(seed, n=48)`` for
    seeds 3, 4 and 5, each run with its seed; :func:`churn_scenario`, the
    port's ``Scenario.build`` and its ``MonitorSpec``) through
    ``chaos.monitor.run_monitored``, both arms, on the card and on the CPU
    with the same CPU-made draws.  Gates: card == CPU (every state lane,
    the whole monitor); the guard arm's join codes 0 and every joined
    slot known at epoch 1 at the end of each scenario; the naive arm's
    ``NO_RESURRECTION`` summed over the scenarios above 0, the hazard the
    guard kills (the bench's gate)."""
    n = 48
    launches, totals = {}, {}
    for seed in (STORM_SEED, STORM_SEED + 1, STORM_SEED + 2):
        for guard in (True, False):
            scen, params, world_cpu, _, joins = churn_scenario(
                seed, n, guard, "cpu")
            horizon = scen.horizon
            draws = prng.TorchDraws(seed, "cpu", params, world_cpu)
            runs = []
            for dev in ("cpu", device):
                _, _, world, spec, _ = churn_scenario(seed, n, guard, dev)
                LAUNCHES.clear()
                state, mon, _ = monitor.run_monitored(
                    seed, params, world, spec, horizon,
                    draws=lambda q: draws(q).to(dev), device=dev)
                runs.append((state, mon, dict(LAUNCHES), world))
            (cs, cmon, _, _), (gs, gmon, g_launches, world) = runs
            label = f"bench churn seed {seed} {'guard' if guard else 'naive'}"
            for field in dataclasses.fields(swim.SwimState):
                if not torch.equal(getattr(cs, field.name),
                                   getattr(gs, field.name).cpu()):
                    raise AssertionError(f"{label}: state.{field.name} "
                                         f"differs between card and CPU")
            monitor_equal(f"{label} card vs CPU", cmon, gmon)
            codes = join_code_counts(gmon)
            check_monitor_launches(label, params, g_launches, horizon,
                                   "wide", STORM_RECORDS)
            for name, count in g_launches.items():
                launches[name] = launches.get(name, 0) + count
            arm = totals.setdefault(guard, {})
            for code, count in codes.items():
                arm[code] = arm.get(code, 0) + count
            unknown = (joined_unknown(gs, world, joins, horizon - 1)
                       if guard else None)
            if guard and (any(codes.values()) or unknown):
                raise AssertionError(f"{label}: codes {codes}, {unknown} "
                                     f"eligible cells do not hold a joined "
                                     f"slot at epoch 1")
            log(f"[bench churn] {label}, {n}x{n} shift, joins {joins}, "
                f"{horizon} rounds: monitor codes every round "
                f"{codes_of(gmon)}"
                f" (card == CPU, every state lane and the monitor); joined "
                f"rows' self_inc "
                f"{gs.self_inc[[slot for slot, _ in joins]].tolist()}")
    if totals[False]["NO_RESURRECTION"] == 0:
        raise AssertionError("bench churn naive: no resurrection counted; "
                             "the epoch-blind arm shows no hazard")
    log(f"[bench churn] summed over seeds 3-5: guard {totals[True]}, naive "
        f"{totals[False]}")
    return launches


def rollout_params(n, sync_interval=ROLLOUT_SYNC_INTERVAL):
    """The rollout's params: the chaos campaign's config, full view,
    shift, no per-round SYNC, one metadata key, the exchange every
    ``sync_interval`` rounds (0: the gossip-only control)."""
    return swim.SwimParams.from_config(
        campaign.campaign_config(), n_members=n, delivery="shift",
        sync_every=0, sync_interval=sync_interval, metadata_keys=1)


def rollout_scenario(n, seed=ROLLOUT_SEED, n_stages=ROLLOUT_STAGES,
                     stage_size=ROLLOUT_STAGE_SIZE,
                     sync_interval=ROLLOUT_SYNC_INTERVAL, device="cpu"):
    """``bench.py --rollout``'s scenario (``bench.py:1836-1870``) built by
    the port's DSL, match-nothing rules included: a revive storm
    (``ChurnStorm`` of 4 nodes, each down ``quiesce_bound`` rounds), one
    quiesced split (``RollingPartition`` over [phase, 2 phase)) and the
    ``StagedRollout`` of ``n_stages`` x ``stage_size`` owners from the
    bench's seeded permutation (the ``--smoke`` takes 2 x 2).  Returns
    ``(scenario, params, world, spec, rollout)``, the params with the
    exchange every ``sync_interval`` rounds (0: the control)."""
    p0 = rollout_params(n)
    quiesce = scenarios.quiesce_bound(p0, n)
    phase = -(-quiesce // 16) * 16
    bound = scenarios.metadata_convergence_bound(p0, n)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x19C0]))
    perm = [int(x) for x in rng.permutation(n)]
    storm = scenarios.ChurnStorm(
        nodes=tuple(perm[:ROLLOUT_STORM]), wave_size=ROLLOUT_WAVE,
        start_round=ROLLOUT_STORM_START, wave_every=ROLLOUT_WAVE_EVERY,
        down_rounds=quiesce)
    rollout = scenarios.StagedRollout(
        members=tuple(perm[ROLLOUT_STORM:ROLLOUT_STORM
                           + n_stages * stage_size]),
        n_stages=n_stages, key=0, value=ROLLOUT_VALUE,
        start_round=phase + phase // 2,
        stage_every=-(-bound // 16) * 16, rollback_value=7)
    rollout.validate_gate(p0, n)
    last_stage = rollout.stage_round(n_stages - 1)
    horizon = -(-(max(last_stage, 2 * phase) + bound + 32) // 64) * 64
    scen = scenarios.Scenario(
        name=f"config-rollout-n{n}", n_members=n, horizon=horizon,
        ops=(storm, scenarios.RollingPartition(
            from_round=phase, phase_rounds=phase, n_cycles=1), rollout),
        seed=seed)
    params = campaign.campaign_params(scen, delivery="shift", sync_every=0,
                                      sync_interval=sync_interval)
    world, spec = scen.build(params, device=device)
    return scen, params, world, spec, rollout


def rollout_world(n, device, seed=ROLLOUT_SEED, n_stages=ROLLOUT_STAGES,
                  stage_size=ROLLOUT_STAGE_SIZE):
    """The staged rollout's world (:func:`rollout_scenario`) and its
    geometry: the horizon, the split, the convergence bound, the storm
    nodes and the pushes (owner, key, value, round, clock start, deadline;
    a push inside the split starts its clock at the heal)."""
    scen, params, world, _, rollout = rollout_scenario(
        n, seed, n_stages, stage_size, device=device)
    split = scen.ops[1]
    split_at, heal_at = split.from_round, 2 * split.phase_rounds
    bound = scenarios.metadata_convergence_bound(params, n)
    pushes = []
    for owner, key, value, at in rollout.push_schedule():
        clock = heal_at if split_at <= at < heal_at else at
        pushes.append(dict(owner=owner, key=key, value=value, push_round=at,
                           clock_from=clock, deadline=clock + bound))
    return world, dict(horizon=scen.horizon, split_at=split_at,
                       heal_at=heal_at, bound=bound,
                       storm=list(scen.ops[0].nodes), pushes=pushes)


def rollout_gated(params, world, geo, device, draws=None, aside=None,
                  keep_metrics=False):
    """The gated arm of ``bench.py --rollout`` (``bench.py:1889-1961``):
    the run in segments of ``ROLLOUT_PROBE_STEP`` rounds; after each, the
    open pushes' owner columns ``md[:, owner, key]`` are read on the
    device, and a push has converged when every observer alive at the
    segment's last round holds its value.  A push past its deadline
    unconverged raises (the rollback is not ported).  Once all have
    converged the rest runs in one call.  ``aside``: ``(round, fn)``, with
    ``fn(state, round)`` called at that round off the arm's clock, launch
    counts and peak memory (the profiled windows).  Returns ``(state,
    summary)``: converged rounds, p99 from the clock starts, the final
    divergence probe, host seconds, launches, peak bytes, what ``fn``
    returned and (``keep_metrics``) the per-round metrics."""
    horizon = geo["horizon"]
    pushes = [dict(p, converged_at=None) for p in geo["pushes"]]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    state, r, rows, window, peak, seconds = None, 0, [], None, 0, 0.0
    t0 = time.perf_counter()
    while r < horizon:
        if aside is not None and r == aside[0]:
            torch.cuda.synchronize()
            seconds += time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            launches = dict(LAUNCHES)
            window = aside[1](state, r)
            LAUNCHES.clear()
            LAUNCHES.update(launches)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
        open_pushes = [p for p in pushes if p["converged_at"] is None]
        step = (min(ROLLOUT_PROBE_STEP, horizon - r) if open_pushes
                else horizon - r)
        if aside is not None and r < aside[0]:
            step = min(step, aside[0] - r)
        state, metrics = swim.run(ROLLOUT_SEED, params, world, step,
                                  state=state, start_round=r, draws=draws,
                                  device=device)
        if keep_metrics:
            rows.append(metrics)
        r += step
        due = [p for p in open_pushes if p["push_round"] < r]
        if due:
            alive = world.alive_at(r - 1)
            owners = torch.tensor([p["owner"] for p in due],
                                  device=state.md.device)
            held = metadata.word_value(state.md[:, owners, 0])
            want = torch.tensor([p["value"] for p in due],
                                device=state.md.device)
            done = ((held == want) | ~alive[:, None]).all(dim=0).tolist()
            for p, ok in zip(due, done):
                if ok:
                    p["converged_at"] = r
        late = [p for p in pushes
                if p["converged_at"] is None and r >= p["deadline"]]
        if late:
            raise AssertionError(f"rollout {params.n_members}: push(es) "
                                 f"{late} past their deadline unconverged")
    if any(p["converged_at"] is None for p in pushes):
        raise AssertionError(f"rollout {params.n_members}: push(es) "
                             f"unconverged at the horizon")
    final_div = int(metadata.divergence_probe(state, params, world,
                                              horizon))
    if on_card:
        torch.cuda.synchronize()
        peak = max(peak, torch.cuda.max_memory_allocated())
    seconds += time.perf_counter() - t0
    lats = [p["converged_at"] - p["clock_from"] for p in pushes]
    summary = dict(
        converged_at=[p["converged_at"] for p in pushes],
        p99=float(np.percentile(lats, 99)), final_div=final_div,
        seconds=seconds, launches=dict(LAUNCHES), peak=peak, window=window)
    if keep_metrics:
        summary["metrics"] = {name: torch.cat([m[name] for m in rows])
                              for name in rows[0]}
    return state, summary


def rollout_path(device):
    """The staged config rollout at full view N = K = ``ROLLOUT_N`` (its
    geometry, ``rollout_world``): the gated arm, every push converging
    inside its deadline and the divergence probe 0 at the horizon, with a
    profiled window from the first stage's push round (inside the split);
    then the gossip-only control (``sync_interval=0``), still divergent at
    the horizon.  Each arm launches the merge kernel once a round.  At
    that round the same window is also profiled with the plane
    off (the state without its md lanes, ``metadata_keys=0``): the
    difference in ``swim.delivery`` is the md channels' device time.
    Prints the p99, the control's divergent cells, each arm's ms/round,
    member-rounds/s, peak bytes and bytes per cell (the windows off the
    gated arm's peak), the windows' device time per phase range, and
    the plane's share of device busy time."""
    n = ROLLOUT_N
    params = rollout_params(n)
    world, geo = rollout_world(n, device)
    horizon = geo["horizon"]
    start = geo["pushes"][0]["push_round"]
    plane_off = dataclasses.replace(params, metadata_keys=0)

    def windows(state, r):
        """The window with the plane on, then off (md lanes dropped)."""
        on = profile_round.profile_window(params, world, state, r,
                                          PROFILE_ROUNDS)
        bare = dataclasses.replace(
            state, **metadata.initial_lanes(plane_off, device))
        return on, profile_round.profile_window(plane_off, world, bare, r,
                                                PROFILE_ROUNDS)

    state, gated = rollout_gated(params, world, geo, device,
                                 aside=(start, windows))
    del state
    check_launches("rollout gated", params, gated["launches"], horizon,
                   "wide")
    if gated["final_div"]:
        raise AssertionError(f"rollout: {gated['final_div']} divergent "
                             f"cells at the horizon")
    control = rollout_params(n, sync_interval=0)
    c_state, _, c_seconds, c_launches, c_peak = timed_run(
        control, world, horizon, device, seed=ROLLOUT_SEED)
    check_launches("rollout control", control, c_launches, horizon, "wide")
    c_div = int(metadata.divergence_probe(c_state, control, world, horizon))
    del c_state
    if c_div == 0:
        raise AssertionError("rollout: the gossip-only control converged")
    window, off = gated["window"]
    log(f"[rollout] {n}x{n} shift wide, split [{geo['split_at']}, "
        f"{geo['heal_at']}), storm {geo['storm']}, pushes at rounds "
        f"{sorted({p['push_round'] for p in geo['pushes']})}, bound "
        f"{geo['bound']}, horizon {horizon}: all "
        f"{len(geo['pushes'])} pushes converged at rounds "
        f"{gated['converged_at']} (deadlines "
        f"{[p['deadline'] for p in geo['pushes']]}), "
        f"metadata_convergence_p99 {gated['p99']} rounds from the clock "
        f"start, final divergent cells {gated['final_div']}")
    for label, seconds, peak in (
            (f"gated (probe every {ROLLOUT_PROBE_STEP})", gated["seconds"],
             gated["peak"]), ("control", c_seconds, c_peak)):
        log(f"[rollout] {label}: {horizon} rounds in {seconds:.3f} s, "
            f"{seconds / horizon * 1e3:.4f} ms/round, "
            f"{n * horizon / seconds:.6g} member-rounds/s, peak {peak} B, "
            f"{peak / n ** 2:.4f} B/cell")
    log(f"[rollout] gossip-only control: divergent cells at round "
        f"{horizon}: {c_div}")
    log(f"[rollout] profiled {PROFILE_ROUNDS} rounds from round "
        f"{window['start_round']}: device busy "
        f"{window['device_busy_ms_per_round']:.4f} ms/round, wall "
        f"{window['wall_ms_per_round']:.4f} ms/round, idle share "
        f"{window['device_idle_share']:.4f}, "
        f"{window['kernel_launches_per_round']:.2f} kernel launches/round, "
        f"phases {json.dumps(window['phase_device_ms_per_round'])}, "
        f"launches {json.dumps(window['phase_launches_per_round'])}, top "
        f"kernels {json.dumps(window['top_kernels'][:8])}")
    phases, phases_off = (w["phase_device_ms_per_round"]
                          for w in (window, off))
    md_channels = phases["swim.delivery"] - phases_off["swim.delivery"]
    md_ms = phases.get("swim.metadata", 0.0) + md_channels
    busy, busy_off = (w["device_busy_ms_per_round"] for w in (window, off))
    log(f"[rollout] the same window with the plane off (metadata_keys=0, "
        f"md lanes dropped): device busy "
        f"{off['device_busy_ms_per_round']:.4f} ms/round, wall "
        f"{off['wall_ms_per_round']:.4f}, "
        f"{off['kernel_launches_per_round']:.2f} launches/round, phases "
        f"{json.dumps(phases_off)}; the md channels "
        f"{md_channels:.4f} ms of swim.delivery, swim.metadata "
        f"{phases.get('swim.metadata', 0.0):.4f} ms: the plane "
        f"{md_ms:.4f} ms, {md_ms / busy:.4f} of device busy (plane on "
        f"minus off {busy - busy_off:.4f} ms)")
    launches = dict(gated["launches"])
    for name, count in c_launches.items():
        launches[name] = launches.get(name, 0) + count
    return launches


def bench_rollout_path(device):
    """The rollout at ``bench.py --rollout``'s own size (N = 48, its
    scenario built by the DSL, padded) on the card and on the CPU with the
    same CPU-made draws, its three arms: the monitored composite (bench
    Arm 1, ``run_monitored`` with the scenario's ``MonitorSpec``), the
    gated rollout and the gossip-only control.  Gates: card == CPU (every
    state lane, every per-round metric, the whole monitor, the converged
    rounds, the probes), the monitored arm green (as the reference's
    committed run), every push inside its deadline, the gated arm's
    probe 0 and the control's above 0.  Prints the p99 and the control's
    count beside the reference's committed ones (its own draws differ, so
    they are compared, not gated)."""
    n = ROLLOUT_BENCH_N
    launches, results = {}, {}
    scen, params, world_cpu, _, _ = rollout_scenario(n)
    draws = prng.TorchDraws(ROLLOUT_SEED, "cpu", params, world_cpu)
    runs = []
    for dev in ("cpu", device):
        _, _, world, spec, _ = rollout_scenario(n, device=dev)
        LAUNCHES.clear()
        state, mon, _ = monitor.run_monitored(
            ROLLOUT_SEED, params, world, spec, scen.horizon,
            draws=lambda q: draws(q).to(dev), device=dev)
        runs.append((state, mon, dict(LAUNCHES)))
    (cs, cmon, _), (gs, gmon, m_launches) = runs
    label = f"bench rollout monitored {n}x{n}"
    for field in dataclasses.fields(swim.SwimState):
        if not torch.equal(getattr(cs, field.name),
                           getattr(gs, field.name).cpu()):
            raise AssertionError(f"{label}: state.{field.name} differs "
                                 f"between card and CPU")
    monitor_equal(f"{label} card vs CPU", cmon, gmon)
    m_verdict = monitor.verdict(gmon)
    if not m_verdict["green"]:
        raise AssertionError(f"{label}: red, codes {codes_of(gmon)}")
    for name, count in m_launches.items():
        launches[name] = launches.get(name, 0) + count
    log(f"[bench rollout] monitored arm {n}x{n}, horizon {scen.horizon}, "
        f"{world_cpu.faults.n_rules} link rules (match-nothing padding), "
        f"agreement checked from round {int(spec.agree_from)}: green, codes "
        f"{codes_of(gmon)} (card == CPU, every state lane and the "
        f"monitor; the reference's committed run: monitored_green true); "
        f"launches {m_launches}")
    for arm, sync_interval in (("gated", ROLLOUT_SYNC_INTERVAL),
                               ("control", 0)):
        params = rollout_params(n, sync_interval)
        world_cpu, geo = rollout_world(n, "cpu")
        draws = prng.TorchDraws(ROLLOUT_SEED, "cpu", params, world_cpu)
        runs = []
        for dev in ("cpu", device):
            world = rollout_world(n, dev)[0]
            dev_draws = (draws if dev == "cpu"
                         else lambda q: draws(q).to(device))
            if arm == "gated":
                state, summary = rollout_gated(params, world, geo, dev,
                                               draws=dev_draws,
                                               keep_metrics=True)
            else:
                LAUNCHES.clear()
                state, metrics = swim.run(ROLLOUT_SEED, params, world,
                                          geo["horizon"], draws=dev_draws,
                                          device=dev)
                summary = dict(metrics=metrics, launches=dict(LAUNCHES),
                               final_div=int(metadata.divergence_probe(
                                   state, params, world, geo["horizon"])))
            runs.append((state, summary))
        (cs, c_sum), (gs, g_sum) = runs
        label = f"bench rollout {arm} {n}x{n}"
        for field in dataclasses.fields(swim.SwimState):
            if not torch.equal(getattr(cs, field.name),
                               getattr(gs, field.name).cpu()):
                raise AssertionError(f"{label}: state.{field.name} differs "
                                     f"between card and CPU")
        for name, value in c_sum["metrics"].items():
            if not torch.equal(value, g_sum["metrics"][name].cpu()):
                raise AssertionError(f"{label}: metric {name} differs "
                                     f"between card and CPU")
        for key in ("converged_at", "final_div"):
            if c_sum.get(key) != g_sum.get(key):
                raise AssertionError(f"{label}: {key} {g_sum.get(key)} on "
                                     f"the card, {c_sum.get(key)} on the CPU")
        check_launches(label, params, g_sum["launches"], geo["horizon"],
                       "wide")
        for name, count in g_sum["launches"].items():
            launches[name] = launches.get(name, 0) + count
        results[arm] = g_sum
    if results["gated"]["final_div"] or results["control"]["final_div"] == 0:
        raise AssertionError(
            f"bench rollout: final divergent cells "
            f"{results['gated']['final_div']} gated, "
            f"{results['control']['final_div']} control")
    log(f"[bench rollout] {n}x{n}, horizon {geo['horizon']}, card == CPU "
        f"(every state lane, per-round metric, converged round): pushes "
        f"converged at rounds {results['gated']['converged_at']}, "
        f"metadata_convergence_p99 {results['gated']['p99']} rounds "
        f"(reference's committed run {ROLLOUT_REFERENCE_P99}), final "
        f"divergent cells 0; gossip-only control "
        f"{results['control']['final_div']} divergent cells (reference "
        f"{ROLLOUT_REFERENCE_CONTROL})")
    return launches


def storm_state(state, params, cursor):
    """The storm's final state as absolute int32 planes (``decoded``'s
    rule at ``cursor``) with the epoch lane."""
    deadline, spread = swim._wide_timer_fields(state, params, cursor)
    return dict(status=state.status, inc=state.inc.to(torch.int32),
                spread_until=torch.clamp(spread, min=cursor),
                suspect_deadline=deadline, self_inc=state.self_inc,
                epoch=state.epoch.to(torch.int32))


def merge_ab(device, baseline):
    """``--merge-baseline PATH``: the plane-off, epoch-free merge at 1M x
    16 against an earlier ``merge_timers.cu`` at ``PATH`` (PR 8's entry
    points: the armed rounds but no epoch arguments, ten row strides),
    built with the same flags, on the same planes: exact, then timed in
    turns (earlier, this, this, earlier) on the device clock
    (:func:`device_ms`), each side launched through its bare entry
    point, for each instance."""
    out = _build.BUILD_DIR / "libmerge_timers_baseline.so"
    _build.BUILD_DIR.mkdir(exist_ok=True)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    baseline], check=True, capture_output=True, text=True,
                   timeout=600)
    lib = ctypes.CDLL(str(out))
    for layout in ("wide", "int16_wire", "compact_wire24"):
        params = profile_round.bench_params(layout, MAIN_N, MAIN_K)
        fmt, cap = params.wire_format, swim._wire_inc_sat(params)
        planes = list(merge_planes(MAIN_N, MAIN_K, seed=1, device=device,
                                   fmt=fmt, cap=cap).values())
        scalars = [37, params.suspicion_rounds, params.periods_to_spread, cap]
        mine = merge.merge_and_timers(*planes, *scalars, fmt=fmt)
        outs = [torch.empty_like(t) for t in mine]
        strides = merge._check(fmt, planes[:6], outs[:4], *planes[6:], None)
        fn = getattr(lib, "merge_and_timers_launch" if fmt.name == "wide"
                     else f"merge_and_timers_{fmt.name}_launch")
        fn.argtypes = ([ctypes.c_void_p] * 16
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        earlier_ptrs = ([t.data_ptr() for t in planes] + [None]
                        + [t.data_ptr() for t in outs])
        earlier_strides = (ctypes.c_longlong * 10)(*strides[:10])

        def earlier():
            err = fn(*earlier_ptrs, MAIN_N, MAIN_K, 0, earlier_strides,
                     *scalars, 0,
                     torch.cuda.current_stream(device).cuda_stream)
            if err:
                raise RuntimeError(f"baseline launch failed: {err}")

        this_fn = merge._launcher(fmt.name)
        this_ptrs = ([t.data_ptr() for t in planes] + [None, None, None]
                     + [t.data_ptr() for t in outs] + [None])
        this_strides = (ctypes.c_longlong * 12)(*strides)

        def this():
            err = this_fn(*this_ptrs, MAIN_N, MAIN_K, 0, this_strides,
                          *scalars, 0,
                          torch.cuda.current_stream(device).cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")

        for fn_ in (earlier, this):
            for t in outs:
                t.fill_(-3)
            fn_()
            torch.cuda.synchronize()
            max_abs_err(f"{merge.NAMES[fmt.name]} against the baseline",
                        outs, mine)
        turns = [(label, device_ms(fn_)) for label, fn_ in
                 (("earlier", earlier), ("this", this), ("this", this),
                  ("earlier", earlier))]
        log(f"[merge A/B] {merge.NAMES[fmt.name]} {MAIN_N}x{MAIN_K}, plane "
            f"off, epoch-free, same planes and outputs as the baseline at "
            f"{baseline}: "
            + ", ".join(f"{label} {ms:.4f} ms" for label, ms in turns))


# --------------------------------------------------------------------------
# The membership event trace (telemetry/trace, kernels/trace)
# --------------------------------------------------------------------------


def trace_planes(density, seed, device):
    """Seeded [1M, 16] code planes (event types 1-6 at ``density``) and
    event incarnations on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (MAIN_N, MAIN_K)
    kinds = torch.randint(1, 7, shape, generator=g, device=device,
                          dtype=torch.int32)
    codes = torch.where(torch.rand(shape, generator=g, device=device)
                        < density, kinds, 0).to(torch.int8)
    incs = torch.randint(0, 1 << 20, shape, generator=g, device=device,
                         dtype=torch.int32)
    return codes, incs


def trace_buffer(start, capacity, device):
    """A [capacity, 5] buffer with ``start`` seeded rows already recorded
    and 5 drops counted: ``(lanes, count, dropped)``."""
    lanes = torch.full((capacity, trace_kernel.N_LANES), -1,
                       dtype=torch.int32, device=device)
    lanes[:start] = torch.randint(0, 1 << 20, (start, trace_kernel.N_LANES),
                                  device=device, dtype=torch.int32)
    return (lanes, torch.tensor(start, dtype=torch.int32, device=device),
            torch.tensor(5, dtype=torch.int32, device=device))


def trace_subjects(device, offset=0):
    """The 16 subjects at ``arange(16) * (N // 16) + offset``: observer
    row ``c * N // 16`` holds subject c's self cell."""
    return (torch.arange(MAIN_K, dtype=torch.int32, device=device)
            * (MAIN_N // MAIN_K) + offset)


def record_inputs(density, start, capacity, seed, device):
    """One record case: ``(codes, incs, subject_ids, lanes, count,
    dropped)``."""
    codes, incs = trace_planes(density, seed, device)
    return (codes, incs, trace_subjects(device))  \
        + trace_buffer(start, capacity, device)


def record_bytes(codes, recorded, events):
    """The bytes a codes-in record must move: the codes in full, the
    incarnation at each event cell, 20 B per recorded row and the two
    counters read and written."""
    return (codes.numel() + events * 4 + recorded * 4 * trace_kernel.N_LANES
            + 16)


def record_call(args, round_idx=TRACE_RECORD_ROUND):
    codes, incs, sids, lanes, count, dropped = args
    return lambda: trace_kernel.trace_record(
        lanes, count, dropped, codes, incs, sids, round_idx)


def record_plain(args, round_idx=TRACE_RECORD_ROUND):
    codes, incs, sids, lanes, count, dropped = args
    return lambda: trace_kernel.trace_record_reference(
        lanes, count, dropped, codes, incs, sids, round_idx, 0)


def check_counters(name, label, start, cap, total, count, dropped):
    """Raise unless ``count``/``dropped`` moved as a record of ``total``
    events from ``start`` of ``cap`` rows (5 drops before) must."""
    if count != min(start + total, cap) or \
            dropped != 5 + start + total - count:
        raise AssertionError(f"{name} {label}: count {count}, dropped "
                             f"{dropped} for {total} events from {start} "
                             f"of {cap}")


def reaches_edge(label, start, cap, total, count, dropped, cells):
    """Whether a record case reached the edge its label names."""
    return {"dense": count == start + total and total > cells // 2,
            "sparse": 0 < total < cap - start,
            "overflow": start < cap and start + total > cap,
            "one below capacity": count == cap and total > 1,
            "at capacity": start == cap and dropped == 5 + total}.get(
                label, count == start + total and total > 0)


def check_trace_record(device):
    """Phase 3b, the codes-in record (``record_events``' kernel) against
    its plain version at 1M x 16 on seeded code planes: a dense round
    (every event fits), a sparse round, a round that overflows the
    capacity partway, a start count one below the capacity and at it;
    lanes, count and dropped exact and each case checked to reach its
    edge.  Then the sparse round (a traced round's shape) timed into a
    buffer it never fills, on the device clock and on CUDA events, and
    the dense one on the device clock with the count reset before each
    call."""
    for label, density, start, capacity in TRACE_RECORD_CASES:
        cap = MAIN_N * MAIN_K if capacity is None else capacity
        got = record_inputs(density, start, cap, 9, device)
        want = tuple(t.clone() for t in got)
        record_call(got)()
        record_plain(want)()
        torch.cuda.synchronize()
        max_abs_err(f"trace_record {label}", got[3:], want[3:])
        total = int((got[0] > 0).sum())
        count, dropped = int(got[4]), int(got[5])
        check_counters("trace_record", label, start, cap, total, count,
                       dropped)
        if not reaches_edge(label, start, cap, total, count, dropped,
                            got[0].numel()):
            raise AssertionError(f"trace_record {label}: the case does not "
                                 f"reach its edge ({total} events)")
        log(f"[kernel] trace_record {label} {MAIN_N}x{MAIN_K}: exact match "
            f"(lanes, count, dropped), {total} events, {start} -> {count} "
            f"of {cap} rows, dropped {dropped}")

    def timed(density, seed, reset):
        args = record_inputs(density, 0, MAIN_N * MAIN_K, seed, device)
        events = int((args[0] > 0).sum())
        return timed_trace(record_call(args), record_plain(args), args[4],
                           reset, events,
                           record_bytes(args[0], events, events),
                           OPS_PER_CELL["trace_record"])

    return trace_row("trace_record", timed)


def timed_trace(kernel, plain, count, reset, events, n_bytes, ops_per_cell):
    """A trace kernel's times on one seeded round: the device clock (and,
    unless ``reset``, CUDA events) for the kernel and its plain version;
    with ``reset`` the count is zeroed before each call (a dense round
    into a buffer it would fill), a fill kernel inside the device time.
    The byte bound is ``n_bytes``, the operation bound
    ``ops_per_cell`` at 1M x 16."""
    if reset:
        kernel_fn, plain_fn = kernel, plain

        def kernel():
            count.zero_()
            kernel_fn()

        def plain():
            count.zero_()
            plain_fn()
    return dict(events=events, ms=device_ms(kernel),
                events_ms=None if reset else time_ms(kernel),
                plain_ms=device_ms(plain),
                plain_events_ms=None if reset else time_ms(plain, inner=2),
                bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3,
                ops_ms=MAIN_N * MAIN_K * ops_per_cell / OPS_PER_S * 1e3)


def trace_row(name, timed):
    """Time a trace kernel's sparse and dense rounds (``timed(density,
    seed, reset)``), log them and return its kernels-line fields: the
    sparse round's as the row's own, the dense round's as ``dense_*``."""
    sparse = timed(TRACE_SPARSE_DENSITY, 10, False)
    dense = timed(TRACE_DENSE_DENSITY, 11, True)
    for label, row in (("sparse", sparse), ("dense", dense)):
        events = ("" if row["events_ms"] is None else
                  f", CUDA events {row['events_ms']:.4f} ms (plain "
                  f"{row['plain_events_ms']:.4f})")
        log(f"[kernel] {name} {label} {MAIN_N}x{MAIN_K} "
            f"({row['events']} events): device clock {row['ms']:.4f} ms "
            f"(plain {row['plain_ms']:.4f}){events}, bound "
            f"{row['bound_ms']:.4f} ms (bytes; operations "
            f"{row['ops_ms']:.4f}), {row['bound_ms'] / row['ms']:.3f} of "
            f"the byte bound")
    return dict(max_abs_err=0, ms=sparse["ms"], plain_ms=sparse["plain_ms"],
                bound_ms=max(sparse["bound_ms"], sparse["ops_ms"]),
                bound_by=("bytes" if sparse["bound_ms"] >= sparse["ops_ms"]
                          else "operations"),
                library_ms=None, events_ms=sparse["events_ms"],
                events_per_call=sparse["events"],
                dense_events_per_call=dense["events"], dense_ms=dense["ms"],
                dense_plain_ms=dense["plain_ms"],
                dense_bound_ms=max(dense["bound_ms"], dense["ops_ms"]))


def observe_inputs(density, start, capacity, seed, device, inc_dtype,
                   epoch_dtype=None, offset=0):
    """One observe case at 1M x 16 on the card: ``(kwargs of
    trace_observe, its in-place outputs)``.  The prev carry holds random
    statuses on 30 % of its cells (ALIVE elsewhere); the new carry
    changes a ``density`` share of cells to another status, and each
    subject's self cell from ALIVE to SUSPECT (which must code nothing);
    with an epoch lane, ``density / 2`` of the cells advance their
    epoch.  Half the subjects' self rows leave this round, one of them
    at ``self_inc`` INT32_MAX (the incarnation wraps), as do 64 rows that
    hold no self cell.  The first-round matrices hold INT32_MAX on half
    their cells and earlier rounds elsewhere."""
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (MAIN_N, MAIN_K)

    def rand():
        return torch.rand(shape, generator=g, device=device)

    def randint(lo, hi, size=shape, dtype=torch.int32):
        return torch.randint(lo, hi, size, generator=g, device=device,
                             dtype=dtype)

    prev = torch.where(rand() < 0.3, randint(0, 4), records.ALIVE)
    new = torch.where(rand() < density, (prev + randint(1, 4)) % 4, prev)
    sids = trace_subjects(device, offset)
    self_rows = (sids - offset).long()
    cols = torch.arange(MAIN_K, device=device)
    prev[self_rows, cols] = records.ALIVE
    new[self_rows, cols] = records.SUSPECT
    hi = 1 << (15 if inc_dtype == torch.int16 else 30)
    kw = dict(prev_status=prev.to(torch.int8), new_status=new.to(torch.int8),
              new_inc=randint(-hi, hi, dtype=inc_dtype),
              self_inc=randint(0, 1 << 30, (MAIN_N,)),
              leave_at=torch.full((MAIN_N,), INT32_MAX, dtype=torch.int32,
                                  device=device),
              subject_ids=sids, round_idx=TRACE_RECORD_ROUND,
              observer_offset=offset)
    kw["leave_at"][self_rows[::2]] = TRACE_RECORD_ROUND
    kw["leave_at"][randint(0, MAIN_N, (64,)).long()] = TRACE_RECORD_ROUND
    kw["self_inc"][self_rows[0]] = INT32_MAX
    if epoch_dtype is not None:
        prev_epoch = randint(0, 1000, dtype=epoch_dtype)
        kw["prev_epoch"] = prev_epoch
        kw["new_epoch"] = (prev_epoch + (rand() < density / 2)).to(
            epoch_dtype)
    lanes, count, dropped = trace_buffer(start, capacity, device)
    outs = dict(lanes=lanes, count=count, dropped=dropped,
                first_suspect=torch.where(rand() < 0.5, INT32_MAX,
                                          randint(0, 30)),
                first_removed=torch.where(rand() < 0.5, INT32_MAX,
                                          randint(0, 30)))
    return kw, outs


def observe_call(kw, outs):
    return lambda: trace_kernel.trace_observe(**outs, **kw)


def observe_plain(kw, outs):
    return lambda: trace_kernel.trace_observe_reference(**outs, **kw)


def observe_codes(kw):
    """The plain derivation's codes of an observe case."""
    sids, offset = kw["subject_ids"], kw["observer_offset"]
    is_self = trace_kernel.self_mask(sids, MAIN_N, offset)
    leaving = (kw["leave_at"] == kw["round_idx"])[:, None] & is_self
    codes, _ = trace_kernel.derive_event_codes(
        kw["prev_status"], None, kw["new_status"], kw["new_inc"], is_self,
        leaving, kw["self_inc"], kw.get("prev_epoch"), kw.get("new_epoch"))
    return codes


def observe_bytes(kw, codes, recorded):
    """The bytes an observe must move: both status planes, the epoch
    planes when on, the subjects and ``leave_at`` at their self rows; per
    event its incarnation, 20 B per recorded row, a first-round read and
    write at each SUSPECTED or REMOVED cell; the two counters."""
    cells = codes.numel()
    events = int((codes > 0).sum())
    stamps = int(((codes == 2) | (codes == 4)).sum())
    epoch = kw.get("prev_epoch")
    return (2 * cells + (0 if epoch is None else 2 * epoch.element_size()
                         * cells)
            + 8 * MAIN_K + events * kw["new_inc"].element_size()
            + recorded * 4 * trace_kernel.N_LANES + stamps * 8 + 16)


def check_trace_observe(device):
    """Phase 3b, the traced round's fused observe (``trace_observe``)
    against its plain version (the eager derivation, the first-round
    stamps, the record) at 1M x 16 on seeded prev/new carries
    (``observe_inputs``): the wide carry, an int32 epoch lane, the
    compact carry's int16 incarnations with an int16 epoch lane, leave
    rows under an observer offset, then dense, sparse, overflowing, one
    below capacity and at capacity; lanes, count, dropped, first_suspect
    and first_removed exact, each case checked to reach its edge (JOINED
    rows with an epoch lane, LEAVING rows at the leavers' self cells with
    their wrapped incarnation, no row at any other self cell).  Then the
    sparse and dense rounds timed as the codes-in record's are."""
    for label, density, start, capacity, inc, epoch, offset in \
            TRACE_OBSERVE_CASES:
        cap = MAIN_N * MAIN_K if capacity is None else capacity
        kw, got = observe_inputs(density, start, cap, 9, device, inc, epoch,
                                 offset)
        want = {k: v.clone() for k, v in got.items()}
        before = got["first_suspect"].clone()
        observe_call(kw, got)()
        observe_plain(kw, want)()
        torch.cuda.synchronize()
        names = ("lanes", "count", "dropped", "first_suspect",
                 "first_removed")
        max_abs_err(f"trace_observe {label}", [got[n] for n in names],
                    [want[n] for n in names])
        codes = observe_codes(kw)
        total = int((codes > 0).sum())
        count, dropped = int(got["count"]), int(got["dropped"])
        check_counters("trace_observe", label, start, cap, total, count,
                       dropped)
        rows = got["lanes"][start:count].cpu()
        types = collections.Counter(rows[:, 3].tolist())
        leaving = rows[rows[:, 3] == int(TraceEventType.LEAVING)]
        on_self = int((rows[:, 1] == rows[:, 2]).sum())
        stamped = int((got["first_suspect"] != before).sum())
        edge = reaches_edge(label, start, cap, total, count, dropped,
                            codes.numel()) and stamped > 0
        if label in ("wide", "leave rows, offset"):
            edge = edge and len(leaving) == MAIN_K // 2 \
                and on_self == len(leaving) \
                and INT32_MIN in leaving[:, 4].tolist()
        if epoch is not None:
            edge = edge and types[int(TraceEventType.JOINED)] > 0
        if not edge:
            raise AssertionError(
                f"trace_observe {label}: the case does not reach its edge "
                f"({total} events, types {dict(types)}, {len(leaving)} "
                f"LEAVING, {on_self} rows on self cells, {stamped} "
                f"first-suspect stamps)")
        log(f"[kernel] trace_observe {label} {MAIN_N}x{MAIN_K} (inc "
            f"{inc}, epoch {epoch}, offset {offset}): exact match (lanes, "
            f"count, dropped, first_suspect, first_removed), {total} "
            f"events, {start} -> {count} of {cap} rows, dropped {dropped}, "
            f"recorded types {dict(sorted(types.items()))}, "
            f"{stamped} first-suspect stamps")

    def timed(density, seed, reset):
        kw, outs = observe_inputs(density, 0, MAIN_N * MAIN_K, seed, device,
                                  torch.int32)
        codes = observe_codes(kw)
        events = int((codes > 0).sum())
        return timed_trace(observe_call(kw, outs), observe_plain(kw, outs),
                           outs["count"], reset, events,
                           observe_bytes(kw, codes, events),
                           OPS_PER_CELL["trace_observe"])

    return trace_row("trace_observe", timed)


def traced_world(params, device):
    """The traced canaries' world: node 3 crashed at round 10, node 5
    leaving at round 30."""
    return crash_world(params, device).with_leave(TRACE_LEAVER,
                                                  TRACE_LEAVE_AT)


def traced_join_world(params, device):
    """``traced_world`` with node 3 rejoining at round 60."""
    return traced_world(params, device).with_join(CRASHED, NETWORK_JOIN_AT)


def telemetry_equal(label, a, b):
    """Raise unless two ``TelemetryState``s hold the same lanes, counters
    and first-round matrices."""
    for name, x, y in (("lanes", a.trace.lanes, b.trace.lanes),
                       ("count", a.trace.count, b.trace.count),
                       ("dropped", a.trace.dropped, b.trace.dropped),
                       ("first_suspect", a.first_suspect, b.first_suspect),
                       ("first_removed", a.first_removed, b.first_removed)):
        if not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"{label}: trace {name} differs")


def traced_run(params, make_world, capacity, dev, seed=5):
    """One traced canary run on ``dev`` with the CPU-made draws:
    ``(state, telemetry, metrics, launches)``."""
    draws = prng.TorchDraws(seed, "cpu", params, make_world(params, "cpu"))
    LAUNCHES.clear()
    return swim.run_traced(
        seed, params, make_world(params, dev), CANARY_ROUNDS,
        trace_capacity=capacity, draws=lambda r: draws(r).to(dev),
        device=dev) + (dict(LAUNCHES),)


def traced_canary(device, label, layout, params, make_world,
                  capacity=ttrace.DEFAULT_CAPACITY, seed=5, want_types=()):
    """Phase 5b: ``run_traced`` on the card and on the CPU (in a worker
    process, :func:`cpu_half`) with the same CPU-made draws, and the
    card's untraced run: the trace (lanes, count, dropped, first_suspect,
    first_removed) card == CPU; the card's untraced run equal to the CPU
    run's state and metrics (the layout's canary) and to the card's
    traced run's; one ``trace_observe`` a round on top of the layout's
    kernels and no ``trace_record``.  Returns the card's launches."""
    cs, cpu_tel, cm, cpu_launches = cpu_half("traced", label)
    gs, gtel, gm, launches = traced_run(params, make_world, capacity,
                                        device, seed)
    plain_state, plain_metrics, plain_launches = canary_run(
        params, make_world, device, seed=seed)
    n, k = params.n_members, params.n_subjects
    tag = f"traced canary {label} {n}x{k}"
    telemetry_equal(tag, cpu_tel, gtel)
    for other, (state, metrics) in (("the traced run", (gs, gm)),
                                    ("the CPU's", (cs, cm))):
        for field in dataclasses.fields(swim.SwimState):
            if not torch.equal(getattr(state, field.name).cpu(),
                               getattr(plain_state, field.name).cpu()):
                raise AssertionError(f"{tag}: the untraced run's state."
                                     f"{field.name} differs from {other}")
        for name, value in plain_metrics.items():
            if not torch.equal(value.cpu(), metrics[name].cpu()):
                raise AssertionError(f"{tag}: the untraced run's metric "
                                     f"{name} differs from {other}")
    want = {name: CANARY_ROUNDS * blocks_of(params)
            for name in ROUND_KERNELS[layout]}
    if plain_launches != want:
        raise AssertionError(f"{tag}: untraced launches {plain_launches}, "
                             f"want {want}")
    want[trace_kernel.OBSERVE] = CANARY_ROUNDS
    if cpu_launches or launches != want:
        raise AssertionError(f"{tag}: launches cpu={cpu_launches} card="
                             f"{launches}, want none and {want}")
    types = {e.event_type.name for e in ttrace.decode_events(gtel)}
    missing = set(want_types) - types
    if missing:
        raise AssertionError(f"{tag}: no {sorted(missing)} event recorded "
                             f"(types {sorted(types)})")
    count, dropped = int(gtel.trace.count), int(gtel.trace.dropped)
    if capacity < ttrace.DEFAULT_CAPACITY and dropped == 0:
        raise AssertionError(f"{tag}: capacity {capacity} did not overflow")
    log(f"[canary] {tag}, {CANARY_ROUNDS} rounds: trace card == CPU ("
        f"{count} recorded, {dropped} dropped, capacity {capacity}, types "
        f"{sorted(types)}), state and metrics equal the untraced run's, "
        f"which equals the CPU's (card == CPU bit for bit), launches "
        f"{launches}")
    return launches


def traced_canary_cases():
    """Phase 5b's cases at 4,096 x 16, ``(label, layout, params,
    make_world, capacity, event types that must be recorded)``: shift in
    four layouts, scatter wide, an overflowing capacity, the open world
    with a join."""
    cases = [(f"{layout}", layout, profile_round.bench_params(
        layout, 4096, 16), traced_world, ttrace.DEFAULT_CAPACITY,
        ("SUSPECTED", "REMOVED", "LEAVING")) for layout in LAYOUTS]
    cases += [("scatter wide", "wide", profile_round.bench_params(
        "wide", 4096, 16, "scatter"), traced_world,
        ttrace.DEFAULT_CAPACITY, ("SUSPECTED", "LEAVING")),
        ("wide overflow", "wide", profile_round.bench_params(
            "wide", 4096, 16), traced_world, TRACE_CANARY_SMALL_CAPACITY,
         ("SUSPECTED",)),
        ("open world join", "wide", profile_round.bench_params(
            "wide", 4096, 16, open_world=True), traced_join_world,
         ttrace.DEFAULT_CAPACITY, ("SUSPECTED", "LEAVING", "JOINED"))]
    return cases


def traced_canaries(device):
    """Phase 5b: the traced canaries (:func:`traced_canary_cases`)."""
    launches = {}
    for label, layout, params, make_world, capacity, want_types in \
            traced_canary_cases():
        for name, count in traced_canary(
                device, label, layout, params, make_world, capacity,
                want_types=want_types).items():
            launches[name] = launches.get(name, 0) + count
    return launches


def segment_event_counts(params, world, rounds, segment, device):
    """Events each segment of the traced window must account for: an
    untraced run round by round from the initial state, with the plain
    derivation (``trace.round_transition_codes``) counting each round's
    nonzero codes on the device, and the reference's codes-in API on
    those codes: ``trace.record_events`` (one ``trace_record`` a round)
    into a fresh ``TRACE_CAPACITY`` buffer a segment and
    ``trace.update_first_rounds``.  Returns the counts, the final state,
    each segment's ``EventTrace`` and the ``TelemetryState`` holding the
    first-round matrices."""
    state = swim.initial_state(params, world, device=device)
    draws = prng.TorchDraws(0, device, params, world)
    tel = ttrace.TelemetryState.init(params.n_members, params.n_subjects,
                                     capacity=1, device=device)
    counts, traces = [], []
    for lo in range(0, rounds, segment):
        total = torch.zeros((), dtype=torch.int64, device=device)
        seg = ttrace.EventTrace.empty(TRACE_CAPACITY, device)
        for r in range(lo, min(lo + segment, rounds)):
            new, _ = swim.run(0, params, world, 1, state=state,
                              start_round=r, draws=draws, device=device)
            codes, ev_inc = ttrace.round_transition_codes(r, state.status,
                                                          state.inc, new,
                                                          world)
            total += (codes != 0).sum()
            ttrace.record_events(seg, r, codes, ev_inc, world.subject_ids)
            ttrace.update_first_rounds(tel, codes, r)
            state = new
        counts.append(total)
        traces.append(seg)
    return [int(c) for c in counts], state, traces, tel


def traced_window_path(device):
    """Phase 6a: bench.py's traced window at full width
    (``bench_workload``, bench.py:388-412, through ``timed_traced_run``'s
    runner, bench.py:475-540): LAN defaults, N = 1M x K = 16, loss 0.02,
    node 3 crashed at round 10, shift, wide; ``stream_traced_run`` over
    256 rounds in 4 segments at ``traced_window_policy``'s capacity of
    65,536 a segment, ``decode=False``, and the untraced ``run`` of the
    same rounds and draws, each timed twice, in turns.  The final states
    must be equal lane for lane and the metrics equal; each segment's
    count + dropped (from the same runner, one segment at a time)
    must equal the plain derivation's nonzero codes over its rounds.
    Prints both ms/round (means of the two windows), their ratio
    (``traced_overhead_ratio``: untraced member-rounds/s over traced,
    i.e. traced ms over untraced), peak bytes, and profiled 10-round
    windows from round 256, traced and untraced."""
    params = profile_round.bench_params("wide", MAIN_N, MAIN_K)
    world = crash_world(params, device)
    segment = TRACE_ROUNDS // TRACE_SEGMENTS
    # First calls (allocator, cumsum, pinned memory) outside the timing.
    sink.stream_traced_run(0, params, world, 2, segment_rounds=1,
                           trace_capacity=TRACE_CAPACITY, decode=False,
                           device=device)
    swim.run(0, params, world, 2, device=device)

    def timed(traced):
        """One window, traced or not: seconds, outputs, launches, and the
        peak allocation above what was allocated when it began."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        if traced:
            out = sink.stream_traced_run(
                0, params, world, TRACE_ROUNDS, segment_rounds=segment,
                trace_capacity=TRACE_CAPACITY, decode=False, device=device)
        else:
            out = swim.run(0, params, world, TRACE_ROUNDS, device=device)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0, out, dict(LAUNCHES),
                torch.cuda.max_memory_allocated() - resident)

    # In turns (traced, untraced, untraced, traced): the host clock of a
    # launch-bound round drifts between windows.
    turns = [(traced, timed(traced)) for traced in (True, False, False,
                                                    True)]
    traced_runs = [t for traced, t in turns if traced]
    plain_runs = [t for traced, t in turns if not traced]
    _, (traced_state, res), launches, traced_peak = traced_runs[0]
    _, (plain_state, plain_metrics), _, plain_peak = plain_runs[0]
    traced_s = statistics.mean(t[0] for t in traced_runs)
    plain_s = statistics.mean(t[0] for t in plain_runs)
    want = {name: TRACE_ROUNDS for name in ROUND_KERNELS["wide"]}
    want[trace_kernel.OBSERVE] = TRACE_ROUNDS
    if launches != want:
        raise AssertionError(f"traced window: launches {launches}, want "
                             f"{want} (one trace_observe a round, no "
                             f"trace_record)")
    for field in dataclasses.fields(swim.SwimState):
        if not torch.equal(getattr(traced_state, field.name),
                           getattr(plain_state, field.name)):
            raise AssertionError(f"traced window: final state.{field.name} "
                                 f"differs from the untraced run")
    for name, value in plain_metrics.items():
        if not np.array_equal(res.metrics[name], value.cpu().numpy()):
            raise AssertionError(f"traced window: metric {name} differs "
                                 f"from the untraced run")
    if res.n_segments != TRACE_SEGMENTS:
        raise AssertionError(f"traced window: {res.n_segments} segments")

    LAUNCHES.clear()
    counts, check_state, record_traces, record_tel = segment_event_counts(
        params, world, TRACE_ROUNDS, segment, device)
    record_launches = dict(LAUNCHES)
    want = {name: TRACE_ROUNDS for name in ROUND_KERNELS["wide"]}
    want[trace_kernel.NAME] = TRACE_ROUNDS
    if record_launches != want:
        raise AssertionError(f"traced window: the codes-in record's "
                             f"launches {record_launches}, want {want}")
    if not torch.equal(check_state.status, plain_state.status):
        raise AssertionError("traced window: the round-by-round run ends "
                             "elsewhere")
    for name, x, y in (
            ("first_suspect", res.telemetry.first_suspect,
             record_tel.first_suspect),
            ("first_removed", res.telemetry.first_removed,
             record_tel.first_removed)):
        if not torch.equal(x, y):
            raise AssertionError(f"traced window: {name} differs from the "
                                 f"codes-in record's")
    state, per_segment = None, []
    for i in range(TRACE_SEGMENTS):
        state, one = sink.stream_traced_run(
            0, params, world, segment, state=state,
            start_round=i * segment, segment_rounds=segment,
            trace_capacity=TRACE_CAPACITY, device=device)
        per_segment.append((one.recorded, one.dropped))
        record = record_traces[i]
        if (one.recorded, one.dropped) != (int(record.count),
                                           int(record.dropped)) \
                or one.events != ttrace.decode_events(record):
            raise AssertionError(f"traced window: segment {i}'s trace "
                                 f"differs from the codes-in record's")
    if [r + d for r, d in per_segment] != counts:
        raise AssertionError(f"traced window: per-segment recorded + "
                             f"dropped {per_segment} against the plain "
                             f"counts {counts}")
    if (res.recorded, res.dropped) != (sum(r for r, _ in per_segment),
                                       sum(d for _, d in per_segment)):
        raise AssertionError("traced window: totals differ from the "
                             "segment-by-segment run")

    traced_ms = traced_s / TRACE_ROUNDS * 1e3
    plain_ms = plain_s / TRACE_ROUNDS * 1e3
    windows = {}
    for label, cap in (("traced", TRACE_CAPACITY), ("untraced", 0)):
        windows[label] = profile_round.profile_window(
            params, world, plain_state, TRACE_ROUNDS, PROFILE_ROUNDS,
            trace_capacity=cap)
    log(f"[traced window] wide {MAIN_N}x{MAIN_K}, {TRACE_ROUNDS} rounds in "
        f"{TRACE_SEGMENTS} segments of {segment}, capacity {TRACE_CAPACITY}:"
        f" traced {traced_ms:.4f} ms/round "
        f"({MAIN_N * TRACE_ROUNDS / traced_s:.6g} member-rounds/s), "
        f"untraced {plain_ms:.4f} ms/round "
        f"({MAIN_N * TRACE_ROUNDS / plain_s:.6g} member-rounds/s), "
        f"traced_overhead_ratio {traced_ms / plain_ms:.4f} (means of two "
        f"windows each, timed in turns traced, untraced, untraced, traced: "
        f"{[round(t[0] / TRACE_ROUNDS * 1e3, 4) for _, t in turns]} "
        f"ms/round); "
        f"{res.recorded} events recorded, {res.dropped} dropped, per "
        f"segment (recorded, dropped) {per_segment} == plain counts "
        f"{counts}; each segment's events and the first-round matrices "
        f"equal the codes-in record's ({record_launches}); final state "
        f"and metrics equal the untraced run's; "
        f"launches {launches}; peak above the resident bytes "
        f"{traced_peak} B traced, {plain_peak} B untraced")
    for label, window in windows.items():
        log(f"[traced window] {label} window from round {TRACE_ROUNDS}: "
            f"wall {window['wall_ms_per_round']:.4f} ms/round, device busy "
            f"{window['device_busy_ms_per_round']:.4f}, idle share "
            f"{window['device_idle_share']:.4f}, "
            f"{window['kernel_launches_per_round']:.2f} launches/round, "
            f"phases {json.dumps(window['phase_device_ms_per_round'])}, "
            f"launches {json.dumps(window['phase_launches_per_round'])}")
    return launches, record_launches


def telemetry_path(device):
    """Phase 6b: bench.py's telemetry scenario (bench.py:666-720):
    ``TELEMETRY_N`` = 4,096 members x 16 subjects, the sped-up protocol
    timing, shift, node 3 crashed at round 10, ``suspicion_rounds + 80``
    rounds through ``stream_traced_run`` in segments of a third of them
    (the bench's ``max(1, rounds // 3)``) at the default capacity, seed
    7.  No event may be dropped; for node 3 the detection
    histogram's total, the undetected observers and the observers whose
    first suspicion came before the crash must sum to N - 1, and the same
    for removal.  Prints the buckets."""
    cfg = ClusterConfig.default().replace(
        gossip_interval=100, ping_interval=200, ping_timeout=100,
        sync_interval=1_000, suspicion_mult=3)
    params = swim.SwimParams.from_config(cfg, n_members=TELEMETRY_N,
                                         n_subjects=16, delivery="shift")
    world = swim.SwimWorld.healthy(params, device=device).with_crash(
        CRASHED, at_round=TELEMETRY_CRASH_AT)
    rounds = params.suspicion_rounds + 80
    segment = max(1, rounds // 3)
    LAUNCHES.clear()
    _, res = sink.stream_traced_run(7, params, world, rounds,
                                    segment_rounds=segment, device=device)
    launches = dict(LAUNCHES)
    if res.dropped != 0 or res.n_segments != -(-rounds // segment):
        raise AssertionError(f"telemetry: {res.dropped} events dropped, "
                             f"{res.n_segments} segments")
    if launches.get(trace_kernel.OBSERVE) != rounds \
            or trace_kernel.NAME in launches:
        raise AssertionError(f"telemetry: launches {launches}")
    hists = ttrace.latency_histograms(res.telemetry, world)
    slot = CRASHED
    observers = torch.arange(TELEMETRY_N, device=device) != CRASHED
    out = {}
    for name, first in (("detection", res.telemetry.first_suspect),
                        ("removal", res.telemetry.first_removed)):
        col = first[:, slot]
        early = int(((col != INT32_MAX) & (col < TELEMETRY_CRASH_AT)
                     & observers).sum())
        total = int(hists[name][slot].sum())
        undetected = int(hists[name + "_undetected"][slot])
        if total + undetected + early != TELEMETRY_N - 1:
            raise AssertionError(f"telemetry: {name} {total} + undetected "
                                 f"{undetected} + early {early} != "
                                 f"{TELEMETRY_N - 1}")
        out[name] = (total, undetected, early,
                     hists[name][slot].cpu().tolist())
    kinds = collections.Counter(e.event_type.name for e in res.events)
    log(f"[telemetry] {TELEMETRY_N}x16, crash of node {CRASHED} at round "
        f"{TELEMETRY_CRASH_AT}, {rounds} rounds in {res.n_segments} "
        f"segments: {res.recorded} events recorded, {res.dropped} dropped "
        f"(capacity {res.capacity}), {dict(kinds)}; edges "
        f"{hists['edges'].cpu().tolist()}")
    for name, (total, undetected, early, buckets) in out.items():
        log(f"[telemetry] {name} of node {CRASHED}: {total} observers "
            f"bucketed + {undetected} undetected + {early} before the crash "
            f"= {TELEMETRY_N - 1}; buckets {buckets}")
    return launches


# --------------------------------------------------------------------------
# The health-metrics and invariant-monitor planes
# --------------------------------------------------------------------------


def monitor_cells(density, seed, device, codes=tuple(monitor.InvariantCode)):
    """Seeded monitor evidence at 1M x 16 on the card: ``(cells,
    self_lanes, self_inc)`` as ``monitor.check_cells`` gives them, every
    code in ``codes`` with violating cells at ``density`` and a seeded
    detail plane, both self lanes at ``density * 16``."""
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (MAIN_N, MAIN_K)
    cells = []
    for code in codes:
        vio = torch.rand(shape, generator=g, device=device) < density
        detail = torch.randint(-1, 1 << 20, shape, generator=g,
                               device=device, dtype=torch.int32)
        cells.append((code, vio, lambda d=detail: d))
    self_lanes = tuple(
        (code, torch.rand((MAIN_N,), generator=g, device=device)
         < density * MAIN_K)
        for code in (monitor.InvariantCode.INC_REGRESSION,
                     monitor.InvariantCode.WIRE_SATURATION))
    self_inc = torch.randint(0, 1 << 20, (MAIN_N,), generator=g,
                             device=device, dtype=torch.int32)
    return cells, self_lanes, self_inc


def monitor_buffer(start, device):
    """A monitor of ``MONITOR_CAPACITY`` rows with ``start`` seeded rows
    recorded and 5 drops counted."""
    mon = monitor.MonitorState.init(MONITOR_CAPACITY, device)
    lanes, count, dropped = trace_buffer(start, MONITOR_CAPACITY, device)
    return dataclasses.replace(mon, lanes=lanes, count=count,
                               dropped=dropped)


def plain_record(lanes, count, dropped, codes, incs, subject_ids, round_idx,
                 observer_offset):
    trace_kernel.trace_record_reference(lanes, count, dropped, codes, incs,
                                        subject_ids, round_idx,
                                        observer_offset)


def monitor_record_call(mon, evidence, fresh, record=None):
    cells, self_lanes, self_inc = evidence
    subjects = trace_subjects(mon.lanes.device)
    return lambda: monitor.record_round(mon, TRACE_RECORD_ROUND, cells,
                                        self_lanes, self_inc, subjects, fresh,
                                        record=record)


def monitor_record_total(evidence, fresh):
    cells, self_lanes, _ = evidence
    return (sum(int((vio & fresh[int(c)]).sum()) for c, vio, _ in cells)
            + sum(int((v & fresh[int(c)]).sum()) for c, v in self_lanes))


def check_monitor_record(device):
    """Phase 3c, the monitor's evidence record (``chaos/monitor.
    record_round``: one codes-in ``trace_record`` launch a code and one a
    self lane, the self lanes with the observer as subject) against the
    same pass on the plain version at 1M x 16, on seeded violation planes
    (``MONITOR_RECORD_CASES``): every code tripped, the self lanes alone,
    codes no longer fresh (recording nothing), an overflow partway through
    the codes, a start one row below the capacity and at it; lanes, count
    and dropped exact, each case checked to reach its edge.  Then timed on
    the device clock: the passive monitor's record pass of a green round
    (three empty code planes and two empty self lanes, the pass a bench
    round runs), one launch on an empty plane, and the every-code round,
    each beside its byte bound and the plain pass.  Returns the
    trace_record row's ``monitor_*`` fields."""
    cases = []
    for label, density, self_density, start, stale in MONITOR_RECORD_CASES:
        codes = () if density == 0 else tuple(monitor.InvariantCode)
        cells, self_lanes, self_inc = monitor_cells(density, 21, device,
                                                    codes)
        g = torch.Generator(device=device).manual_seed(23)
        self_lanes = tuple(
            (c, torch.rand((MAIN_N,), generator=g, device=device)
             < self_density) for c, _ in self_lanes)
        evidence = (cells, self_lanes, self_inc)
        fresh = torch.ones((monitor.N_CODES,), dtype=torch.bool,
                           device=device)
        fresh[list(stale)] = False
        got = monitor_buffer(start, device)
        want = got.clone()
        monitor_record_call(got, evidence, fresh)()
        monitor_record_call(want, evidence, fresh, plain_record)()
        torch.cuda.synchronize()
        max_abs_err(f"monitor record {label}",
                    (got.lanes, got.count, got.dropped),
                    (want.lanes, want.count, want.dropped))
        total = monitor_record_total(evidence, fresh)
        count, dropped = int(got.count), int(got.dropped)
        check_counters("monitor record", label, start, MONITOR_CAPACITY,
                       total, count, dropped)
        recorded = set(got.lanes[start:count, 3].unique().tolist())
        reached = {
            "every code": recorded == set(range(monitor.N_CODES))
            and count == start + total,
            "self lanes": recorded == {1, 3} and count == start + total,
            "not fresh": not recorded & set(stale) and total > 0
            and count == start + total,
        }.get(label, reaches_edge(label, start, MONITOR_CAPACITY, total,
                                  count, dropped, 0))
        if not reached:
            raise AssertionError(f"monitor record {label}: the case does "
                                 f"not reach its edge ({total} rows, codes "
                                 f"{sorted(recorded)})")
        cases.append(dict(case=label, rows=total, start=start, count=count,
                          dropped=dropped))
        log(f"[kernel] trace_record monitor {label} {MAIN_N}x{MAIN_K}: "
            f"exact match (lanes, count, dropped), {total} rows from "
            f"{start} -> {count} of {MONITOR_CAPACITY}, dropped {dropped}, "
            f"codes {sorted(recorded)}")

    fresh = torch.ones((monitor.N_CODES,), dtype=torch.bool, device=device)
    passive = (monitor.InvariantCode.INC_REGRESSION,
               monitor.InvariantCode.TIMER_BOUND,
               monitor.InvariantCode.WIRE_SATURATION)
    green = monitor_cells(0.0, 22, device, passive)
    busy = monitor_cells(2e-5, 21, device)
    mon = monitor_buffer(0, device)
    plane = torch.zeros((MAIN_N, MAIN_K), dtype=torch.int8, device=device)
    incs = torch.zeros((MAIN_N, MAIN_K), dtype=torch.int32, device=device)
    subjects = trace_subjects(device)

    def reset(fn):
        def call():
            mon.count.zero_()
            fn()
        return call

    n_cells = MAIN_N * MAIN_K
    # Bytes: each bool plane read once (and the self lanes), the detail
    # and the 20-B row of each recorded cell, the two counters.
    green_bytes = len(passive) * n_cells + 2 * MAIN_N + 16
    busy_rows = monitor_record_total(busy, fresh)
    busy_bytes = (monitor.N_CODES * n_cells + 2 * MAIN_N
                  + busy_rows * (4 + 4 * trace_kernel.N_LANES) + 16)
    out = dict(
        monitor_cases=cases,
        monitor_green_pass_ms=device_ms(monitor_record_call(mon, green,
                                                            fresh)),
        monitor_green_pass_plain_ms=device_ms(monitor_record_call(
            mon, green, fresh, plain_record)),
        monitor_green_pass_bound_ms=green_bytes / HBM_BYTES_PER_S * 1e3,
        monitor_empty_launch_ms=device_ms(lambda: trace_kernel.trace_record(
            mon.lanes, mon.count, mon.dropped, plane, incs, subjects,
            TRACE_RECORD_ROUND)),
        monitor_empty_launch_bound_ms=(n_cells + 16) / HBM_BYTES_PER_S
        * 1e3,
        monitor_every_code_rows=busy_rows,
        monitor_every_code_ms=device_ms(reset(monitor_record_call(
            mon, busy, fresh))),
        monitor_every_code_plain_ms=device_ms(reset(monitor_record_call(
            mon, busy, fresh, plain_record))),
        monitor_every_code_bound_ms=busy_bytes / HBM_BYTES_PER_S * 1e3)
    log(f"[kernel] trace_record monitor pass {MAIN_N}x{MAIN_K}: green round "
        f"(3 code planes, 2 self lanes, 5 launches) device clock "
        f"{out['monitor_green_pass_ms']:.4f} ms (plain "
        f"{out['monitor_green_pass_plain_ms']:.4f}), bound "
        f"{out['monitor_green_pass_bound_ms']:.4f} ms (bytes); one launch "
        f"on an empty plane {out['monitor_empty_launch_ms']:.4f} ms, bound "
        f"{out['monitor_empty_launch_bound_ms']:.4f}; every code "
        f"({busy_rows} rows, 10 launches, count reset) "
        f"{out['monitor_every_code_ms']:.4f} ms (plain "
        f"{out['monitor_every_code_plain_ms']:.4f}), bound "
        f"{out['monitor_every_code_bound_ms']:.4f}")
    return out


def monitor_equal(label, a, b):
    """Raise unless two ``MonitorState``s are equal field for field."""
    for field in dataclasses.fields(monitor.MonitorState):
        if not torch.equal(getattr(a, field.name).cpu(),
                           getattr(b, field.name).cpu()):
            raise AssertionError(f"{label}: monitor {field.name} differs")


def registry_equal(label, a, b, skip=()):
    """Raise unless two ``MetricsState``s hold the same counters (but
    those in ``skip``), gauges and histograms."""
    keep = torch.tensor([name not in skip
                         for name in metrics.DEFAULT_COUNTERS])
    if not torch.equal(a.counters.cpu()[keep], b.counters.cpu()[keep]):
        raise AssertionError(f"{label}: registry counters differ")
    if not torch.equal(a.gauges.cpu(), b.gauges.cpu()):
        raise AssertionError(f"{label}: registry gauges differ")
    for name, value in a.hists.items():
        if not torch.equal(value.cpu(), b.hists[name].cpu()):
            raise AssertionError(f"{label}: histogram {name} differs")


def canary_monitor_spec(params, world, device):
    """The monitor canaries' spec: a pristine network promised, node 3's
    removal promised by ``CRASH_AT + suspicion_rounds + 24`` (what a run
    at the params' own timeout meets)."""
    complete_by = torch.full((params.n_subjects,), INT32_MAX,
                             dtype=torch.int32, device=device)
    complete_by[int(world.slot_of_node[CRASHED])] = (
        CRASH_AT + params.suspicion_rounds + 24)
    return monitor.MonitorSpec(complete_by=complete_by,
                               check_false_suspicion=True)


def monitor_canary_params(layout, delivery):
    """The monitor canaries' params: the telemetry scenario's sped-up
    timing at ``MONITOR_CANARY_N`` x 16."""
    cfg = ClusterConfig.default().replace(
        gossip_interval=100, ping_interval=200, ping_timeout=100,
        sync_interval=1_000, suspicion_mult=3)
    return swim.SwimParams.from_config(
        cfg, n_members=MONITOR_CANARY_N, n_subjects=16, delivery=delivery,
        **LAYOUTS[layout])


def monitor_run(layout, delivery, dev):
    """One monitor canary run on ``dev`` with the CPU-made draws:
    ``(state, monitor, registry, metrics, launches)``."""
    params = monitor_canary_params(layout, delivery)
    kn = swim.Knobs.for_params(params, loss_probability=0.25,
                               suspicion_rounds=10 * params.suspicion_rounds)
    draws = prng.TorchDraws(5, "cpu", params, crash_world(params, "cpu"))
    world = crash_world(params, dev)
    LAUNCHES.clear()
    return monitor.run_monitored_metered(
        5, params, world, canary_monitor_spec(params, world, dev),
        MONITOR_CANARY_ROUNDS, draws=lambda r: draws(r).to(dev), knobs=kn,
        device=dev) + (dict(LAUNCHES),)


MONITOR_CANARY_CASES = (("wide", "wide", "shift"),
                        ("compact_wire24", "compact_wire24", "shift"),
                        ("scatter wide", "wide", "scatter"))


def monitor_canary(device, label, layout, delivery):
    """Phase 5c: ``run_monitored_metered`` at ``MONITOR_CANARY_N`` x 16
    (the telemetry scenario's sped-up timing, node 3 crashed at round 10)
    for 100 rounds with the loss knob at 0.25 and the suspicion timeout
    knob at 10x the params', under ``canary_monitor_spec``: on the card
    and on the CPU with the same CPU-made draws.  Card == CPU: every state
    lane and metric, the monitor (lanes, count, dropped, counts, first
    rounds) and the registry; FALSE_SUSPICION and COMPLETENESS must trip
    and ``chaos_violations`` equal the monitor's total; the card launches
    the layout's kernels and seven ``trace_record`` a round (five codes,
    two self lanes)."""
    params = monitor_canary_params(layout, delivery)
    cs, cmon, cms, cm, cpu_launches = cpu_half("monitor", label)
    gs, gmon, gms, gm, launches = monitor_run(layout, delivery, device)
    tag = f"monitor canary {label} {MONITOR_CANARY_N}x16"
    for field in dataclasses.fields(swim.SwimState):
        if not torch.equal(getattr(cs, field.name),
                           getattr(gs, field.name).cpu()):
            raise AssertionError(f"{tag}: state.{field.name} differs")
    for name, value in cm.items():
        if not torch.equal(value, gm[name].cpu()):
            raise AssertionError(f"{tag}: metric {name} differs")
    monitor_equal(tag, cmon, gmon)
    registry_equal(tag, cms, gms)
    v = monitor.verdict(gmon)
    codes = {c: (d["violations"], d["first_round"])
             for c, d in v["codes"].items() if d["violations"]}
    if not {"FALSE_SUSPICION", "COMPLETENESS"} <= set(codes):
        raise AssertionError(f"{tag}: codes tripped {codes}")
    chaos = int(gms.counters[metrics.DEFAULT_COUNTERS.index(
        "chaos_violations")])
    if chaos != v["total_violations"]:
        raise AssertionError(f"{tag}: chaos_violations {chaos}, monitor "
                             f"total {v['total_violations']}")
    want = monitor_launches(params, MONITOR_CANARY_ROUNDS, layout, 7)
    if cpu_launches or launches != want:
        raise AssertionError(f"{tag}: launches cpu={cpu_launches} card="
                             f"{launches}, want none and {want}")
    log(f"[canary] {tag}, {MONITOR_CANARY_ROUNDS} rounds: state, metrics, "
        f"monitor "
        f"and registry card == CPU; codes (violations, first round) "
        f"{codes}, {v['evidence_recorded']} recorded, "
        f"{v['evidence_dropped']} dropped, chaos_violations {chaos}; "
        f"launches {launches}")
    return launches


def monitor_canaries(device):
    """Phase 5c: the monitor canaries (wide and compact + wire24 under
    shift, wide under scatter)."""
    launches = {}
    for label, layout, delivery in MONITOR_CANARY_CASES:
        for name, count in monitor_canary(device, label, layout,
                                          delivery).items():
            launches[name] = launches.get(name, 0) + count
    return launches


def instrumented_stack_path(device):
    """Phase 6d: ``bench.py --compose``'s full instrumented stack at full
    width (``bench_workload``: LAN defaults, N = 1M x K = 16, loss 0.02,
    node 3 crashed at round 10, shift, wide): the trace (capacity 65,536,
    ``traced_window_policy``'s), the passive monitor and the default
    registry in one ``run_composed``.

    Parity (bench.py:3387): the composed window's final status, trace
    lanes and count, monitor code counts (and lanes, count, dropped,
    first rounds) and every registry counter but ``chaos_violations``
    (and the gauges and histograms) equal ``run_traced``'s,
    ``run_monitored``'s and ``run_metered``'s on the same rounds; the
    monitor green; the launches one merge, one ``trace_observe`` and five
    ``trace_record`` (three codes, two self lanes) a round.  Timing:
    ``STACK_ROUNDS`` rounds from the initial state, bare ``run``, the
    composed stack and ``run_metered`` in turns (bare, stack, metered,
    metered, stack, bare); ``full_stack_overhead_ratio`` (stack s / bare
    s) and ``metrics_overhead_ratio`` (metered s / bare s, bench.py's
    unmetered rate over metered) from the means.  Profiled 20-round
    windows from round 256: bare, the stack, the monitor alone, the
    metrics alone (device busy ms and launches a round, the
    ``metrics.observe``, ``monitor.check`` and ``monitor.record``
    phases).  Then ``stream_metered_run`` through a ``TelemetrySink``
    into a temporary directory, ``STACK_ROUNDS`` rounds in four windows,
    read back with ``sink.read_records``: the windows' counters and
    histograms summed, and the last window's gauges, equal the single
    metered run's."""
    params = profile_round.bench_params("wide", MAIN_N, MAIN_K)
    world = crash_world(params, device)
    spec = monitor.MonitorSpec.passive(params, device=device)
    mspec = metrics.MetricsSpec.default()

    def bare(rounds, state=None, start=0):
        return swim.run(0, params, world, rounds, state=state,
                        start_round=start, device=device)

    def stack(rounds, state=None, start=0):
        return compose.run_composed(
            0, params, world, rounds, monitor_spec=spec,
            trace_capacity=TRACE_CAPACITY, metrics_spec=mspec, state=state,
            start_round=start, device=device)

    def metered(rounds, state=None, start=0):
        return swim.run_metered(0, params, world, rounds, spec=mspec,
                                state=state, start_round=start,
                                device=device)

    def monitored(rounds, state=None, start=0):
        return monitor.run_monitored(0, params, world, spec, rounds,
                                     state=state, start_round=start,
                                     device=device)

    for fn in (bare, stack, metered):       # allocator and first calls
        fn(2)
    arms = {"bare": bare, "stack": stack, "metered": metered}
    order = ("bare", "stack", "metered", "metered", "stack", "bare")
    turns, outputs, launches = [], {}, {}
    for name in order:
        torch.cuda.synchronize()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        out = arms[name](STACK_ROUNDS)
        torch.cuda.synchronize()
        turns.append((name, time.perf_counter() - t0))
        outputs.setdefault(name, out)
        launches.setdefault(name, dict(LAUNCHES))
    want = {merge.NAMES["wide"]: STACK_ROUNDS,
            trace_kernel.OBSERVE: STACK_ROUNDS,
            trace_kernel.NAME: 5 * STACK_ROUNDS}
    if launches["stack"] != want:
        raise AssertionError(f"instrumented stack: launches "
                             f"{launches['stack']}, want {want}")
    c_state, c_res, _ = outputs["stack"]
    m_state, m_reg, _ = outputs["metered"]
    t_state, tel, _ = swim.run_traced(0, params, world, STACK_ROUNDS,
                                      trace_capacity=TRACE_CAPACITY,
                                      device=device)
    o_state, mon, _ = monitored(STACK_ROUNDS)
    for label, other in (("run_traced", t_state), ("run_metered", m_state),
                         ("run_monitored", o_state),
                         ("run", outputs["bare"][0])):
        if not torch.equal(other.status, c_state.status):
            raise AssertionError(f"instrumented stack: final status "
                                 f"differs from {label}'s")
    telemetry_equal("instrumented stack vs run_traced", tel, c_res["trace"])
    monitor_equal("instrumented stack vs run_monitored", mon,
                  c_res["monitor"])
    registry_equal("instrumented stack vs run_metered", m_reg,
                   c_res["metrics"], skip=("chaos_violations",))
    verdict = monitor.verdict(c_res["monitor"])
    if not verdict["green"]:
        raise AssertionError(f"instrumented stack: monitor not green "
                             f"{verdict['codes']}")
    mean_s = {name: statistics.mean(s for n, s in turns if n == name)
              for name in arms}

    def runner(fn):
        return lambda state, start, rounds: fn(rounds, state, start)

    windows = {label: profile_round.profile_window(
        params, world, outputs["bare"][0], STACK_ROUNDS, STACK_PROFILE_ROUNDS,
        runner=None if fn is None else runner(fn))
        for label, fn in (("bare", None), ("stack", stack),
                          ("monitor", monitored), ("metrics", metered))}

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/metered.jsonl"
        with sink.TelemetrySink(path=path) as journal:
            journal.write_manifest(params, label="instrumented stack")
            _, rows = metrics.stream_metered_run(
                0, params, world, STACK_ROUNDS, sink=journal,
                window_rounds=STACK_ROUNDS // 4, spec=mspec, device=device)
        read = sink.read_records(path, "metrics_window")
    single = metrics.to_json(m_reg, mspec)
    summed = {name: sum(r["counters"][name] for r in read)
              for name in mspec.counters}
    hist = [sum(r["histograms"]["suspicion_lifetime_rounds"]["counts"][i]
                for r in read)
            for i in range(len(metrics.DEFAULT_SUSPICION_EDGES))]
    if (len(read) != 4 or [r["round_end"] for r in read]
            != [STACK_ROUNDS // 4 * (i + 1) for i in range(4)]
            or summed != single["counters"]
            or hist != single["histograms"]["suspicion_lifetime_rounds"][
                "counts"]
            or read[-1]["gauges"] != single["gauges"]
            or [{k: v for k, v in r.items() if k not in ("kind", "run_id")}
                for r in read] != rows):
        raise AssertionError(f"instrumented stack: the metered stream's "
                             f"windows {read} do not sum to the single "
                             f"run's {single}")

    base = windows["bare"]
    summary = dict(
        card=card_line(), rounds=STACK_ROUNDS,
        ms_per_round={name: s / STACK_ROUNDS * 1e3
                      for name, s in mean_s.items()},
        full_stack_overhead_ratio=mean_s["stack"] / mean_s["bare"],
        metrics_overhead_ratio=mean_s["metered"] / mean_s["bare"],
        turns_ms_per_round=[(name, s / STACK_ROUNDS * 1e3)
                            for name, s in turns],
        extra_over_bare={label: dict(
            busy_ms=windows[label]["device_busy_ms_per_round"]
            - base["device_busy_ms_per_round"],
            launches=windows[label]["kernel_launches_per_round"]
            - base["kernel_launches_per_round"])
            for label in ("stack", "monitor", "metrics")},
        windows={label: dict(
            busy_ms=w["device_busy_ms_per_round"],
            launches=w["kernel_launches_per_round"],
            wall_ms=w["wall_ms_per_round"], idle=w["device_idle_share"],
            phases=w["phase_device_ms_per_round"],
            phase_launches=w["phase_launches_per_round"],
            top_kernels=w["top_kernels"][:6])
            for label, w in windows.items()},
        trace_recorded=int(c_res["trace"].trace.count),
        trace_dropped=int(c_res["trace"].trace.dropped),
        registry=single)
    log(f"[instrumented stack] {json.dumps(summary)}")
    log(f"[instrumented stack] wide {MAIN_N}x{MAIN_K}, {STACK_ROUNDS} "
        f"rounds: composed == run_traced / run_monitored / run_metered "
        f"(final status, trace lanes and count, monitor, counters but "
        f"chaos_violations), monitor green; ms/round "
        f"{json.dumps(summary['ms_per_round'])}: full_stack_overhead_ratio "
        f"{summary['full_stack_overhead_ratio']:.4f}, "
        f"metrics_overhead_ratio {summary['metrics_overhead_ratio']:.4f} "
        f"({summary['card']}); extra over bare a round "
        f"{json.dumps(summary['extra_over_bare'])}; the metered stream's "
        f"four windows sum to the single run")
    return launches["stack"]


# --------------------------------------------------------------------------
# The gossip-only simulator and the chaos layer (phases 8d-8h)
# --------------------------------------------------------------------------


def gossip_params(delayed):
    """The gossip simulator at its docstring's scale: LAN defaults (fanout
    3, repeat 3: 60 spread rounds at 1M), ``GOSSIP_G`` gossips, loss 0.02
    (the bench's); the delayed arm adds a mean delay of one gossip
    interval and a ``GOSSIP_DELAY_ROUNDS``-slot ring (``tests/
    test_delay.py:127``'s matrix)."""
    config = ClusterConfig.default()
    return gossip.GossipSimParams.from_config(
        config, GOSSIP_N, GOSSIP_G, loss_probability=GOSSIP_LOSS,
        mean_delay_ms=float(config.gossip_interval) if delayed else 0.0,
        max_delay_rounds=GOSSIP_DELAY_ROUNDS if delayed else 0)


def gossip_rounds():
    """``gossip_periods_to_sweep(3, N)``: 122 rounds at 1M."""
    return swim_math.gossip_periods_to_sweep(3, GOSSIP_N)


def gossip_cpu_run(delayed, dev):
    """One arm on ``dev`` with the CPU-made draws: ``(state, metrics)``
    on the host."""
    params = gossip_params(delayed)
    draws = gossip.GossipTorchDraws(GOSSIP_SEED, "cpu", params)
    state, metrics = gossip.run(GOSSIP_SEED, params, gossip_rounds(),
                                draws=draws, device=dev)
    return ({name: getattr(state, name).cpu() for name in GOSSIP_LANES},
            {name: value.cpu() for name, value in metrics.items()})


def gossip_gates(label, params, metrics):
    """The simulator's gates on one run's metrics: every gossip fully
    disseminated, each gossip's summed sends inside ClusterMath's bound.
    Returns the dissemination rounds."""
    rounds = gossip.dissemination_rounds(metrics, params.n_members).cpu()
    sent = metrics["messages_sent"].sum(dim=0, dtype=torch.int64).cpu()
    bound = swim_math.max_messages_per_gossip_total(
        params.fanout, 3, params.n_members)
    if (rounds < 0).any() or (sent > bound).any():
        raise AssertionError(f"gossip {label}: dissemination rounds "
                             f"{rounds.tolist()}, messages {sent.tolist()} "
                             f"(bound {bound})")
    return rounds, sent, bound


def gossip_path(device):
    """Phase 8d, the gossip-only simulator (``models/gossip.py``) at N =
    1,000,000 members x G = 16 gossips for 122 rounds, a lossy arm and a
    delayed arm (:func:`gossip_params`).  Each arm runs on the card with
    the CPU-made draws (equal to the CPU's run in a worker, every state
    lane and metric) and with the card's own draws (timed, profiled).
    Gates, on every run: each gossip fully disseminated; each gossip's
    summed ``messages_sent`` within ``max_messages_per_gossip_total(3, 3,
    N)``; the delayed arm's mean dissemination round over the 16 gossips
    no earlier than the lossy arm's.  Prints ms/round, device busy ms and
    launches a round and peak bytes.  Launches no kernel of the port."""
    n_rounds = gossip_rounds()
    means = {}
    LAUNCHES.clear()
    for delayed in (False, True):
        arm = "delayed" if delayed else "lossy"
        params = gossip_params(delayed)
        c_state, c_metrics = cpu_half("gossip", arm)
        draws = gossip.GossipTorchDraws(GOSSIP_SEED, "cpu", params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = gossip.run(GOSSIP_SEED, params, n_rounds,
                                    draws=draws, device=device)
        torch.cuda.synchronize()
        host_draws_s = time.perf_counter() - t0
        for name, value in c_state.items():
            if not torch.equal(getattr(state, name).cpu(), value):
                raise AssertionError(f"gossip {arm}: {name} card != CPU")
        for name, value in c_metrics.items():
            if not torch.equal(metrics[name].cpu(), value):
                raise AssertionError(f"gossip {arm}: metric {name} card != "
                                     f"CPU")
        rounds, sent, bound = gossip_gates(f"{arm} host draws", params,
                                           metrics)
        del state
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        d_state, d_metrics = gossip.run(GOSSIP_SEED, params, n_rounds,
                                        device=device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        d_rounds, d_sent, _ = gossip_gates(f"{arm} card draws", params,
                                           d_metrics)
        start = int(d_rounds.max())
        window = profile_round.profile_window(
            params, None, d_state, start, PROFILE_ROUNDS,
            runner=lambda st, r0, k: gossip.run(
                GOSSIP_SEED, params, k, state=st, device=device))
        means[arm] = (float(rounds.float().mean()),
                      float(d_rounds.float().mean()))
        log(f"[gossip] {arm} {GOSSIP_N}x{GOSSIP_G}, loss {GOSSIP_LOSS}, "
            f"mean delay {params.mean_delay_ms} ms, ring "
            f"{params.ring_slots} slots, {n_rounds} rounds: card == CPU "
            f"(every lane and metric) on the CPU-made draws, "
            f"{host_draws_s / n_rounds * 1e3:.4f} ms/round with host draws; "
            f"dissemination rounds {rounds.tolist()} (mean "
            f"{means[arm][0]:.4f}), max summed messages {int(sent.max())} "
            f"of {bound}; card draws: {seconds / n_rounds * 1e3:.4f} "
            f"ms/round, {GOSSIP_N * n_rounds / seconds:.6g} member-rounds/s, "
            f"peak {peak} B, rounds {d_rounds.tolist()} (mean "
            f"{means[arm][1]:.4f}), max messages {int(d_sent.max())}; "
            f"profiled {PROFILE_ROUNDS} rounds from round {start}: device "
            f"busy {window['device_busy_ms_per_round']:.4f} ms/round, "
            f"{window['kernel_launches_per_round']:.2f} launches/round, wall "
            f"{window['wall_ms_per_round']:.4f} ms/round, idle share "
            f"{window['device_idle_share']:.4f}, ring "
            f"{window['ring_bytes']} B, top kernels "
            f"{json.dumps(window['top_kernels'][:4])}")
        del d_state
    for i, source in enumerate(("host", "card")):
        if means["delayed"][i] < means["lossy"][i]:
            raise AssertionError(f"gossip ({source} draws): the delayed arm "
                                 f"disseminates earlier on average "
                                 f"({means['delayed'][i]}) than the lossy "
                                 f"arm ({means['lossy'][i]})")
    return dict(LAUNCHES)


def chaos_campaign_scenarios():
    """``bench.py --chaos`` at its defaults: ``generate_campaign(seed=100,
    n_scenarios=21, n=32)``."""
    return scenarios.generate_campaign(CHAOS_SEED, CHAOS_SCENARIOS,
                                       n=CHAOS_N)


def chaos_campaign_cpu(dev):
    """The campaign on ``dev`` with the CPU-made draws, no journal: each
    verdict's JSON row."""
    result = campaign.run_campaign(chaos_campaign_scenarios(),
                                   seed=CHAOS_SEED, device=dev,
                                   draw_device="cpu")
    return [v.to_json() for v in result.verdicts]


def chaos_campaign_path(device):
    """Phase 8e, ``bench.py --chaos`` at its defaults through the port's
    ``chaos.run_campaign`` (shift, scenario i with seed 100 + i, the
    CPU-made draws), its journal written through a ``TelemetrySink`` and
    read back.  Gates: each verdict row (verdict digest with its
    evidence, counters, repro) equal to the CPU's run in a worker; every
    scenario green but those ``CHAOS_STREAM_REDS`` names, whose codes and
    evidence must be exactly the named ones; the journal's manifest, 21
    ``chaos_scenario`` rows and the ``chaos_verdict`` summary.  Returns
    the launches."""
    scens = chaos_campaign_scenarios()
    cpu_rows = cpu_half("chaos", "campaign")
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/chaos.jsonl"
        LAUNCHES.clear()
        t0 = time.perf_counter()
        with sink.TelemetrySink(path=path) as journal:
            result = campaign.run_campaign(scens, seed=CHAOS_SEED,
                                           sink=journal, device=device,
                                           draw_device="cpu")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        rows = sink.read_records(path)
    rounds = sum(s.horizon for s in scens)
    for v, want in zip(result.verdicts, cpu_rows):
        if v.to_json() != want:
            raise AssertionError(f"chaos {v.scenario.name}: verdict card "
                                 f"{json.dumps(v.to_json())} != CPU "
                                 f"{json.dumps(want)}")
        log(f"[chaos] {v.scenario.name} (horizon {v.scenario.horizon}, "
            f"loss {v.scenario.loss_probability}): "
            f"{'green' if v.green else 'RED ' + v.repro()}, counters "
            f"{json.dumps(v.counters)} (card == CPU)")
    summary = result.summary()
    kinds = [r["kind"] for r in rows]
    if kinds != ["manifest"] + ["chaos_scenario"] * len(scens) + [
            "chaos_verdict"] or rows[-1]["green_scenarios"] != summary[
                "green_scenarios"]:
        raise AssertionError(f"chaos journal: kinds {kinds}, summary "
                             f"{rows[-1]}")
    unexplained = []
    for v in result.verdicts:
        if v.green:
            continue
        codes = [c for c, d in v.verdict["codes"].items() if d["violations"]]
        lanes = {(e["code"], e["subject"], e["round"])
                 for e in v.verdict["evidence"]}
        known = CHAOS_STREAM_REDS.get(v.scenario.name)
        if known is None or codes != [known[0]] or lanes != {known}:
            unexplained.append((v.repro(), codes, sorted(lanes)[:4]))
        else:
            log(f"[chaos] {v.scenario.name}: red on the port's draws as "
                f"established on the CPU (a stream effect; the port equals "
                f"the reference on the reference's draws): {codes}, "
                f"{v.verdict['codes'][known[0]]['violations']} cells, "
                f"evidence {sorted(lanes)}")
    if unexplained:
        raise AssertionError(f"chaos campaign: {summary['green_scenarios']}"
                             f" of {len(scens)} green, red: {unexplained}")
    log(f"[chaos] campaign seed {CHAOS_SEED}, {len(scens)} scenarios at "
        f"n = {CHAOS_N}, shift: {summary['green_scenarios']} of "
        f"{summary['scenarios']} green (the reference's committed CPU "
        f"run: 21 of 21), violations "
        f"{json.dumps(summary['violations_by_code'])}"
        f", card == CPU on every verdict; {rounds} rounds in "
        f"{seconds:.3f} s, {seconds / rounds * 1e3:.4f} ms/round; journal "
        f"{len(rows)} records; launches {launches}")
    return launches


def fuzz_scenario():
    """The first campaign scenario with two ops or more whose spec
    promises completeness (a finite ``complete_by``), and its run seed."""
    for i, scen in enumerate(chaos_campaign_scenarios()):
        spec = scen.build(campaign.campaign_params(scen), device="cpu")[1]
        if len(scen.ops) > 1 and bool((spec.complete_by < INT32_MAX).any()):
            return scen, CHAOS_SEED + i
    raise AssertionError("no campaign scenario promises completeness")


def weakened(params):
    return campaign.weakened_knobs(None, params)


def fuzz_cpu(dev):
    """The fuzz arm's weakened run on ``dev`` with the CPU-made draws."""
    scen, seed = fuzz_scenario()
    return campaign.run_scenario(scen, seed=seed, knobs=weakened,
                                 device=dev, draw_device="cpu").to_json()


def fuzz_path(device):
    """Phase 8f, the fuzz coverage arm, serial: one campaign scenario that
    promises completeness (:func:`fuzz_scenario`) under
    ``campaign.weakened_knobs`` (suspicion timers at 2^20 rounds).  Gates:
    red with COMPLETENESS on the card and on the CPU (a worker) alike,
    the verdicts equal; ``minimize`` on the card keeps every original
    code; its one-line ``repro()`` evaluated under the port's ``chaos``
    reproduces the minimized verdict."""
    scen, seed = fuzz_scenario()
    want = cpu_half("fuzz", "weakened")
    LAUNCHES.clear()
    v = campaign.run_scenario(scen, seed=seed, knobs=weakened, device=device,
                              draw_device="cpu")
    if v.to_json() != want:
        raise AssertionError(f"fuzz {scen.name}: weakened verdict card != "
                             f"CPU")
    codes = [c for c, d in v.verdict["codes"].items() if d["violations"]]
    if v.green or "COMPLETENESS" not in codes:
        raise AssertionError(f"fuzz {scen.name}: weakened run codes {codes}")

    def replay(cand):
        return campaign.run_scenario(cand, seed=seed, knobs=weakened,
                                     device=device, draw_device="cpu")

    t0 = time.perf_counter()
    m = campaign.minimize(
        v, run=replay,
        repro_args="knobs=lambda p: chaos.weakened_knobs(None, p), "
                   "draw_device='cpu'")
    seconds = time.perf_counter() - t0
    from scalecube_cluster_tpu_torch import chaos
    again = eval(m.repro(), {"chaos": chaos})  # noqa: S307 (the repro line)
    kept = [c for c in codes if m.verdict.verdict["codes"][c]["violations"]]
    if kept != codes or again.verdict != m.verdict.verdict:
        raise AssertionError(f"fuzz {scen.name}: minimized codes {kept} of "
                             f"{codes}, repro verdict "
                             f"{json.dumps(again.verdict['codes'])}")
    launches = dict(LAUNCHES)
    log(f"[fuzz] {scen.name} ({len(scen.ops)} ops, seed {seed}) under "
        f"weakened_knobs: red, codes {codes} (card == CPU); minimize "
        f"dropped {m.dropped_ops} op(s) in {seconds:.3f} s, kept "
        f"{m.codes}; repro {m.repro()} reproduces the verdict "
        f"({json.dumps(again.verdict['codes']['COMPLETENESS'])})")
    return launches


def lifeguard_params(lhm_max):
    """``bench.py --lifeguard``'s params (``bench.py:2108-2135``): the
    campaign preset at its finest probe cadence (pings every 100 ms, a
    50 ms timeout), scatter, uniform probe targets; ``lhm_max`` 0 is the
    control."""
    cfg = campaign.campaign_config().replace(ping_interval=100,
                                             ping_timeout=50)
    return swim.SwimParams.from_config(
        cfg, n_members=LIFEGUARD_N, delivery="scatter",
        ping_known_only=False, lhm_max=lhm_max)


def lifeguard_world(s_i, device):
    """Scenario ``s_i``'s world: ``asymmetric_degradation(11 + s_i, n=48)``
    built under the control's params, the degraded rack crashed for good
    at round ``LIFEGUARD_CRASH_AT``.  Returns the scenario and world."""
    scen = scenarios.asymmetric_degradation(LIFEGUARD_SEED + s_i,
                                            LIFEGUARD_N)
    world, _ = scen.build(lifeguard_params(0), device=device)
    rack = list(range(scenarios.asymmetric_degraded_range(LIFEGUARD_N)))
    return scen, world.with_crash(rack, LIFEGUARD_CRASH_AT)


def lifeguard_run(s_i, lhm_max, dev):
    """One arm of one scenario through ``run_metered`` on ``dev`` with the
    CPU-made draws: the final state, the registry's JSON and the
    per-round ``suspect`` / ``dead`` columns, on the host."""
    params = lifeguard_params(lhm_max)
    scen, world_cpu = lifeguard_world(s_i, "cpu")
    draws = prng.TorchDraws(LIFEGUARD_SEED + s_i, "cpu", params, world_cpu)
    world = lifeguard_world(s_i, dev)[1]
    LAUNCHES.clear()
    state, ms, m = swim.run_metered(
        LIFEGUARD_SEED + s_i, params, world, scen.horizon,
        draws=lambda r: draws(r).to(dev), device=dev)
    return (swim.SwimState(**{f.name: getattr(state, f.name).cpu()
                              for f in dataclasses.fields(state)}),
            metrics.to_json(ms, metrics.MetricsSpec.default()),
            {name: m[name].cpu() for name in ("suspect", "dead")},
            dict(LAUNCHES))


def lifeguard_path(device):
    """Phase 8g, ``bench.py --lifeguard`` at its defaults: 3 scenarios of
    ``asymmetric_degradation`` at n = 48 (:func:`lifeguard_world`), each
    through ``run_metered`` with the control (``lhm_max=0``) and the plane
    (``lhm_max=8``) on the same draws, on the card and on the CPU (a
    worker).  Gates: card == CPU (every state lane, the registry, the
    suspect and dead columns); the bench's own two, ``fp_ratio`` (the
    plane's false-positive observer rate over the control's) at most 0.5
    and the crash-detection p99 delta at most +1 round.  Prints them
    beside the reference's committed CPU values."""
    totals = {0: [0, 0], LIFEGUARD_LHM: [0, 0]}
    latencies = {0: [], LIFEGUARD_LHM: []}
    launches = {}
    rack = range(scenarios.asymmetric_degraded_range(LIFEGUARD_N))
    t0 = time.perf_counter()
    for s_i in range(LIFEGUARD_SCENARIOS):
        for lhm_max in (0, LIFEGUARD_LHM):
            g_state, digest, cols, g_launches = lifeguard_run(
                s_i, lhm_max, device)
            c_state, c_digest, c_cols, _ = cpu_half(
                "lifeguard", (s_i, lhm_max))
            label = f"lifeguard scenario {s_i} lhm_max {lhm_max}"
            for field in dataclasses.fields(swim.SwimState):
                if not torch.equal(getattr(g_state, field.name),
                                   getattr(c_state, field.name)):
                    raise AssertionError(f"{label}: state.{field.name} card "
                                         f"!= CPU")
            if digest != c_digest or any(
                    not torch.equal(cols[k], c_cols[k]) for k in cols):
                raise AssertionError(f"{label}: registry or metrics card "
                                     f"!= CPU")
            for name, count in g_launches.items():
                launches[name] = launches.get(name, 0) + count
            totals[lhm_max][0] += digest["counters"]["false_suspicion_onsets"]
            totals[lhm_max][1] += digest["counters"]["live_observer_rounds"]
            seen = (cols["suspect"] + cols["dead"])[LIFEGUARD_CRASH_AT:] > 0
            horizon = cols["suspect"].shape[0]
            for c in rack:
                hit = torch.nonzero(seen[:, c])
                latencies[lhm_max].append(
                    int(hit[0, 0]) if hit.numel()
                    else horizon - LIFEGUARD_CRASH_AT)
    seconds = time.perf_counter() - t0
    fp_off = totals[0][0] / max(totals[0][1], 1)
    fp_on = totals[LIFEGUARD_LHM][0] / max(totals[LIFEGUARD_LHM][1], 1)
    fp_ratio = fp_on / fp_off if fp_off > 0 else None
    p99_off = float(np.percentile(latencies[0], 99))
    p99_on = float(np.percentile(latencies[LIFEGUARD_LHM], 99))
    delta = p99_on - p99_off
    if fp_ratio is None or fp_ratio > 0.5 or delta > 1.0:
        raise AssertionError(f"lifeguard: fp_ratio {fp_ratio}, detection "
                             f"p99 delta {delta}")
    log(f"[lifeguard] {LIFEGUARD_SCENARIOS} scenarios at n = {LIFEGUARD_N}, "
        f"scatter, lhm_max 0 / {LIFEGUARD_LHM}, card == CPU: false-positive "
        f"observer rate {fp_off:.6f} / {fp_on:.6f}, fp_ratio {fp_ratio:.6f} "
        f"(gate <= 0.5; the reference's committed CPU run "
        f"{LIFEGUARD_REFERENCE[0]}), detection p99 {p99_off:.2f} / "
        f"{p99_on:.2f}, delta {delta:.2f} rounds (gate <= +1; reference "
        f"{LIFEGUARD_REFERENCE[1]}); onsets {totals[0][0]} / "
        f"{totals[LIFEGUARD_LHM][0]} over {totals[0][1]} observer-rounds; "
        f"six runs on the card in {seconds:.3f} s; launches {launches}")
    return launches


def dsl_scale_path(device):
    """Phase 8h, the DSL at scale: ``generate_scenario(seed=100, n=4096,
    severity="severe")`` at full view 4,096 x 4,096 through
    ``run_scenario``'s params, world and spec on the card, the port's own
    draws: one whole ``run_monitored`` (timed), then, when a code tripped,
    the same rounds one at a time (the monitor resumed) up to the last
    code's first round, whose per-round code totals say how many cells
    each code's first round recorded (no row is recorded after it).
    Gates: ``count + dropped`` equals the cells of each code's first
    violating round summed over the codes (0 for a green run), the
    stepped monitor's rows, count and dropped are the whole run's, and
    each recorded lane is of its code's first round.  Green is not
    gated."""
    scen = scenarios.generate_scenario(DSL_SEED, n=DSL_N, severity="severe")
    params = campaign.campaign_params(scen)
    world, spec = scen.build(params, device=device)
    horizon = scen.horizon
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    state, mon, m = monitor.run_monitored(DSL_SEED, params, world, spec,
                                          horizon, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(LAUNCHES)
    v = monitor.verdict(mon)
    firsts = mon.code_first_round.cpu()
    tripped = [c for c in range(monitor.N_CODES) if firsts[c] != INT32_MAX]
    step_state, step_mon, totals = None, None, []
    for r in range(max((int(firsts[c]) + 1 for c in tripped), default=0)):
        step_state, step_mon, _ = monitor.run_monitored(
            DSL_SEED, params, world, spec, 1, state=step_state,
            start_round=r, monitor=step_mon, device=device)
        totals.append(step_mon.code_counts.cpu().to(torch.int64))
    if step_mon is not None:
        for name in ("lanes", "count", "dropped", "code_first_round"):
            if not torch.equal(getattr(step_mon, name), getattr(mon, name)):
                raise AssertionError(f"dsl scale: stepped monitor {name} "
                                     f"differs from the whole run's")
    expected = 0
    if totals:
        deltas = torch.diff(torch.stack([torch.zeros_like(totals[0])]
                                        + totals), dim=0)
        expected = sum(int(deltas[int(firsts[c]), c]) for c in tripped)
    recorded = int(mon.count) + int(mon.dropped)
    lanes = monitor.decode_violations(mon)
    stray = [x for x in lanes if x.round != int(firsts[int(x.code)])]
    if recorded != expected or stray:
        raise AssertionError(f"dsl scale: recorded + dropped {recorded}, "
                             f"first-round cells {expected}, lanes off "
                             f"their code's first round {stray[:4]}")
    window = profile_round.profile_window(
        params, world, state, horizon, PROFILE_ROUNDS,
        runner=lambda st, r0, k: monitor.run_monitored(
            DSL_SEED, params, world, spec, k, state=st, start_round=r0,
            device=device))
    cells = DSL_N * DSL_N
    firsts_by_code = {c: d["first_round"] for c, d in v["codes"].items()}
    log(f"[dsl scale] {scen.name} at {DSL_N}x{DSL_N}, loss "
        f"{scen.loss_probability}, {world.faults.n_rules} link rules, "
        f"horizon {horizon}: {'green' if v['green'] else 'red'}, codes "
        f"{json.dumps({c: d['violations'] for c, d in v['codes'].items()})}, "
        f"first rounds {json.dumps(firsts_by_code)}"
        f"; recorded {int(mon.count)} + dropped {int(mon.dropped)} = the "
        f"{expected} cells of the codes' first rounds; {seconds:.3f} s, "
        f"{seconds / horizon * 1e3:.4f} ms/round, "
        f"{cells * horizon / seconds:.6g} record-updates/s, peak {peak} B, "
        f"{peak / cells:.4f} B/cell; profiled {PROFILE_ROUNDS} rounds from "
        f"round {horizon}: busy {window['device_busy_ms_per_round']:.4f} "
        f"ms/round, {window['kernel_launches_per_round']:.2f} launches/round"
        f", wall {window['wall_ms_per_round']:.4f}, idle share "
        f"{window['device_idle_share']:.4f}, phases "
        f"{json.dumps(window['phase_device_ms_per_round'])}; launches "
        f"{launches}")
    return launches


# --------------------------------------------------------------------------
# The CPU halves of the card-vs-CPU runs, in worker processes
# --------------------------------------------------------------------------

_CPU_JOBS = {}


def _cpu_worker_init():
    torch.set_num_threads(1)


def cpu_work(kind, *args):
    """The CPU half of one card-vs-CPU run, in a worker process: the run's
    outputs, serialised with ``torch.save``."""
    run = {"run": canary_run, "traced": traced_run, "monitor": monitor_run,
           "drill": drill_run, "gossip": gossip_cpu_run,
           "chaos": chaos_campaign_cpu, "fuzz": fuzz_cpu,
           "lifeguard": lifeguard_run}[kind]
    buf = io.BytesIO()
    torch.save(run(*args), buf)
    return buf.getvalue()


def start_cpu_halves(pool):
    """Submit to ``pool`` the CPU half of every canary (phases 5, 5b, 5c),
    of the blame drill (5d) and of the gossip simulator, the chaos
    campaign, the fuzz arm and the Lifeguard A/B (8d-8g): they run while
    the card builds, checks its kernels and runs the earlier phases."""
    for label, _, params, make_world, warm in canary_cases():
        _CPU_JOBS["run", label] = pool.submit(
            cpu_work, "run", params, make_world, "cpu", warm)
    for label, _, params, make_world, capacity, _ in traced_canary_cases():
        _CPU_JOBS["traced", label] = pool.submit(
            cpu_work, "traced", params, make_world, capacity, "cpu")
    for label, layout, delivery in MONITOR_CANARY_CASES:
        _CPU_JOBS["monitor", label] = pool.submit(
            cpu_work, "monitor", layout, delivery, "cpu")
    _CPU_JOBS["drill", "drill"] = pool.submit(cpu_work, "drill",
                                              drill_params(), "cpu")
    # The gossip simulator's CPU halves at 1M x 16 are the longest (several
    # hundred seconds of index_reduce_ on one thread): queued early, read
    # last.
    for delayed in (True, False):
        _CPU_JOBS["gossip", "delayed" if delayed else "lossy"] = pool.submit(
            cpu_work, "gossip", delayed, "cpu")
    _CPU_JOBS["chaos", "campaign"] = pool.submit(cpu_work, "chaos", "cpu")
    _CPU_JOBS["fuzz", "weakened"] = pool.submit(cpu_work, "fuzz", "cpu")
    for s_i in range(LIFEGUARD_SCENARIOS):
        for lhm_max in (0, LIFEGUARD_LHM):
            _CPU_JOBS["lifeguard", (s_i, lhm_max)] = pool.submit(
                cpu_work, "lifeguard", s_i, lhm_max, "cpu")


def cpu_half(kind, label):
    """The outputs of a CPU half started by :func:`start_cpu_halves`."""
    return torch.load(io.BytesIO(_CPU_JOBS.pop((kind, label)).result()),
                      weights_only=False)


# --------------------------------------------------------------------------
# The provenance plane (phases 3d, 5d and 6e)
# --------------------------------------------------------------------------


def provenance_buffer(start, capacity, device):
    """A [capacity, 6] buffer with ``start`` seeded rows already recorded
    and 5 drops counted: ``(lanes, count, dropped)``."""
    lanes = torch.full((capacity, kprov.N_LANES), -1, dtype=torch.int32,
                       device=device)
    lanes[:start] = torch.randint(0, 1 << 20, (start, kprov.N_LANES),
                                  device=device, dtype=torch.int32)
    return (lanes, torch.tensor(start, dtype=torch.int32, device=device),
            torch.tensor(5, dtype=torch.int32, device=device))


def provenance_inputs(density, start, capacity, seed, device, key_dtype,
                      epoch_dtype=None, offset=0, split=True, joins=False):
    """One ``provenance_observe`` case at 1M x 16 on the card: ``(kwargs,
    its in-place outputs)``.  The status planes and epoch lanes as
    :func:`observe_inputs` makes them (every self cell ALIVE -> SUSPECT,
    half the subjects' self rows and 64 other rows leaving); the other
    half of the self rows bump ``self_inc`` (ALIVE_REFUTED rows), as do
    64 rows that hold no self cell (nothing to record), one from INT32_MAX
    (it wraps: no bump).  The three key planes of ``key_dtype`` hold one
    seeded record a cell (ALIVE, SUSPECT or DEAD at a random incarnation
    within the wire's field) delivered by each channel with probability
    0.6 (gossip), 0.4 (sync, half of them one below) and 0.2 (fd), else
    -1, so ties, strict wins and DEAD winners occur; ``ping_req`` on 30 %
    of the rows, read with ``split``; with ``joins`` four subjects join
    this round (JOIN_REBIRTH)."""
    kw, _ = observe_inputs(density, 0, 1, seed, device, torch.int32,
                           epoch_dtype, offset)
    del kw["new_inc"]
    g = torch.Generator(device=device).manual_seed(seed + 1)
    shape = (MAIN_N, MAIN_K)

    def rand(size=shape):
        return torch.rand(size, generator=g, device=device)

    fmt = delivery.WIRE16 if key_dtype == torch.int16 else delivery.WIDE
    status = torch.randint(0, 3, shape, generator=g, device=device,
                           dtype=torch.int32).to(torch.int8)
    inc = torch.randint(0, fmt.inc_sat(), shape, generator=g, device=device,
                        dtype=torch.int32)
    base = delivery.pack_record(status, inc, fmt=fmt)
    gossip = torch.where(rand() < 0.6, base, -1).to(key_dtype)
    sync = torch.where(rand() < 0.4, torch.where(rand() < 0.5, base,
                                                  base - 1), -1)
    sync = torch.where(sync < -1, -1, sync).to(key_dtype)
    fd = torch.where(rand() < 0.2, base, -1).to(key_dtype)
    sids = kw["subject_ids"]
    self_rows = (sids - offset).long()
    prev_self = kw.pop("self_inc")
    new_self = prev_self.clone()
    bumped = torch.cat([self_rows[1::2], torch.randint(
        0, MAIN_N, (64,), generator=g, device=device)])
    new_self[bumped] += 1
    new_self[self_rows[0]] = INT32_MIN   # INT32_MAX -> wrapped: no bump
    join_at = torch.full((MAIN_N + offset,), INT32_MAX, dtype=torch.int32,
                         device=device)
    if joins:
        join_at[sids[::4].long()] = kw["round_idx"]
    kw.update(fd=fd, gossip=gossip, sync=sync,
              ping_req=rand((MAIN_N,)) < 0.3, prev_self_inc=prev_self,
              new_self_inc=new_self, join_at=join_at,
              dead_bit=fmt.dead_bit, split_ping_req=split)
    lanes, count, dropped = provenance_buffer(start, capacity, device)
    return kw, dict(lanes=lanes, count=count, dropped=dropped)


def provenance_call(kw, outs):
    return lambda: kprov.provenance_observe(**outs, **kw)


def provenance_plain(kw, outs):
    return lambda: kprov.provenance_observe_reference(**outs, **kw)


def provenance_bytes(kw, events, recorded):
    """The bytes a provenance round must move: both status planes, the
    epoch planes when on, the subjects' ids, ``leave_at``, both
    ``self_inc`` and ``join_at`` at their K self rows; per event the
    three keys, the new epoch when on and the row's ``ping_req`` byte
    when it splits; 24 B per recorded row; the two counters."""
    cells = MAIN_N * MAIN_K
    epoch = kw.get("prev_epoch")
    e_size = 0 if epoch is None else epoch.element_size()
    per_event = (3 * kw["fd"].element_size() + e_size
                 + (1 if kw["split_ping_req"] else 0))
    return (2 * cells + 2 * e_size * cells + 20 * MAIN_K + events * per_event
            + recorded * 4 * kprov.N_LANES + 16)


def check_provenance_observe(device):
    """Phase 3d, the provenance plane's round (``provenance_observe``, the
    third front end of ``csrc/trace_record.cu``) against its plain version
    at 1M x 16 (``provenance_inputs``): wide int32 keys with the ping-req
    split, the int16 wire's keys (dead bit 14), an int32 epoch lane and
    the compact carry's int16 lanes (int16 keys) with four join-rebirth
    columns, no ping-req members, self refutations and leavers under an
    observer offset, then dense, sparse, overflowing, one below capacity
    and at capacity; lanes, count and dropped exact, each case checked to
    reach its edge (its channels, JOINED rows with an epoch lane,
    SELF_REFUTATION rows at the bumped self rows only, a REMOVED row the
    timer's).  Then the sparse and dense rounds timed as the trace
    kernels' are."""
    names = {i: n for i, n in enumerate(provenance.CHANNEL_NAMES)}
    for (label, density, start, capacity, key, epoch, offset, split,
         joins, want) in PROVENANCE_OBSERVE_CASES:
        cap = MAIN_N * MAIN_K if capacity is None else capacity
        kw, got = provenance_inputs(density, start, cap, 9, device, key,
                                    epoch, offset, split, joins)
        wanted = {k: v.clone() for k, v in got.items()}
        provenance_call(kw, got)()
        provenance_plain(kw, wanted)()
        torch.cuda.synchronize()
        max_abs_err(f"provenance_observe {label}",
                    [got[n] for n in ("lanes", "count", "dropped")],
                    [wanted[n] for n in ("lanes", "count", "dropped")])
        count, dropped = int(got["count"]), int(got["dropped"])
        total = count - start + dropped - 5
        check_counters("provenance_observe", label, start, cap, total,
                       count, dropped)
        rows = got["lanes"][start:count].cpu()
        channels = collections.Counter(names[c] for c in rows[:, 4].tolist())
        types = collections.Counter(rows[:, 3].tolist())
        on_self = rows[rows[:, 0] == rows[:, 1]]
        refuted = on_self[on_self[:, 4] == provenance.CH_SELF_REFUTATION]
        timer = rows[(rows[:, 3] == int(TraceEventType.REMOVED))
                     & (rows[:, 4] == provenance.CH_FD_DIRECT)]
        edge = reaches_edge(label, start, cap, total, count, dropped,
                            MAIN_N * MAIN_K) and set(want) <= set(channels)
        if capacity is None:
            edge = (edge and len(refuted) == MAIN_K // 2
                    and int((on_self[:, 3] != int(
                        TraceEventType.ALIVE_REFUTED)).sum()) == MAIN_K // 2
                    and len(timer) > 0)
        if epoch is not None:
            edge = edge and types[int(TraceEventType.JOINED)] > 0
        if not edge:
            raise AssertionError(
                f"provenance_observe {label}: the case does not reach its "
                f"edge ({total} events, channels {dict(channels)}, types "
                f"{dict(types)}, {len(refuted)} self refutations, "
                f"{len(timer)} timer removals)")
        log(f"[kernel] provenance_observe {label} {MAIN_N}x{MAIN_K} (keys "
            f"{key}, epoch {epoch}, offset {offset}, ping-req split "
            f"{split}, joins {joins}): exact match (lanes, count, "
            f"dropped), {total} events, {start} -> {count} of {cap} rows, "
            f"dropped {dropped}, channels {dict(sorted(channels.items()))}")

    def timed(density, seed, reset):
        kw, outs = provenance_inputs(density, 0, MAIN_N * MAIN_K, seed,
                                     device, torch.int32)
        probe = {k: v.clone() for k, v in outs.items()}
        provenance_plain(kw, probe)()
        events = int(probe["count"])
        return timed_trace(provenance_call(kw, outs),
                           provenance_plain(kw, outs), outs["count"], reset,
                           events, provenance_bytes(kw, events, events),
                           OPS_PER_CELL["provenance_observe"])

    return trace_row("provenance_observe", timed)


def drill_params(provenance_on=True):
    """``bench.py --blame``'s params (bench.py:2490-2503): the chaos
    campaign's config at its N, scatter, every member probing every
    round, no ping-req proxies, the SYNC exchange every 8 rounds."""
    return swim.SwimParams.from_config(
        campaign.campaign_config(), n_members=DRILL_N, delivery="scatter",
        ping_known_only=False, ping_req_members=0, ping_every=1,
        sync_interval=8, provenance=provenance_on)


def drill_world(params, device):
    """The blame drill, ``chaos.blame_drill_scenario`` built by the DSL
    (as ``bench.py --blame`` builds it): one ``loss=1.0`` link rule from
    the victim to the observer over [onset, onset + pulse), padded with
    seven match-nothing rules, every other link clean."""
    scen = scenarios.blame_drill_scenario(
        DRILL_SEED, n=DRILL_N, victim=DRILL_VICTIM, observer=DRILL_OBSERVER,
        onset_round=DRILL_ONSET, pulse_rounds=DRILL_PULSE,
        cool_rounds=DRILL_HORIZON - DRILL_ONSET - DRILL_PULSE)
    return scen.build(params, device=device)[0]


def drill_run(params, dev):
    """The drill's ``run_composed`` on ``dev`` with the CPU-made draws
    (the provenance plane with the knob): ``(state, results, metrics,
    launches)``."""
    draws = prng.TorchDraws(DRILL_SEED, "cpu", params,
                            drill_world(params, "cpu"))
    LAUNCHES.clear()
    return compose.run_composed(
        DRILL_SEED, params, drill_world(params, dev), DRILL_HORIZON,
        with_monitor=False, with_provenance=params.provenance,
        provenance_capacity=DRILL_CAPACITY if params.provenance else None,
        draws=lambda r: draws(r).to(dev), device=dev) + (dict(LAUNCHES),)


def drill_path(device):
    """Phase 5d, ``bench.py --blame``'s drill at its own size (N = 48,
    seed 7, victim 3, observer 11, horizon 288; bench.py:2428-2700):
    ``run_composed`` with the trace, the default registry and the
    provenance plane (2,048 rows), on the card and on the CPU with the
    same CPU-made draws (the CPU's in a worker process), and on the card
    with the knob off.  The port's
    ``blame_report`` must name observer 11 as origin via ``fd_direct``,
    first-hand; ``channel_mix`` sum to 1.0; no provenance or trace drop;
    the ``explain_belief`` probe, over the rows a journal round trip gives
    back (``TelemetrySink.write_provenance``, ``sink.read_provenance``),
    resolve with ``fd_direct`` at the onset round; the knob off give the
    same final state and stacked metrics; the card's buffer (and trace,
    state, metrics) equal the CPU's; one ``provenance_observe`` a round.
    Returns the card's launches."""
    params, off = drill_params(), drill_params(False)
    g_state, g_res, g_m, launches = drill_run(params, device)
    c_state, c_res, c_m, _ = cpu_half("drill", "drill")
    o_state, o_res, o_m, _ = drill_run(off, device)
    tag = f"[drill] {DRILL_N}x{DRILL_N}"
    pv, tel = g_res["provenance"], g_res["trace"]
    for name in ("lanes", "count", "dropped"):
        if not torch.equal(getattr(pv, name).cpu(),
                           getattr(c_res["provenance"], name)):
            raise AssertionError(f"{tag}: provenance {name} card != CPU")
    telemetry_equal(f"{tag} trace card vs CPU", tel, c_res["trace"])
    for label, (s, m) in (("CPU", (c_state, c_m)),
                          ("knob off", (o_state, o_m))):
        for field in dataclasses.fields(swim.SwimState):
            if not torch.equal(getattr(s, field.name).cpu(),
                               getattr(g_state, field.name).cpu()):
                raise AssertionError(f"{tag}: state.{field.name} differs "
                                     f"from the {label} run's")
        if set(m) != set(g_m) or any(not torch.equal(m[k].cpu(),
                                                     g_m[k].cpu())
                                     for k in m):
            raise AssertionError(f"{tag}: metrics differ from the {label} "
                                 f"run's")
    telemetry_equal(f"{tag} trace knob on vs off", tel, o_res["trace"])
    rows = provenance.decode_attributions(pv)
    report = query.blame_report(rows, DRILL_VICTIM)
    mix = query.channel_mix(rows)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/blame.jsonl"
        with sink.TelemetrySink(path=path) as journal:
            journal.write_manifest(params, label="blame drill")
            journal.write_provenance(provenance.attributions_payload(pv))
        journal_rows, acct = sink.read_provenance(path)
    probe = query.explain_belief(journal_rows, DRILL_OBSERVER, DRILL_VICTIM,
                                 report.get("onset_round"))
    answer = probe["answer"] or {}
    want = {merge.NAMES["wide"]: DRILL_HORIZON,
            trace_kernel.OBSERVE: DRILL_HORIZON,
            kprov.NAME: DRILL_HORIZON}
    checks = {
        "origin": (report.get("origin_observer"),
                   report.get("origin_channel"),
                   report.get("origin_first_hand"))
        == (DRILL_OBSERVER, "fd_direct", True),
        "mix sums to 1": abs(sum(mix.values()) - 1.0) < 1e-12,
        "no drops": int(pv.dropped) == 0 and int(tel.trace.dropped) == 0,
        "journal": journal_rows == rows and acct["dropped"] == 0,
        "explain": (answer.get("channel"), answer.get("round"))
        == ("fd_direct", report.get("onset_round")),
        "launches": launches == want}
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{tag}: {failed} failed: report {report}, "
                             f"mix {mix}, drops {int(pv.dropped)} / "
                             f"{int(tel.trace.dropped)}, answer {answer}, "
                             f"launches {launches} (want {want})")
    log(f"{tag} scatter, seed {DRILL_SEED}, victim {DRILL_VICTIM} -> "
        f"observer {DRILL_OBSERVER} loss 1.0 over rounds [{DRILL_ONSET}, "
        f"{DRILL_ONSET + DRILL_PULSE}), horizon {DRILL_HORIZON}: blame "
        f"{json.dumps(report)}; channel_mix {json.dumps(mix)} (sum 1.0); "
        f"{int(pv.count)} attributions, 0 dropped; trace "
        f"{int(tel.trace.count)} events, 0 dropped; explain probe "
        f"{json.dumps(answer)}; knob off: state and metrics equal; card == "
        f"CPU (buffer, trace, state, metrics); launches {launches}")
    return launches


def provenance_crash_path(device):
    """Phase 6e, the slice's path at full width: ``bench_workload`` (LAN
    defaults, N = 1M x K = 16, loss 0.02, node 3 crashed at round 10,
    shift, wide) through ``run_composed`` with the trace, the default
    registry and the provenance plane, both buffers at
    ``PROV_CRASH_CAPACITY`` rows, for ``PROV_CRASH_ROUNDS`` rounds (node
    3's SUSPECTED and REMOVED waves), and the same stack with the knob
    off.  Gates: no provenance or trace drop; the channel counts sum to
    ``count``, which is the trace's count plus the self refutations; every
    record of the earliest round with a SUSPECTED row about node 3
    first-hand (``fd_direct`` or ``pingreq_proxy``); most of node 3's rows
    ``gossip`` or ``sync``; the knob off gives the same final state,
    stacked metrics, trace and registry; one ``provenance_observe``, one
    ``trace_observe`` and one merge a round.  Timing: the armed and the
    unarmed stack in turns (armed, unarmed, unarmed, armed),
    ``provenance_overhead_ratio`` (armed s / unarmed s, reported only);
    profiled ``PROV_PROFILE_ROUNDS``-round windows of both over a quiet
    stretch (from round ``PROV_QUIET_AT``) and over the SUSPECTED wave
    (from round ``CRASH_AT``): device busy ms and launches a round and the
    ``provenance.observe`` phase.  Returns the armed run's launches."""
    off = profile_round.bench_params("wide", MAIN_N, MAIN_K)
    params = dataclasses.replace(off, provenance=True)
    world = crash_world(params, device)
    cap, rounds = PROV_CRASH_CAPACITY, PROV_CRASH_ROUNDS

    def stack(p, n_rounds, state=None, start=0):
        return compose.run_composed(
            0, p, world, n_rounds, with_monitor=False,
            with_provenance=p.provenance, trace_capacity=cap,
            provenance_capacity=cap if p.provenance else None, state=state,
            start_round=start, device=device)

    stack(params, 2)                         # allocator and first calls
    stack(off, 2)
    arms = {"armed": params, "unarmed": off}
    turns, outputs, launches = [], {}, {}
    for name in ("armed", "unarmed", "unarmed", "armed"):
        torch.cuda.synchronize()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        out = stack(arms[name], rounds)
        torch.cuda.synchronize()
        turns.append((name, time.perf_counter() - t0))
        if name not in outputs:
            outputs[name] = out
            launches[name] = dict(LAUNCHES)
        del out
    (a_state, a_res, a_m), (u_state, u_res, u_m) = (outputs["armed"],
                                                   outputs["unarmed"])
    tag = f"[provenance crash] wide {MAIN_N}x{MAIN_K}, {rounds} rounds"
    for field in dataclasses.fields(swim.SwimState):
        if not torch.equal(getattr(a_state, field.name),
                           getattr(u_state, field.name)):
            raise AssertionError(f"{tag}: state.{field.name} differs with "
                                 f"the knob off")
    if set(a_m) != set(u_m) or any(not torch.equal(a_m[k], u_m[k])
                                   for k in a_m):
        raise AssertionError(f"{tag}: stacked metrics differ with the knob "
                             f"off")
    telemetry_equal(f"{tag} trace knob on vs off", a_res["trace"],
                    u_res["trace"])
    registry_equal(f"{tag} registry knob on vs off", a_res["metrics"],
                   u_res["metrics"])
    pv, tel = a_res["provenance"], a_res["trace"]
    count = int(pv.count)
    rows = pv.lanes[:count]
    by_channel = torch.bincount(rows[:, 4].long(),
                                minlength=len(provenance.CHANNEL_NAMES))
    channel_counts = dict(zip(provenance.CHANNEL_NAMES,
                              by_channel.cpu().tolist()))
    crashed = rows[rows[:, 1] == CRASHED]
    suspected = crashed[crashed[:, 3] == int(TraceEventType.SUSPECTED)]
    first_round = int(suspected[:, 5].min())
    first = rows[rows[:, 5] == first_round]
    first_hand = bool(((first[:, 4] == provenance.CH_FD_DIRECT)
                       | (first[:, 4] == provenance.CH_PINGREQ_PROXY)).all())
    relayed = int(((crashed[:, 4] == provenance.CH_GOSSIP)
                   | (crashed[:, 4] == provenance.CH_SYNC)).sum())
    types = collections.Counter(
        TraceEventType(t).name for t in crashed[:, 3].cpu().tolist())
    want = {merge.NAMES["wide"]: rounds, trace_kernel.OBSERVE: rounds,
            kprov.NAME: rounds}
    checks = {
        "no drops": int(pv.dropped) == 0 and int(tel.trace.dropped) == 0,
        "channels sum to count": sum(channel_counts.values()) == count,
        "count = trace + self refutations":
            count == int(tel.trace.count)
            + channel_counts["self_refutation"],
        "first sightings first-hand": first_hand,
        "mostly relayed": 2 * relayed > len(crashed),
        "launches": launches["armed"] == want}
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(
            f"{tag}: {failed} failed: count {count}, dropped "
            f"{int(pv.dropped)}, trace {int(tel.trace.count)} / "
            f"{int(tel.trace.dropped)}, channels {channel_counts}, first "
            f"round {first_round}: {first[:, 4].tolist()[:20]}, node "
            f"{CRASHED}: {len(crashed)} rows, {relayed} relayed, launches "
            f"{launches['armed']} (want {want})")
    mean_s = {name: statistics.mean(s for n, s in turns if n == name)
              for name in arms}
    first_channels = collections.Counter(
        provenance.CHANNEL_NAMES[c] for c in first[:, 4].cpu().tolist())
    del outputs, a_state, a_res, u_state, u_res, rows, pv, tel

    state_at = {}
    for at in (CRASH_AT, PROV_QUIET_AT):
        state_at[at], _ = swim.run(0, off, world, at, device=device)

    def runner(p):
        return lambda state, start, n: stack(p, n, state, start)

    windows = {f"{arm} {label}": profile_round.profile_window(
        p, world, state_at[at], at, PROV_PROFILE_ROUNDS, runner=runner(p))
        for label, at in (("wave", CRASH_AT), ("quiet", PROV_QUIET_AT))
        for arm, p in (("armed", params), ("unarmed", off))}
    summary = dict(
        card=card_line(), rounds=rounds, capacity=cap,
        buffer_bytes=cap * 4 * kprov.N_LANES,
        exposure_bytes=3 * MAIN_N * MAIN_K * 4,
        count=count, trace_count=count - channel_counts["self_refutation"],
        channel_counts=channel_counts,
        node3_types=dict(types), node3_rows=len(crashed),
        node3_relayed=relayed, first_suspected_round=first_round,
        first_round_channels=dict(first_channels),
        ms_per_round={name: s / rounds * 1e3 for name, s in mean_s.items()},
        provenance_overhead_ratio=mean_s["armed"] / mean_s["unarmed"],
        turns_ms_per_round=[(name, s / rounds * 1e3) for name, s in turns],
        windows={label: dict(
            busy_ms=w["device_busy_ms_per_round"],
            launches=w["kernel_launches_per_round"],
            wall_ms=w["wall_ms_per_round"], idle=w["device_idle_share"],
            phases=w["phase_device_ms_per_round"],
            phase_launches=w["phase_launches_per_round"])
            for label, w in windows.items()},
        extra_over_unarmed={label: dict(
            busy_ms=windows[f"armed {label}"]["device_busy_ms_per_round"]
            - windows[f"unarmed {label}"]["device_busy_ms_per_round"],
            launches=windows[f"armed {label}"]["kernel_launches_per_round"]
            - windows[f"unarmed {label}"]["kernel_launches_per_round"],
            observe_ms=windows[f"armed {label}"][
                "phase_device_ms_per_round"].get("provenance.observe"))
            for label in ("wave", "quiet")})
    log(f"[provenance crash] {json.dumps(summary)}")
    log(f"{tag}: {count} attributions, 0 dropped ({cap} rows, "
        f"{cap * 4 * kprov.N_LANES} B), channels {channel_counts} (sum = "
        f"count = trace {count - channel_counts['self_refutation']} + self "
        f"refutations); node {CRASHED}: {dict(types)}, {relayed} of "
        f"{len(crashed)} via gossip or sync; first SUSPECTED round "
        f"{first_round}: {dict(first_channels)}; knob off: state, metrics, "
        f"trace and registry equal; ms/round "
        f"{json.dumps(summary['ms_per_round'])}, provenance_overhead_ratio "
        f"{summary['provenance_overhead_ratio']:.4f} ({summary['card']}); "
        f"extra over unarmed a round "
        f"{json.dumps(summary['extra_over_unarmed'])}")
    return launches["armed"]


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "smoke run needs a CUDA card")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--merge-baseline", metavar="PATH",
                    help="also time the plane-off merge against an earlier "
                         "merge_timers.cu (merge_ab)")
    args = ap.parse_args()
    t_start = time.perf_counter()
    pool = concurrent.futures.ProcessPoolExecutor(
        CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_cpu_worker_init)
    try:
        start_cpu_halves(pool)
        run_phases(args, t_start)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def run_phases(args, t_start):
    """Every phase after the CPU halves are submitted, then the kernels
    line and the result line."""
    device = swim.resolve_device("cuda")
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    sources = [merge.SOURCE, carry.SOURCE, probes.SOURCE, trace_kernel.SOURCE]
    logs = _build.build(sources)
    log(f"[build] {', '.join(s + '.cu' for s in sources)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        log(f"[build] nvcc {name}: {' '.join(text.split())}")

    merge_rows = {layout: dict(check_merge_kernel(device, layout),
                               **check_block_merge(device, layout))
                  for layout in ("wide", "int16_wire", "compact_wire24")}
    if args.merge_baseline:
        merge_ab(device, args.merge_baseline)
    codec_rows = check_codec(device)
    for name, row in check_block_codec(device).items():
        codec_rows[name].update(row)
    trace_rows = {trace_kernel.NAME: check_trace_record(device),
                  trace_kernel.OBSERVE: check_trace_observe(device),
                  kprov.NAME: check_provenance_observe(device)}
    trace_rows[trace_kernel.NAME].update(check_monitor_record(device))
    stage("kernels", t_start)
    probe_launches, probe_rows = probe_path(device)
    stage("probes", t_start)
    canaries(device)
    paths = {"traced_canaries": traced_canaries(device),
             "monitor_canaries": monitor_canaries(device),
             "drill": drill_path(device)}
    stage("canaries and the blame drill", t_start)
    paths["main"], shift_summary = main_path(device)
    stage("main path", t_start)
    paths["traced_window"], paths["record_api"] = traced_window_path(device)
    paths["telemetry"] = telemetry_path(device)
    stage("traced window and telemetry", t_start)
    paths["instrumented_stack"] = instrumented_stack_path(device)
    stage("instrumented stack", t_start)
    paths["provenance_crash"] = provenance_crash_path(device)
    stage("attributed crash", t_start)
    paths["storm"] = storm_path(device, shift_summary)
    paths["bench_churn"] = bench_churn_path(device)
    stage("churn storm", t_start)
    paths["network"], network_summary = network_path(device)
    stage("network path", t_start)
    paths["heal"] = heal_path(device)
    paths["lifeguard_network"] = lifeguard_network_path(device,
                                                        network_summary)
    stage("planes at full width", t_start)
    paths["rollout"] = rollout_path(device)
    paths["bench_rollout"] = bench_rollout_path(device)
    stage("metadata rollout", t_start)
    paths["chaos"] = chaos_campaign_path(device)
    paths["fuzz"] = fuzz_path(device)
    paths["lifeguard"] = lifeguard_path(device)
    paths["dsl_scale"] = dsl_scale_path(device)
    stage("chaos layer", t_start)
    paths["cold_start"] = cold_start_path(device)
    paths["scatter_main"], scatter_summary = main_path(
        device, "scatter", narrow=("int16_wire",))
    log(f"[scatter main] node {CRASHED}, wide: first SUSPECT at round "
        f"{scatter_summary['first_suspect']} (shift "
        f"{shift_summary['first_suspect']}), DEAD share at round "
        f"{MAIN_ROUNDS} {scatter_summary['dead_share']:.6f} (shift "
        f"{shift_summary['dead_share']:.6f})")
    paths["scatter_cold_start"] = cold_start_path(device, "scatter")
    stage("cold starts and scatter", t_start)
    paths["k_block_pair"] = blocked_pair(device)
    paths["k_block_pair_planes"] = blocked_pair(device, planes=True)
    paths["capacity"] = capacity_path(device)
    stage("k_block pair and capacity", t_start)
    paths["gossip"] = gossip_path(device)
    stage("gossip simulator", t_start)
    launches = {}
    for counts in paths.values():
        for name, count in counts.items():
            launches[name] = launches.get(name, 0) + count

    kernels = []
    for layout, fmt in (("wide", "wide"), ("int16_wire", "wire16"),
                        ("compact_wire24", "wire24")):
        kernels.append(dict(
            name=merge.NAMES[fmt], route="cuda",
            source=CSRC + "merge_timers.cu",
            replaces="experiments/merge_kernel_bench.py:102",
            launches=launches.get(merge.NAMES[fmt], 0),
            launches_by_path={path: counts.get(merge.NAMES[fmt], 0)
                              for path, counts in paths.items()},
            **merge_rows[layout]))
    for name, line in ((carry.DECODE, 1570), (carry.ENCODE, 1595)):
        kernels.append(dict(
            name=name, route="cuda", source=CSRC + "carry_codec.cu",
            replaces=f"scalecube_cluster_tpu/models/swim.py:{line}",
            launches=launches.get(name, 0),
            launches_by_path={path: counts.get(name, 0)
                              for path, counts in paths.items()},
            **codec_rows[name]))
    for name, replaces in (
            (trace_kernel.NAME, "telemetry/trace.py:254"),
            (trace_kernel.OBSERVE, "telemetry/trace.py:166"),
            (kprov.NAME, "models/provenance.py:324")):
        kernels.append(dict(
            name=name, route="cuda", source=CSRC + "trace_record.cu",
            replaces=f"scalecube_cluster_tpu/{replaces}",
            launches=launches.get(name, 0),
            launches_by_path={path: counts.get(name, 0)
                              for path, counts in paths.items()},
            **trace_rows[name]))
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
    log(f"[clock] {len(EVENT_CLOCK_FALLBACKS)} device-clock timings fell "
        f"back to CUDA events: {EVENT_CLOCK_FALLBACKS}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
