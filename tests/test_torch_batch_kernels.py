"""The batch forms of the record kernels (``kernels/trace.
trace_record_batch``, ``trace_observe_batch``) and the monitor's batched
checks, on the CPU.

- each batch wrapper equals its one-round wrapper run row by row (the
  plain versions), rows empty, dense, sparse, overflowing partway, one
  below and at capacity, with and without subject ids and epoch lanes;
- the wrappers refuse mismatched shapes;
- the monitor's checks over a batch (``chaos/monitor._BatchFacts``)
  equal its serial checks row by row, and a batch of specs with
  different check flags is refused.

On the card ``chip_smoke.py`` (phase 3e) holds the kernels against these
plain versions.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from scalecube_cluster_tpu_torch.chaos import monitor  # noqa: E402
from scalecube_cluster_tpu_torch.kernels import trace as tk  # noqa: E402
from scalecube_cluster_tpu_torch.models import compose, swim  # noqa: E402
from tests.test_swim_model import fast_config  # noqa: E402
from tests.torch_port_helpers import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torchport

B, N, K, CAP, ROUND = 6, 16, 8, 64, 37
# Row b's (event density, rows already recorded).
ROWS = ((0.0, 0), (0.9, 0), (0.05, 0), (0.6, 40), (0.05, CAP - 1),
        (0.05, CAP))


def _buffers(starts, k=K):
    g = torch.Generator().manual_seed(1)
    lanes = torch.randint(0, 100, (B, CAP, tk.N_LANES), generator=g,
                          dtype=torch.int32)
    return (lanes, torch.tensor(starts, dtype=torch.int32),
            torch.full((B,), 5, dtype=torch.int32))


def _rows_of(fn, *buffers):
    """``fn(b, lanes, count, dropped)`` on each row of cloned buffers."""
    lanes, count, dropped = (t.clone() for t in buffers)
    for b in range(B):
        fn(b, lanes[b], count[b], dropped[b])
    return lanes, count, dropped


def _assert_all_equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("self_lanes", [False, True])
def test_record_batch_equals_rows(self_lanes):
    g = torch.Generator().manual_seed(2)
    k = 1 if self_lanes else K
    codes = torch.stack([
        torch.where(torch.rand((N, k), generator=g) < d,
                    torch.randint(1, 7, (N, k), generator=g), 0)
        for d, _ in ROWS]).to(torch.int8)
    incs = torch.randint(-50, 50, (B, N, k), generator=g, dtype=torch.int32)
    sids = None if self_lanes else torch.stack(
        [torch.randperm(N, generator=g)[:K].to(torch.int32)
         for _ in range(B)])
    buffers = _buffers([s for _, s in ROWS], k)
    got = tuple(t.clone() for t in buffers)
    tk.trace_record_batch(*got, codes, incs, sids, ROUND)
    want = _rows_of(lambda b, *buf: tk.trace_record(
        *buf, codes[b], incs[b], None if sids is None else sids[b], ROUND),
        *buffers)
    _assert_all_equal(got, want)
    assert got[1].tolist()[4:] == [CAP, CAP]
    assert self_lanes or int(got[1][3]) == CAP


@pytest.mark.parametrize("epoch", [None, torch.int16])
def test_observe_batch_equals_rows(epoch):
    g = torch.Generator().manual_seed(3)
    prev = torch.randint(0, 4, (B, N, K), generator=g, dtype=torch.int8)
    new = torch.stack([torch.where(torch.rand((N, K), generator=g) < d,
                                   (prev[b] + 1) % 4, prev[b])
                       for b, (d, _) in enumerate(ROWS)]).to(torch.int8)
    sids = torch.stack([torch.randperm(N, generator=g)[:K].to(torch.int32)
                        for _ in range(B)])
    leave_at = torch.full((B, N), 2**31 - 1, dtype=torch.int32)
    leave_at[1:, 2] = ROUND
    kw = dict(prev_status=prev, new_status=new,
              new_inc=torch.randint(0, 9, (B, N, K), generator=g,
                                    dtype=torch.int32),
              self_inc=torch.randint(0, 9, (B, N), generator=g,
                                     dtype=torch.int32),
              leave_at=leave_at, subject_ids=sids)
    if epoch is not None:
        kw["prev_epoch"] = torch.randint(0, 3, (B, N, K), generator=g,
                                         dtype=epoch)
        kw["new_epoch"] = (kw["prev_epoch"] + (torch.rand(
            (B, N, K), generator=g) < 0.1)).to(epoch)
    firsts = [torch.where(torch.rand((B, N, K), generator=g) < 0.5,
                          2**31 - 1, 3).to(torch.int32) for _ in range(2)]
    buffers = _buffers([s for _, s in ROWS])
    got = tuple(t.clone() for t in buffers) + tuple(f.clone()
                                                    for f in firsts)
    tk.trace_observe_batch(*got, round_idx=ROUND, **kw)
    want_first = [f.clone() for f in firsts]

    def row(b, lanes, count, dropped):
        tk.trace_observe(lanes, count, dropped, want_first[0][b],
                         want_first[1][b], round_idx=ROUND,
                         **{name: v[b] for name, v in kw.items()})

    want = _rows_of(row, *buffers) + tuple(want_first)
    _assert_all_equal(got, want)
    assert int(got[1][1]) > 0 and (epoch is not None or int(got[1][0]) == 0)


def test_batch_wrappers_refuse_mismatched_shapes():
    codes = torch.zeros((B, N, K), dtype=torch.int8)
    incs = torch.zeros((B, N, K), dtype=torch.int32)
    sids = torch.zeros((B, K), dtype=torch.int32)
    lanes, count, dropped = _buffers([0] * B)
    with pytest.raises(ValueError, match="codes must be"):
        tk.trace_record_batch(lanes, count, dropped, codes[0], incs[0],
                              sids[0], ROUND)
    with pytest.raises(ValueError, match="lanes must be"):
        tk.trace_record_batch(lanes[0], count, dropped, codes, incs, sids,
                              ROUND)
    with pytest.raises(ValueError, match="count must have shape"):
        tk.trace_record_batch(lanes, count[:2], dropped, codes, incs, sids,
                              ROUND)
    with pytest.raises(ValueError, match="self lanes"):
        tk.trace_record_batch(lanes, count, dropped, codes, incs, None,
                              ROUND)


def _monitor_inputs():
    """Three rows' (prev, new) wide carries after a few rounds of three
    worlds, their knobs and specs."""
    params = swim.SwimParams.from_config(fast_config(), n_members=N,
                                         delivery="shift",
                                         loss_probability=0.2)
    worlds = [swim.SwimWorld.healthy(params, device="cpu").with_crash(b, 2)
              for b in range(3)]
    knobs = [swim.Knobs.for_params(params, suspicion_rounds=s)
             for s in (30, 2, 9)]
    specs = []
    for b in range(3):
        cb = torch.full((N,), 2**31 - 1, dtype=torch.int32)
        cb[b] = 6 + b
        specs.append(monitor.MonitorSpec(complete_by=cb,
                                         check_false_suspicion=True))
    states = [swim.run(b, params, w, 8, knobs=kn, device="cpu")[0]
              for b, (w, kn) in enumerate(zip(worlds, knobs))]
    nexts = [swim.run(b, params, w, 1, state=st, start_round=8, knobs=kn,
                      device="cpu")[0]
             for b, (w, kn, st) in enumerate(zip(worlds, knobs, states))]
    return params, worlds, knobs, specs, states, nexts


def test_batched_checks_equal_serial_checks():
    """``check_cells`` over the stacked batch: every code's cells and
    detail plane, the self lanes and the totals equal the serial checks
    of each row."""
    params, worlds, knobs, specs, states, nexts = _monitor_inputs()
    stacked = compose.StackedWorld(worlds)
    facts = monitor._BatchFacts(specs, stacked, N)
    cells, self_lanes, totals = monitor.check_cells(
        None, params, knobs, 8, compose.stack_rows(states),
        compose.stack_rows(nexts), stacked, facts=facts)
    assert int(totals.sum()) > 0
    for b in range(3):
        c1, s1, t1 = monitor.check_cells(specs[b], params, knobs[b], 8,
                                         states[b], nexts[b], worlds[b])
        assert torch.equal(totals[b], t1)
        serial = {int(code): (vio, detail) for code, vio, detail in c1}
        for code, vio, detail in cells:
            if int(code) in serial:
                assert torch.equal(vio[b], serial[int(code)][0]), code
                assert torch.equal(detail()[b], serial[int(code)][1]()), code
            else:
                assert not vio[b].any(), code
        for (_, v), (_, v1) in zip(self_lanes, s1):
            assert torch.equal(v[b], v1)
    flagged = dataclasses.replace(specs[1], check_false_suspicion=False)
    with pytest.raises(ValueError, match="check flags"):
        monitor._BatchFacts([specs[0], flagged, specs[2]], stacked, N)
