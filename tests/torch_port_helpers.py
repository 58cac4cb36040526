"""Shared helpers of the tests that hold the PyTorch port
(``scalecube_cluster_tpu_torch``) against the JAX package.

Both sides get the same inputs: parameters and worlds cross over as
plain data (``interop``), and each round's randomness is rebuilt from the
JAX key with the reference's own ``jax.random`` calls and handed to the
port as a ``RoundDraws``.  Everything compared is an integer or a
compare of identical float32 draws against identical float32
probabilities, so every comparison is exact equality.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalecube_cluster_tpu.ops import prng as jprng
from scalecube_cluster_tpu_torch import interop
from scalecube_cluster_tpu_torch.ops.prng import (DrawFacts, RoundDraws,
                                                  ScatterDraws)

STATE_FIELDS = ("status", "inc", "spread_until", "suspect_deadline",
                "self_inc", "inbox_ring", "flag_ring", "g_infected",
                "g_spread_until", "g_ring", "lhm", "epoch", "md", "md_spread")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's CPU tests (the suite runs
    several xdist workers side by side), restored after the module so
    other test files in the worker keep the default."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def jax_draws(key, params, world=None):
    """``round_idx -> RoundDraws`` (or ``ScatterDraws`` under scatter
    delivery) holding exactly the draws the reference tick consumes
    under ``key`` for ``params`` and ``world`` (the JAX objects; which
    fields follow from ``prng.DrawFacts``), with the reference's own
    calls (shift, models/swim.py: round keys :1908-1911, channel
    shifts :1920-1924 + :3609-3616; FD chains under keys[1] and
    fold_in(keys[3], r), collapsed :1687 or delayed :1691; drop draws
    :3770; refute drop :3894; delay bins fold_in(keys[5], 11 + c)
    :3845, fold_in(keys[7], 13) :3901, fold_in(keys[7], 11) :3968; seed
    anti-entropy fold_in(keys[7], 29) split in three :2583-2620; the
    planes' draws as :func:`_plane_draws` says).  Unit exponentials are
    ``-jnp.log1p(-u)``, as the reference computes them."""
    facts = DrawFacts.of(params, world)
    if facts.delivery == "scatter":
        return _jax_scatter_draws(key, params, facts)
    one = _shift_draw_program(params.n_members, params.ping_req_members,
                              params.fanout, facts)

    def draws(round_idx):
        out = {name: np.array(value)
               for name, value in one(key, jnp.int32(round_idx)).items()}
        shifts = tuple(int(s) for s in out.pop("shifts"))
        fields = dict(u_direct=None, u_proxy=None)
        if "ae_offset" in out:
            fields["ae_offset"] = int(out.pop("ae_offset"))
        fields.update((name, torch.from_numpy(value))
                      for name, value in out.items())
        return RoundDraws(shifts=shifts, **fields)

    return draws


@functools.lru_cache(maxsize=None)
def _shift_draw_program(n, r, f, facts):
    """The shift round's draw program for these static facts, built once
    a process (the key is an argument, so cases that differ only in
    layout or key share it)."""

    @jax.jit
    def one(key, round_idx):
        rk = jprng.round_key(key, round_idx)
        keys = jax.random.split(jprng.round_key(rk, 0), 8)
        k_shifts = jax.random.fold_in(rk, 0x5317)
        out = dict(
            shifts=jax.random.randint(k_shifts, (1 + r + f + 1,), 1, n,
                                      dtype=jnp.int32))
        if facts.delayed:
            u = jax.random.uniform(keys[1], (n, 4))
            up = jnp.stack([jax.random.uniform(
                jax.random.fold_in(keys[3], i), (n, 8)) for i in range(r)]
            ) if r else jnp.zeros((0, n, 8), jnp.float32)
            out.update(chain_u_direct=u[:, :2],
                       chain_e_direct=unit_exp(u[:, 2:]),
                       chain_u_proxy=up[..., :4],
                       chain_e_proxy=unit_exp(up[..., 4:]))
        else:
            out.update(
                u_direct=jax.random.uniform(keys[1], (n,)),
                u_proxy=jnp.stack([
                    jax.random.uniform(jax.random.fold_in(keys[3], i), (n,))
                    for i in range(r)]) if r else jnp.zeros((0, n),
                                                            jnp.float32))
        out.update(drop_u=jax.random.uniform(keys[5], (n, f + 1)),
                   u_refute=jax.random.uniform(keys[7], (n,)))
        if facts.delay_bins:
            def bin_e(k, i):
                return unit_exp(jax.random.uniform(jax.random.fold_in(k, i),
                                                   (n,)))
            out.update(e_gossip=jnp.stack([bin_e(keys[5], 11 + c)
                                           for c in range(f)]),
                       e_sync=bin_e(keys[7], 11), e_refute=bin_e(keys[7], 13))
        if facts.n_seeds:
            out.update(_seed_draws(keys, n, facts.n_seeds))
        out.update(_plane_draws(k_shifts, keys, n, facts))
        return out

    return one


def unit_exp(u):
    return -jnp.log1p(-u)


def _seed_draws(keys, n, n_seeds):
    """The seed anti-entropy's draws under fold_in(keys[7], 29), split in
    three (models/swim.py:2583-2620), in either delivery mode."""
    k_sel, k_push, k_ack = jax.random.split(jax.random.fold_in(keys[7], 29),
                                            3)
    return dict(
        seed_sel=jax.random.randint(k_sel, (n,), 0, n_seeds),
        seed_push_u=jnp.stack([jax.random.uniform(
            jax.random.fold_in(k_push, si), (n,)) for si in range(n_seeds)]),
        seed_ack_u=jnp.stack([jax.random.uniform(
            jax.random.fold_in(k_ack, si), (n,)) for si in range(n_seeds)]))


def _plane_draws(k_shifts, keys, n, facts):
    """The planes' draws, from the reference's folds.  The anti-entropy
    offset: ``randint(fold_in(k_shifts, sync._OFFSET_FOLD = 0x53CA), (),
    1, N)`` (models/sync.py:121, :151-164; ``k_shifts`` is the round's
    channel key, fold_in(round key, 0x5317), models/swim.py:1920, the
    scatter tick's ``k_channel`` :2894).  Its drop uniforms under
    ``fold_in(keys[7], sync._DROP_FOLD = 41)`` (sync.py:122, :167-170):
    shift, one ``uniform((N,))`` a direction under a further fold_in by
    the direction, [2, N] (models/swim.py:4008-4009); scatter,
    ``bernoulli_mask``'s one ``uniform((N, 2))`` (:2903-2905).
    Lifeguard's probe gate: ``uniform(fold_in(keys[1], lifeguard.
    _PROBE_GATE_FOLD = 0x11F6), (N,))`` (lifeguard.py:69, :104-107;
    keys[1] is the tick's ``k_ping_net``)."""
    out = {}
    if facts.sync_plane:
        k_drop = jax.random.fold_in(keys[7], 41)
        out["ae_offset"] = jax.random.randint(
            jax.random.fold_in(k_shifts, 0x53CA), (), 1, n, dtype=jnp.int32)
        if facts.delivery == "shift":
            out["ae_drop_u"] = jnp.stack([jax.random.uniform(
                jax.random.fold_in(k_drop, d), (n,)) for d in range(2)])
        else:
            out["ae_drop_u"] = jax.random.uniform(k_drop, (n, 2))
    if facts.lifeguard:
        out["lhm_gate_u"] = jax.random.uniform(
            jax.random.fold_in(keys[1], 0x11F6), (n,))
    return out


def _jax_scatter_draws(key, params, facts):
    """The scatter round's draws (models/swim.py:2684-2871, the dispatch
    passing keys[0] as the probe key, :2117-2125): keys[0] the probe
    target (``gumbel`` [N, K] known-only, else ``randint`` [N, 1]),
    keys[1] the direct chain, keys[2] the proxies, keys[3] one
    ``uniform`` [N, R] (or [N, R, 8] delayed) for the proxy chains,
    keys[4] the gossip targets, keys[5] the gossip drops and their delay
    bins under fold_in(keys[5], 7) (ops/ring.py:21), keys[6] the SYNC
    target, keys[7] its drop, bins under fold_in(keys[7], 7) and the seed
    exchange under fold_in(keys[7], 29).  Targets are the raw
    ``randint(0, N - 1)`` draws of ``prng.targets_excluding_self``."""
    one = _scatter_draw_program(params.n_members, params.n_subjects,
                                params.ping_req_members, params.fanout,
                                facts)

    def draws(round_idx):
        out = {name: np.array(value)
               for name, value in one(key, jnp.int32(round_idx)).items()}
        if "ae_offset" in out:
            out["ae_offset"] = int(out["ae_offset"])
        return ScatterDraws(**{
            name: value if isinstance(value, int) else torch.from_numpy(value)
            for name, value in out.items()})

    return draws


@functools.lru_cache(maxsize=None)
def _scatter_draw_program(n, k, r, f, facts):
    """The scatter round's draw program for these static facts, built
    once a process."""

    def targets(kk, width):
        return jax.random.randint(kk, (n, width), 0, n - 1)

    @jax.jit
    def one(key, round_idx):
        rk = jprng.round_key(key, round_idx)
        keys = jax.random.split(jprng.round_key(rk, 0), 8)
        out = dict(proxies=targets(keys[2], r), gossip_t=targets(keys[4], f),
                   gossip_drop_u=jax.random.uniform(keys[5], (n, f)),
                   sync_t=targets(keys[6], 1)[:, 0],
                   sync_drop_u=jax.random.uniform(keys[7], (n,)))
        if facts.known_only:
            out["ping_gumbel"] = jax.random.gumbel(keys[0], (n, k))
        else:
            out["ping_t"] = targets(keys[0], 1)[:, 0]
        if facts.delayed:
            u = jax.random.uniform(keys[1], (n, 4))
            up = jax.random.uniform(keys[3], (n, r, 8))
            out.update(chain_u_direct=u[:, :2],
                       chain_e_direct=unit_exp(u[:, 2:]),
                       proxy_chain_u=up[..., :4],
                       proxy_chain_e=unit_exp(up[..., 4:]))
        else:
            out.update(u_direct=jax.random.uniform(keys[1], (n,)),
                       proxy_u=jax.random.uniform(keys[3], (n, r)))
        if facts.delay_bins:
            out.update(
                gossip_e=unit_exp(jax.random.uniform(
                    jax.random.fold_in(keys[5], 7), (n, f))),
                e_sync=unit_exp(jax.random.uniform(
                    jax.random.fold_in(keys[7], 7), (n,))))
        if facts.n_seeds:
            out.update(_seed_draws(keys, n, facts.n_seeds))
        out.update(_plane_draws(jax.random.fold_in(rk, 0x5317), keys, n,
                                facts))
        return out

    return one


def jax_gossip_draws(key, params, n_rounds):
    """``round_idx -> GossipDraws`` holding exactly the draws the
    reference's gossip tick consumes under ``key`` for the reference's
    ``GossipSimParams`` over rounds 0 .. ``n_rounds - 1``
    (models/gossip.py:136-166): ``fold_in(key, r)`` split in three, the
    raw ``randint(0, N - 1)`` targets of ``prng.targets_excluding_self``,
    the drop ``uniform`` of ``bernoulli_mask``, and with the ring on the
    delay ``uniform`` of ``ring.delay_bins`` as ``-log1p(-u)``, made by
    XLA.  One program a shape, built once a process."""
    from scalecube_cluster_tpu_torch.models.gossip import GossipDraws

    one = _gossip_draw_program(params.n_members, params.fanout,
                               params.max_delay_rounds > 0)
    rounds = [{name: torch.from_numpy(np.array(value))
               for name, value in one(key, jnp.int32(r)).items()}
              for r in range(n_rounds)]

    def draws(round_idx):
        return GossipDraws(**rounds[round_idx])

    return draws


@functools.lru_cache(maxsize=None)
def _gossip_draw_program(n, f, delayed):
    @jax.jit
    def one(key, round_idx):
        k_targets, k_drop, k_delay = jax.random.split(
            jprng.round_key(key, round_idx), 3)
        out = dict(targets=jax.random.randint(k_targets, (n, f), 0, n - 1),
                   drop_u=jax.random.uniform(k_drop, (n, f)))
        if delayed:
            out["delay_e"] = unit_exp(jax.random.uniform(k_delay, (n, f)))
        return out

    return one


def port_params(jax_params):
    return interop.params_from_fields(dataclasses.asdict(jax_params))


def port_world(jax_world):
    """The reference world carried over as numpy arrays, on the CPU."""
    arrays = {f.name: np.asarray(getattr(jax_world, f.name))
              for f in dataclasses.fields(jax_world)
              if f.name != "faults" and getattr(jax_world, f.name) is not None}
    arrays["faults"] = {f.name: np.asarray(getattr(jax_world.faults, f.name))
                        for f in dataclasses.fields(jax_world.faults)}
    return interop.world_from_arrays(arrays, device="cpu")


def assert_state_equal(jax_state, port_state):
    for name in STATE_FIELDS:
        want = np.asarray(getattr(jax_state, name))
        got = getattr(port_state, name).cpu().numpy()
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)


def assert_metrics_equal(jax_metrics, port_metrics, rounds=slice(None)):
    assert set(port_metrics) == set(jax_metrics)
    for name, value in jax_metrics.items():
        want = np.asarray(value)[rounds]
        got = port_metrics[name].cpu().numpy()
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)


MONITOR_FIELDS = ("lanes", "count", "dropped", "code_counts",
                  "code_first_round")


def port_monitor_spec(jax_spec):
    """A reference ``chaos.monitor.MonitorSpec`` as the port's, on the
    CPU."""
    from scalecube_cluster_tpu_torch.chaos import monitor

    return monitor.MonitorSpec(
        complete_by=torch.from_numpy(np.array(jax_spec.complete_by)),
        agree_from=int(jax_spec.agree_from),
        check_agreement=jax_spec.check_agreement,
        check_false_suspicion=jax_spec.check_false_suspicion,
        join_known_by=torch.from_numpy(np.array(jax_spec.join_known_by)),
        check_joins=jax_spec.check_joins)


def assert_monitor_equal(jax_mon, port_mon):
    """Every field of a port ``MonitorState`` equals the reference's, and
    so do their ``verdict``s."""
    from scalecube_cluster_tpu.chaos import monitor as jmonitor
    from scalecube_cluster_tpu_torch.chaos import monitor

    for name in MONITOR_FIELDS:
        want = np.asarray(getattr(jax_mon, name))
        got = getattr(port_mon, name).cpu().numpy()
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert monitor.verdict(port_mon, 10**6) == jmonitor.verdict(jax_mon,
                                                                 10**6)


def assert_registry_equal(jax_ms, port_ms, skip=()):
    """A port ``MetricsState`` equals the reference's: every counter (but
    those named in ``skip``), gauge (float32 bits) and histogram."""
    from scalecube_cluster_tpu.telemetry import metrics as jmetrics

    spec = jmetrics.MetricsSpec.default()
    keep = [i for i, name in enumerate(spec.counters) if name not in skip]
    for name, want, got in (
            ("counters", np.asarray(jax_ms.counters)[keep],
             port_ms.counters.cpu().numpy()[keep]),
            ("gauges", np.asarray(jax_ms.gauges),
             port_ms.gauges.cpu().numpy())):
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert set(port_ms.hists) == set(jax_ms.hists)
    for name, value in jax_ms.hists.items():
        np.testing.assert_array_equal(port_ms.hists[name].cpu().numpy(),
                                      np.asarray(value), err_msg=name)
