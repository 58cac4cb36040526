"""The staged config rollout of ``chip_smoke.py`` (``rollout_world``:
``bench.py --rollout``'s scenario) built and run by the JAX reference on
the CPU: :func:`reference_rollout` is the reference's own ``Scenario``
(``bench.py:1834-1870``), which the tests hold ``rollout_world`` against,
and run as a script it gives the reference's verdict at a size the CPU
affords, beside which the port's run on the card is read.

Run: ``JAX_PLATFORMS=cpu python -m tests.torch_rollout_reference --n 48``.
Prints, for the gated arm, each push's converged round (polled every 2
rounds, as the bench does), ``metadata_convergence_p99`` and the
divergence probe at the horizon, and the gossip-only control's probe;
then the same for the port (``chip_smoke.rollout_gated`` and
``models.swim.run``) on the reference's world (its match-nothing link
rules included) and the reference's draws (``jax_draws``), with whether
its final states equal the reference's.
"""

import argparse

import jax
import numpy as np

from scalecube_cluster_tpu.chaos import campaign as jcampaign
from scalecube_cluster_tpu.chaos import scenarios as jscenarios
from scalecube_cluster_tpu.models import metadata as jmetadata
from scalecube_cluster_tpu.models import swim as jswim

SEED, SYNC_INTERVAL, VALUE = 11, 8, 641


def reference_rollout(n, n_stages=3, stage_size=4, seed=SEED,
                      sync_interval=SYNC_INTERVAL):
    """``bench.py --rollout``'s scenario at ``n`` members, as the bench
    builds it: returns ``(scenario, params, world, rollout, heal_at,
    bound)``."""
    cfg = jcampaign.campaign_config()
    p0 = jswim.SwimParams.from_config(
        cfg, n_members=n, delivery="shift", sync_every=0,
        sync_interval=SYNC_INTERVAL, metadata_keys=1)
    phase = -(-jscenarios.quiesce_bound(p0, n) // 16) * 16
    bound = jscenarios.metadata_convergence_bound(p0, n)
    stage_every = -(-bound // 16) * 16
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x19C0]))
    perm = [int(x) for x in rng.permutation(n)]
    storm = jscenarios.ChurnStorm(
        nodes=tuple(perm[:4]), wave_size=2, start_round=8, wave_every=24,
        down_rounds=jscenarios.quiesce_bound(p0, n))
    rollout = jscenarios.StagedRollout(
        members=tuple(perm[4:4 + n_stages * stage_size]), n_stages=n_stages,
        key=0, value=VALUE, start_round=phase + phase // 2,
        stage_every=stage_every, rollback_value=7)
    rollout.validate_gate(p0, n)
    last_stage = rollout.stage_round(n_stages - 1)
    horizon = -(-(max(last_stage, 2 * phase) + bound + 32) // 64) * 64
    scen = jscenarios.Scenario(
        name=f"config-rollout-n{n}", n_members=n, horizon=horizon,
        ops=(storm, jscenarios.RollingPartition(
            from_round=phase, phase_rounds=phase, n_cycles=1), rollout),
        seed=seed)
    params = jcampaign.campaign_params(scen, delivery="shift", sync_every=0,
                                       sync_interval=sync_interval)
    world, _ = scen.build(params)
    return scen, params, world, rollout, 2 * phase, bound


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=48)
    args = ap.parse_args(argv)
    scen, params, world, rollout, heal_at, bound = reference_rollout(args.n)
    key = jax.random.key(SEED)
    split_at = heal_at // 2
    pushes = []
    for owner, _, value, at in rollout.push_schedule():
        clock = heal_at if split_at <= at < heal_at else at
        pushes.append([owner, value, at, clock, None])
    alive_rows = ~((np.asarray(world.down_from)[None, :]
                    <= np.arange(scen.horizon)[:, None])
                   & (np.arange(scen.horizon)[:, None]
                      < np.asarray(world.down_until)[None, :]))
    state, r = jswim.initial_state(params, world), 0
    while r < scen.horizon:
        state, _ = jswim.run(key, params, world, 2, state=state,
                             start_round=r)
        r += 2
        md = np.asarray(state.md)
        for p in pushes:
            if p[4] is None and p[2] < r:
                obs = np.flatnonzero(alive_rows[r - 1])
                if ((md[obs, p[0], 0] & jmetadata.MD_VALUE_MAX)
                        == p[1]).all():
                    p[4] = r
    lats = [p[4] - p[3] for p in pushes if p[4] is not None]
    final = int(jmetadata.divergence_probe(state, params, world,
                                           scen.horizon))
    control = jswim.SwimParams(**dict(vars(params), sync_interval=0))
    c_state, _ = jswim.run(key, control, world, scen.horizon)
    c_div = int(jmetadata.divergence_probe(c_state, control, world,
                                           scen.horizon))
    print(f"{args.n}x{args.n} rollout, horizon {scen.horizon}, bound "
          f"{bound}: converged at {[p[4] for p in pushes]}, p99 "
          f"{float(np.percentile(lats, 99)) if lats else None}, final "
          f"divergent cells {final}; control {c_div}", flush=True)
    port_rollout(args.n, scen, params, world, state, c_state)


def port_rollout(n, scen, params, world, state, c_state):
    """The port's gated arm and control on the reference's world and
    draws; prints its verdict beside the reference's."""
    import chip_smoke
    from scalecube_cluster_tpu_torch.models import metadata, swim
    from tests.torch_port_helpers import (jax_draws, port_params,
                                          port_world)

    p_params, p_world = port_params(params), port_world(world)
    _, geo = chip_smoke.rollout_world(n, "cpu")
    draws = jax_draws(jax.random.key(SEED), params, world)
    p_state, summary = chip_smoke.rollout_gated(p_params, p_world, geo, "cpu",
                                                draws=draws)
    j_control = jswim.SwimParams(**dict(vars(params), sync_interval=0))
    control = port_params(j_control)
    pc_state, _ = swim.run(SEED, control, p_world, scen.horizon,
                           draws=jax_draws(jax.random.key(SEED), j_control,
                                           world), device="cpu")
    c_div = int(metadata.divergence_probe(pc_state, control, p_world,
                                          scen.horizon))
    equal = all(np.array_equal(getattr(p_state, f).numpy(),
                               np.asarray(getattr(state, f)))
                for f in ("status", "inc", "md", "md_spread"))
    c_equal = np.array_equal(pc_state.md.numpy(), np.asarray(c_state.md))
    print(f"port on the reference's draws: converged at "
          f"{summary['converged_at']}, p99 {summary['p99']}, final "
          f"divergent cells {summary['final_div']}; control {c_div}; final "
          f"states equal to the reference's: gated {equal}, control "
          f"{c_equal}", flush=True)


if __name__ == "__main__":
    main()
