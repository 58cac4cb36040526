"""The staged config rollout of ``chip_smoke.py`` (``rollout_world``:
``bench.py --rollout``'s scenario) built and run by the JAX reference on
the CPU: :func:`reference_rollout` is the reference's own ``Scenario``
(``bench.py:1834-1870``), which the tests hold ``rollout_world`` against;
:func:`reference_gated` replays the bench's gated arm
(``bench.py:1888-1950``), its rollback branch included, which the tests
hold ``chip_smoke.rollout_gated`` against; and run as a script it gives
the reference's verdict at a size the CPU affords, beside which the
port's run on the card is read.

Run: ``JAX_PLATFORMS=cpu python -m tests.torch_rollout_reference --n 48
[--breach]``.  Prints, for the gated arm, each push's converged round
(polled every 2 rounds, as the bench does), ``metadata_convergence_p99``
and the divergence probe at the horizon, and the gossip-only control's
probe; then the same for the port (``chip_smoke.rollout_gated`` and
``models.swim.run``) on the reference's world (its match-nothing link
rules included) and the reference's draws (``jax_draws``), with whether
its final states equal the reference's.  ``--breach`` runs both gated
arms under the breach geometry instead (``chip_smoke.rollout_world(...,
breach=True)``: stage 0's deadlines at their clock start plus
``chip_smoke.ROLLOUT_BREACH_ROUNDS``), so they take the rollback branch.
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


def reference_gated(n, breach_rounds=None, probe_step=2):
    """The bench's gated arm (``bench.py:1888-1950``) on the reference's
    rollout at ``n`` members, polled every ``probe_step`` rounds: a push's
    deadline clock starts at ``max(push, heal)`` and runs ``bound``
    rounds (``breach_rounds`` for stage 0's pushes when given, the breach
    geometry); the first push past its deadline unconverged rolls the
    flipped stages back (``rollback_ops(failed_stage, r + 1)`` applied to
    the world) and runs to the horizon on that world.  Returns ``(state,
    summary, (scenario, params, world, rollout))``: the summary holds the
    converged rounds, ``converged``, ``p99``, ``rolled_back``,
    ``failed_stage`` and the divergence probe at the horizon."""
    scen, params, world, rollout, heal_at, bound = reference_rollout(n)
    key, horizon = jax.random.key(SEED), scen.horizon
    split_at = heal_at // 2
    pushes = []
    for owner, _, value, at in rollout.push_schedule():
        clock = heal_at if split_at <= at < heal_at else at
        limit = (breach_rounds if breach_rounds is not None
                 and at == rollout.stage_round(0) else bound)
        pushes.append(dict(owner=owner, value=value, push_round=at,
                           clock_from=clock, deadline=clock + limit,
                           converged_at=None))
    df, du = np.asarray(world.down_from), np.asarray(world.down_until)
    state, r = jswim.initial_state(params, world), 0
    rolled_back, failed_stage, breaches = False, None, []
    while r < horizon:
        step = min(probe_step, horizon - r)
        state, _ = jswim.run(key, params, world, step, state=state,
                             start_round=r)
        r += step
        open_pushes = [p for p in pushes
                       if p["converged_at"] is None and p["push_round"] < r]
        if open_pushes:
            md = np.asarray(state.md)
            obs = np.flatnonzero(~((df <= r - 1) & (r - 1 < du)))
            for p in open_pushes:
                if ((md[obs, p["owner"], 0] & jmetadata.MD_VALUE_MAX)
                        == p["value"]).all():
                    p["converged_at"] = r
        breaches += [p for p in pushes
                     if p["converged_at"] is None and r >= p["deadline"]]
        if breaches and not rolled_back:
            rolled_back = True
            failed_stage = max(
                s for s in range(rollout.n_stages)
                if rollout.stage_round(s) <= breaches[0]["push_round"])
            rb_world = world
            for op in rollout.rollback_ops(failed_stage, r + 1):
                rb_world = op.apply(rb_world, n, horizon)
            state, _ = jswim.run(key, params, rb_world, horizon - r,
                                 state=state, start_round=r)
            r = horizon
        if all(p["converged_at"] is not None for p in pushes):
            break
    lats = [p["converged_at"] - p["clock_from"] for p in pushes
            if p["converged_at"] is not None]
    converged = not rolled_back and all(
        p["converged_at"] is not None and p["converged_at"] <= p["deadline"]
        for p in pushes)
    if r < horizon and not rolled_back:
        state, _ = jswim.run(key, params, world, horizon - r, state=state,
                             start_round=r)
    summary = dict(
        converged_at=[p["converged_at"] for p in pushes],
        converged=converged,
        p99=float(np.percentile(lats, 99)) if lats and converged else None,
        rolled_back=rolled_back, failed_stage=failed_stage,
        final_div=int(jmetadata.divergence_probe(state, params, world,
                                                 horizon)))
    return state, summary, (scen, params, world, rollout)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--breach", action="store_true")
    args = ap.parse_args(argv)
    breach_rounds = None
    if args.breach:
        import chip_smoke

        breach_rounds = chip_smoke.ROLLOUT_BREACH_ROUNDS
    state, summary, (scen, params, world, _) = reference_gated(
        args.n, breach_rounds)
    key = jax.random.key(SEED)
    control = jswim.SwimParams(**dict(vars(params), sync_interval=0))
    c_state, _ = jswim.run(key, control, world, scen.horizon)
    c_div = int(jmetadata.divergence_probe(c_state, control, world,
                                           scen.horizon))
    print(f"{args.n}x{args.n} rollout, horizon {scen.horizon}: "
          f"{summary}; control {c_div}", flush=True)
    port_rollout(args.n, scen, params, world, state, c_state, args.breach)


def port_rollout(n, scen, params, world, state, c_state, breach=False):
    """The port's gated arm (under the breach geometry with ``breach``)
    and control on the reference's world and draws; prints its verdict
    beside the reference's."""
    import chip_smoke
    from scalecube_cluster_tpu_torch.models import metadata, swim
    from tests.torch_port_helpers import (jax_draws, port_params,
                                          port_world)

    p_params, p_world = port_params(params), port_world(world)
    _, geo = chip_smoke.rollout_world(n, "cpu", breach=breach)
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
    verdict = {k: summary[k] for k in (
        "converged_at", "converged", "p99", "rolled_back", "failed_stage",
        "rollback_held", "final_div")}
    print(f"port on the reference's draws: {verdict}; control {c_div}; "
          f"final states equal to the reference's: gated {equal}, control "
          f"{c_equal}", flush=True)


if __name__ == "__main__":
    main()
