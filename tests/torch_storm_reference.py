"""The churn storm of ``chip_smoke.py`` (``storm_world``: the reference's
``churn_growth_scenario`` geometry, pools drawn from the focal
subjects) run through the JAX reference on the CPU, with the reference
monitor after every round, in both arms: the reference's own verdict at
a size the CPU affords, beside which the port's run on the card is
read.

Run: ``JAX_PLATFORMS=cpu python -m tests.torch_storm_reference --n
65536 [--delivery shift]``.  Prints one line per arm: the horizon, the
monitor's code counts, the joined rows' final incarnations and the
refutations.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

import chip_smoke
from scalecube_cluster_tpu.chaos import monitor as jmonitor
from scalecube_cluster_tpu.chaos.campaign import campaign_config
from scalecube_cluster_tpu.models import swim as jswim
from scalecube_cluster_tpu_torch.chaos import monitor
from tests.torch_port_helpers import port_params


def reference_world(jparams, world):
    """The port's storm world as the reference's ``SwimWorld``: the same
    subjects, scare rules, crash windows and joins."""
    jworld = jswim.SwimWorld.healthy(
        jparams, subject_ids=jnp.asarray(world.subject_ids.numpy()))
    faults = world.faults
    for r in range(faults.n_rules):
        jworld = jworld.with_link_fault(
            (int(faults.src_lo[r]), int(faults.src_hi[r])),
            (int(faults.dst_lo[r]), int(faults.dst_hi[r])),
            float(faults.loss[r]), from_round=int(faults.from_round[r]),
            until_round=int(faults.until_round[r]))
    return dataclasses.replace(
        jworld, down_from=jnp.asarray(world.down_from.numpy()),
        down_until=jnp.asarray(world.down_until.numpy()),
        join_at=jnp.asarray(world.join_at.numpy()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=65_536)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--delivery", default="shift")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    for guard in (True, False):
        jparams = jswim.SwimParams.from_config(
            campaign_config(), n_members=args.n, n_subjects=args.k,
            delivery=args.delivery, open_world=True, epoch_guard=guard)
        params = port_params(jparams)
        world, horizon, disruption_end, joins = chip_smoke.storm_world(
            params, "cpu")
        known_by, check = monitor.join_deadlines(params, world,
                                                 disruption_end)
        spec = jmonitor.MonitorSpec(
            complete_by=jnp.full((args.k,), monitor.INT32_MAX, jnp.int32),
            join_known_by=jnp.asarray(known_by.numpy()), check_joins=check)
        state, mon, metrics = jmonitor.run_monitored(
            jax.random.key(args.seed), jparams,
            reference_world(jparams, world), spec, horizon)
        counts = np.asarray(mon.code_counts)
        slots = [slot for slot, _ in joins]
        print(f"{args.n}x{args.k} {args.delivery} "
              f"{'guard' if guard else 'naive'}: horizon {horizon}, joins "
              f"{joins}, NO_RESURRECTION "
              f"{int(counts[jmonitor.InvariantCode.NO_RESURRECTION])}, "
              f"JOIN_COMPLETENESS "
              f"{int(counts[jmonitor.InvariantCode.JOIN_COMPLETENESS])}, "
              f"all codes {counts.tolist()}, joined rows' self_inc "
              f"{np.asarray(state.self_inc)[slots].tolist()}, refutations "
              f"{int(np.asarray(metrics['refutations']).sum())}", flush=True)


if __name__ == "__main__":
    main()
