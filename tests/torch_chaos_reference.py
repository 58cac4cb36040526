"""A red scenario of ``bench.py --chaos``'s campaign on the port's own
draws, told apart from a port fault on the CPU.

``chip_smoke.py`` runs ``generate_campaign(seed=100, n_scenarios=21,
n=32)`` through the port's ``chaos.run_campaign`` on its own draws
(``TorchDraws`` made on the CPU). This script takes one scenario of it
(default ``generate_scenario(seed=110, n=32, severity="moderate")``) and
prints, on the CPU:

- the reference's ``run_scenario`` verdict on its own key (the run
  seed), and the port's ``run_scenario`` on the reference's draws for
  that key (``tests.torch_port_helpers.jax_draws``), which must be equal;
- the port's verdict on its own draws with the same seed (the stream
  ``chip_smoke.py`` runs);
- the reference's verdicts on ``--keys`` other keys: how often the
  reference's own draw streams break the same scenario's promises.

Run: ``JAX_PLATFORMS=cpu python -m tests.torch_chaos_reference --seed 110
--severity moderate --keys 40``.
"""

import argparse

import jax
import numpy as np
import torch

from scalecube_cluster_tpu.chaos import campaign as jcampaign
from scalecube_cluster_tpu.chaos import monitor as jmonitor
from scalecube_cluster_tpu.chaos import scenarios as jscenarios
from scalecube_cluster_tpu_torch.chaos import campaign, scenarios
from tests.torch_port_helpers import jax_draws


def _codes(verdict):
    return {c: d["violations"] for c, d in verdict["codes"].items()
            if d["violations"]}


def _lanes(verdict):
    return sorted({(e["code"], e["subject"], e["round"])
                   for e in verdict["evidence"]})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=110)
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--severity", default="moderate")
    ap.add_argument("--keys", type=int, default=40)
    args = ap.parse_args(argv)
    torch.set_num_threads(2)
    jscen = jscenarios.generate_scenario(args.seed, args.n, args.severity)
    scen = scenarios.generate_scenario(args.seed, args.n, args.severity)
    assert repr(scen) == repr(jscen)
    params = jcampaign.campaign_params(jscen)
    world, spec = jscen.build(params)
    ref = jcampaign.run_scenario(jscen, seed=args.seed)
    on_ref = campaign.run_scenario(
        scen, seed=args.seed, device="cpu",
        draws=jax_draws(jax.random.key(args.seed), params, world))
    own = campaign.run_scenario(scen, seed=args.seed, device="cpu",
                                draw_device="cpu")
    print(f"{jscen.name}: deadlines "
          f"{sorted(set(np.asarray(spec.complete_by).tolist()))}")
    print(f"reference, key {args.seed}: green {ref.green}, codes "
          f"{_codes(ref.verdict)}; port on the reference's draws: green "
          f"{on_ref.green}, verdict equal {on_ref.verdict == ref.verdict}")
    print(f"port on its own draws, seed {args.seed}: green {own.green}, "
          f"codes {_codes(own.verdict)}, evidence (code, subject, round) "
          f"{_lanes(own.verdict)}")
    reds = []
    for k in range(args.keys):
        _, mon, _ = jmonitor.run_monitored(jax.random.key(k), params, world,
                                           spec, jscen.horizon)
        v = jmonitor.verdict(mon)
        if not v["green"]:
            reds.append((k, _codes(v), _lanes(v)))
    print(f"reference on keys 0-{args.keys - 1}: {len(reds)} red: {reds}",
          flush=True)


if __name__ == "__main__":
    main()
