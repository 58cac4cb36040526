"""Parameter sweeps: one scenario run once for each point of a knob grid,
the grid advancing as one batch.

Counterpart of ``scalecube_cluster_tpu/sweep.py``.  ``models/swim.Knobs``
carries the sweepable schedule values as data, so a B-point grid is one
``models/compose.composed_batch_scan`` of B rows over one world.

Outputs per grid point, from one crash-at-round-0 scenario
(:func:`crash_curves`):
  - ``dissemination_rounds``: crash -> death known by every live observer,
  - ``detection_rounds``: crash -> first DEAD declaration,
  - ``first_false_positive``: first round a live member is suspected,
  - ``false_positive_rate``: false-positive observer-rounds per observer
    per round.

Under shift delivery the points share their channel shifts by default
(``share_shifts``): every point's shifts come from the sweep's ``seed``
(``shift_key``), which the reference needs to keep its vmapped slices
contiguous; the points' other draws stay their own.

Run: ``python -m scalecube_cluster_tpu_torch.sweep --n-members 2048
--n-rounds 400 --fanout 2 3 --out curves.json [--device cpu]`` writes the
curve artifact (the reference's keys).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from scalecube_cluster_tpu_torch import swim_math
from scalecube_cluster_tpu_torch.config import ClusterConfig
from scalecube_cluster_tpu_torch.models import compose, swim
from scalecube_cluster_tpu_torch.ops import prng

# The grid's axes, in the reference's order.
GRID_AXES = ("fanout", "ping_every", "suspicion_rounds", "loss_probability",
             "sync_every")


def knob_grid(params: "swim.SwimParams", *,
              fanout: Sequence[int] = (),
              ping_every: Sequence[int] = (),
              suspicion_rounds: Sequence[int] = (),
              loss_probability: Sequence[float] = (),
              sync_every: Sequence[int] = ()) -> List["swim.Knobs"]:
    """The Cartesian grid of knob values, one ``Knobs`` a point in the
    reference's ``itertools.product`` order.  An axis left empty stays at
    the params value; ``fanout`` entries must be <= ``params.fanout``
    (the channel count)."""
    given = dict(fanout=fanout, ping_every=ping_every,
                 suspicion_rounds=suspicion_rounds,
                 loss_probability=loss_probability, sync_every=sync_every)
    axes = {name: list(given[name]) or [getattr(params, name)]
            for name in GRID_AXES}
    if max(axes["fanout"]) > params.fanout:
        raise ValueError(
            f"fanout sweep max {max(axes['fanout'])} exceeds the static "
            f"channel count params.fanout={params.fanout}")
    return [swim.Knobs(**{name: swim._coerce_knob(name, value)
                          for name, value in zip(GRID_AXES, point)})
            for point in itertools.product(*axes.values())]


def point_seed(seed: int, point: int) -> int:
    """Grid point ``point``'s own stream: a SplitMix64 mix of ``(seed,
    point)``, as the reference folds the point's index into its key."""
    return prng.round_seed(seed, point)


def sweep_run(seed: int, params: "swim.SwimParams",
              world: "swim.SwimWorld", n_rounds: int,
              knobs: Sequence["swim.Knobs"],
              share_shifts: Optional[bool] = None, draws=None,
              device="cuda") -> Dict[str, torch.Tensor]:
    """Run the scenario once a grid point, all points as one batch
    (``compose.composed_batch_scan``, no planes, ``world`` for every row).
    Returns the metrics with a leading grid axis ``[B, n_rounds, ...]``.

    Point i draws from its own stream (:func:`point_seed`).
    ``share_shifts`` (default: on under shift delivery) sources every
    point's channel shifts from ``seed`` (``shift_key``): common random
    numbers for the channel topology, the other draws per point.
    ``draws`` (one source a point) replaces the port's own draws."""
    knobs = list(knobs)
    if share_shifts is None:
        share_shifts = params.delivery == "shift"
    shift_key = seed if share_shifts and draws is None else None
    _, _, metrics = compose.composed_batch_scan(
        [point_seed(seed, i) for i in range(len(knobs))], params,
        [world] * len(knobs), n_rounds, knobs=knobs, draws=draws,
        shift_key=shift_key, device=device)
    return metrics


def crash_curves(metrics, subject_slot: int, n_rounds: int,
                 n_members: int) -> Dict[str, np.ndarray]:
    """The sweep's metrics digested into the headline curves, one value a
    grid point (module docstring)."""
    def host(name):
        value = metrics[name]
        return (value.cpu().numpy() if isinstance(value, torch.Tensor)
                else np.asarray(value))

    suspects = host("suspect")[:, :, subject_slot]               # [B, T]
    deads = host("dead")[:, :, subject_slot]
    alive_view = host("alive")[:, :, subject_slot]
    fp = host("false_positives").sum(axis=2)                      # [B, T]

    def first(cond):  # [B, T] -> [B] (n_rounds = never)
        hit = cond.any(axis=1)
        idx = cond.argmax(axis=1)
        return np.where(hit, idx, n_rounds).astype(np.float64)

    return {
        "detection_rounds": first(deads > 0),
        "dissemination_rounds": first(
            (alive_view == 0) & (suspects == 0) & (deads > 0)),
        "first_false_positive": first(fp > 0),
        "false_positive_rate": fp.mean(axis=1) / n_members,
    }


def run_crash_sweep(n_members: int, n_rounds: int, config=None,
                    seed: int = 0, delivery: str = "shift",
                    n_subjects: Optional[int] = None,
                    share_shifts: Optional[bool] = None, draws=None,
                    device="cuda", **grid_axes) -> Dict[str, object]:
    """One-call sweep: the crash-at-round-0 scenario (node 0) across the
    knob grid ``grid_axes`` (:func:`knob_grid`'s axes).  Returns the
    reference's artifact: the grid's columns, the curves and the analytic
    anchors.  ``draws`` as :func:`sweep_run`'s."""
    config = config or ClusterConfig.default()
    params = swim.SwimParams.from_config(
        config, n_members=n_members, n_subjects=n_subjects,
        delivery=delivery,
        # The channel count must cover the largest swept fanout.
        **({"fanout": max(grid_axes["fanout"])} if grid_axes.get("fanout")
           else {}))
    world = swim.SwimWorld.healthy(params, device=device).with_crash(
        0, at_round=0)
    knobs = knob_grid(params, **grid_axes)
    metrics = sweep_run(seed, params, world, n_rounds, knobs,
                        share_shifts=share_shifts, draws=draws,
                        device=device)
    curves = crash_curves(metrics, subject_slot=0, n_rounds=n_rounds,
                          n_members=n_members)
    return {
        "n_members": n_members,
        "n_rounds": n_rounds,
        "delivery": delivery,
        "grid": {f.name: (None if getattr(knobs[0], f.name) is None
                          else [getattr(kn, f.name) for kn in knobs])
                 for f in dataclasses.fields(swim.Knobs)},
        "curves": {k: v.tolist() for k, v in curves.items()},
        "analytic": {
            "periods_to_spread": swim_math.gossip_periods_to_spread(
                config.gossip_repeat_mult, n_members),
            "suspicion_rounds_default": params.suspicion_rounds,
        },
    }


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-members", type=int, default=4096)
    ap.add_argument("--n-subjects", type=int, default=None)
    ap.add_argument("--n-rounds", type=int, default=600)
    ap.add_argument("--delivery", default="shift")
    ap.add_argument("--fanout", type=int, nargs="*", default=[2, 3, 4])
    ap.add_argument("--ping-every", type=int, nargs="*", default=[2, 5])
    ap.add_argument("--suspicion-rounds", type=int, nargs="*", default=[])
    ap.add_argument("--loss", type=float, nargs="*", default=[0.0, 0.05])
    ap.add_argument("--out", default="sweep_curves.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    result = run_crash_sweep(
        args.n_members, args.n_rounds,
        n_subjects=args.n_subjects,
        delivery=args.delivery,
        fanout=args.fanout,
        ping_every=args.ping_every,
        suspicion_rounds=args.suspicion_rounds,
        loss_probability=args.loss,
        device=args.device,
    )
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    det = result["curves"]["detection_rounds"]
    dis = result["curves"]["dissemination_rounds"]
    print(f"wrote {args.out}: {len(det)} grid points; "
          f"detection rounds {min(det)}..{max(det)}, "
          f"dissemination {min(dis)}..{max(dis)}")


if __name__ == "__main__":
    main()
