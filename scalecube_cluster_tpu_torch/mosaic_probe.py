"""The capability probes of ``experiments/mosaic_probe.py`` as CUDA
kernels (``kernels/probes.py``).

For each of the five probes, makes its inputs with numpy from a seed,
runs the kernel once, holds the result against the probe's plain
PyTorch version (exact equality) and prints one JSON line: the probe's
name, the TPU kernel it replaces, the shape, the device, the sum of the
output (as the JAX script prints) and the largest absolute difference
from the plain version.  A probe that fails raises (the JAX script
caught and reported capability errors; here every probe must run).

The inputs reach the edges of each conversion: full-range int16 and int8
(negative values sign-extend), int32 values far outside the int16 range
and at INT32_MAX for the truncating store, and merge keys that are
negative, DEAD, SUSPECT or tie the entry's incarnation.

Run on a card: ``python -m scalecube_cluster_tpu_torch.mosaic_probe
[--rows 512 --cols 128 --seed 0]`` (``--device cpu`` runs the plain
versions against themselves).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Tuple

import numpy as np
import torch

from scalecube_cluster_tpu_torch.kernels import probes
from scalecube_cluster_tpu_torch.models.swim import resolve_device

ROWS, COLS = 512, 128
INT32_MAX = 2**31 - 1


def make_inputs(rows: int, cols: int, seed: int,
                device) -> Dict[str, Tuple[torch.Tensor, ...]]:
    """Each probe's input tensors on ``device``, made from ``seed``."""
    rng = np.random.default_rng(seed)
    shape = (rows, cols)

    def ints(lo, hi, dtype):
        return rng.integers(lo, hi, shape, dtype=np.int64).astype(dtype)

    x16 = ints(-2**15, 2**15, np.int16)
    y16 = np.where(rng.random(shape) < 0.1, x16,
                   ints(-2**15, 2**15, np.int16))
    x8 = ints(-2**7, 2**7, np.int8)
    wide = ints(-2**31, 2**31, np.int32)
    wide.flat[:3] = (350342, INT32_MAX, -2**31)

    status = ints(-2**7, 2**7, np.int8)
    inc = ints(0, 2**29, np.int32)
    suspect = ints(0, 2, np.int32)
    dead = (rng.random(shape) < 0.1).astype(np.int32)
    tie = rng.random(shape) < 0.3
    key_inc = np.where(tie, inc, ints(0, 2**29, np.int32))
    key = (dead << 30) | (key_inc << 1) | suspect
    key = np.where(rng.random(shape) < 0.1, ints(-2**31, 0, np.int32), key)
    gate = ints(-2**7, 2**7, np.int8)

    def t(*arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in arrays)

    return {"probe_load16": t(x16), "probe_store16": t(wide),
            "probe_cmp16": t(x16, y16), "probe_load8": t(x8),
            "probe_merge_core": t(status, inc, key.astype(np.int32), gate)}


def check(name: str, inputs) -> dict:
    """Run probe ``name`` once on ``inputs`` and hold it against its plain
    version; raises if they differ."""
    got = probes.PROBES[name](*inputs)
    want = probes.REFERENCES[name](*inputs)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{name}: {g.dtype}{tuple(g.shape)} vs plain "
                                 f"{w.dtype}{tuple(w.shape)}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                           .abs().max()))
    if err != 0:
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"(max abs err {err})")
    tpu_kernel, line = probes.REPLACES[name]
    return {"probe": name,
            "replaces": f"experiments/mosaic_probe.py:{line} {tpu_kernel}",
            "ok": True, "shape": list(inputs[0].shape),
            "device": str(inputs[0].device),
            "out": float(sum(int(g.to(torch.int64).sum()) for g in got)),
            "max_abs_err": err}


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--cols", type=int, default=COLS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    inputs = make_inputs(args.rows, args.cols, args.seed, device)
    results = []
    for name in probes.NAMES:
        result = check(name, inputs[name])
        print(json.dumps(result), flush=True)
        results.append(result)
    return results


if __name__ == "__main__":
    main()
