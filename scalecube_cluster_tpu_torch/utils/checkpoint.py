"""On-disk checkpoint and resume of the round carry for long runs.

Counterpart of ``scalecube_cluster_tpu/utils/checkpoint.py``, in its
format: one ``.npz`` holding every ``SwimState`` lane as
``state/<field>``, the cursor ``next_round`` (int64), the run's key as
``key_data`` (optional) and a JSON ``meta_json`` blob (uint8 bytes).  A
checkpoint written by either package loads in the other.  The carry plus
the (seed, next round) cursor is everything needed to re-enter
``models/swim.run`` at round r: every draw is a function of (seed,
round), so a resumed run equals the unbroken one bit for bit.

The port's runs take an int ``seed`` where the reference takes a
``jax.random`` key.  A seed is stored as the key data of the reference's
``jax.random.key(seed)`` (two uint32 words, high then low,
:func:`seed_key_data`), so a port checkpoint resumes in the reference
under that key, and a reference checkpoint's key loads here as the int
its two words spell (:func:`seed_from_key_data`).

Writes are atomic (a temporary file, then a rename): a kill mid-write
never leaves a truncated checkpoint at the final name.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from scalecube_cluster_tpu_torch.models import swim

_CARRY_FIELDS = ("status", "inc", "spread_until", "suspect_deadline",
                 "self_inc")


def seed_key_data(seed: int) -> np.ndarray:
    """The two uint32 words of the reference's ``jax.random.key(seed)``
    (threefry: the seed's high word, then its low word)."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed {seed} is outside [0, 2**64)")
    return np.array([seed >> 32, seed & 0xFFFFFFFF], dtype=np.uint32)


def seed_from_key_data(data) -> int:
    """Inverse of :func:`seed_key_data`: the int a two-word key spells."""
    data = np.asarray(data)
    if data.shape != (2,) or data.dtype != np.uint32:
        raise ValueError(
            f"key data {data.dtype}{data.shape} is not a two-word threefry "
            f"key; the port's runs take an int seed")
    return (int(data[0]) << 32) | int(data[1])


def state_to_arrays(state: swim.SwimState) -> dict:
    """``SwimState`` -> ``{"state/<field>": numpy array}``, every lane in
    its own dtype: the checkpoint payload naming shared with
    ``resilience/store.py`` and the reference's ``state_from_arrays``."""
    return {f"state/{f.name}": getattr(state, f.name).cpu().numpy()
            for f in dataclasses.fields(state)}


def carry_dtypes(compact: bool) -> dict:
    """The numpy dtypes of the five carry lanes, wide or compact."""
    narrow = (np.int16, np.int8, np.int16) if compact else (np.int32,) * 3
    return dict(status=np.int8, inc=narrow[0], spread_until=narrow[1],
                suspect_deadline=narrow[2], self_inc=np.int32)


def state_from_arrays(fields: dict, origin: str = "checkpoint",
                      params: Optional[swim.SwimParams] = None,
                      device="cuda") -> swim.SwimState:
    """Inverse of :func:`state_to_arrays` (keys without the ``state/``
    prefix), on ``device``.

    Lanes a checkpoint predates load as the plane-off zero-size lanes,
    as in the reference: the user-gossip lanes (G = 0), ``lhm``, the
    ``epoch`` lane and the metadata ``md`` / ``md_spread`` lanes.  With
    ``params`` whose epoch guard is on, a missing ``epoch`` lane loads as
    zero epochs [N, K] in the params' carry dtype (every record the
    original occupant's), so an open-world run resumes a checkpoint from
    before the lane.  Any other missing field raises ``KeyError``.

    The five carry lanes must be in the layout ``params`` names (the
    compact one under ``params.compact_carry``; the wide one otherwise
    and without params): a compact checkpoint needs the run's params."""
    device = swim.resolve_device(device)
    fields = {name: np.asarray(value) for name, value in fields.items()}
    names = {f.name for f in dataclasses.fields(swim.SwimState)}
    missing = names - set(fields)
    if missing:
        if "status" not in fields:
            raise KeyError(f"{origin} lacks state fields {sorted(missing)}")
        n = fields["status"].shape[0]
        if params is not None and params.epoch_bits:
            epoch = swim.initial_epoch(params, "cpu").numpy()
        else:
            epoch = np.zeros((n, 0), np.int32)
        defaults = {
            "g_infected": np.zeros((n, 0), np.bool_),
            "g_spread_until": np.zeros((n, 0), np.int32),
            "g_ring": np.zeros((0, n, 0), np.bool_),
            "lhm": np.zeros((0,), np.int32),
            "epoch": epoch,
            "md": np.zeros((n, 0, 0), np.int32),
            "md_spread": np.zeros((n, 0), np.int32),
        }
        unknown = missing - set(defaults)
        if unknown:
            raise KeyError(f"{origin} lacks state fields {sorted(unknown)}")
        for name in missing:
            fields[name] = defaults[name]
    compact = params is not None and params.compact_carry
    layout = "compact_carry" if compact else "wide"
    for name, dtype in carry_dtypes(compact).items():
        if fields[name].dtype != dtype:
            raise ValueError(
                f"{origin}: state field {name} is {fields[name].dtype}, the "
                f"{layout} carry has {np.dtype(dtype)} (pass the run's "
                f"params; compact_carry selects the int16/int8 lanes)")
    return swim.SwimState(**{name: torch.tensor(fields[name], device=device)
                             for name in names})


def _key_array(key) -> np.ndarray:
    """``key_data`` of a seed, or raw key data given as an array."""
    if isinstance(key, (int, np.integer)):
        return seed_key_data(key)
    return np.asarray(key)


def save(path: str, state: swim.SwimState, next_round: int, key=None,
         meta: Optional[dict] = None) -> None:
    """Atomically write ``state`` and the cursor to ``path`` (.npz).

    ``key`` is the run's int seed (stored as :func:`seed_key_data`) or
    raw key data (an array, stored as given).  ``meta`` is any JSON-able
    dict (config snapshot, world hash) stored alongside for validation
    at load time."""
    arrays = state_to_arrays(state)
    arrays["next_round"] = np.int64(next_round)
    if key is not None:
        arrays["key_data"] = _key_array(key)
    arrays["meta_json"] = np.frombuffer(json.dumps(meta or {}).encode(),
                                        dtype=np.uint8)
    _atomic_savez(path, arrays)


def _atomic_savez(path: str, arrays: dict) -> None:
    """``np.savez`` to ``path`` through a temporary file and a rename: a
    kill mid-write never leaves a truncated .npz at the final name."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load(path: str, params: Optional[swim.SwimParams] = None,
         device="cuda") -> Tuple[swim.SwimState, int, Optional[int], dict]:
    """Load ``(state, next_round, seed or None, meta)`` written by
    :func:`save` (or by the reference's).  ``params`` names the carry
    layout and the epoch default, as for :func:`state_from_arrays`."""
    with np.load(path) as z:
        fields = {name[len("state/"):]: z[name]
                  for name in z.files if name.startswith("state/")}
        state = state_from_arrays(fields, origin=f"checkpoint {path}",
                                  params=params, device=device)
        next_round = int(z["next_round"])
        seed = (seed_from_key_data(z["key_data"]) if "key_data" in z.files
                else None)
        meta = json.loads(bytes(z["meta_json"].tobytes()).decode() or "{}")
    return state, next_round, seed, meta


def _metrics_path(path: str, upto_round: int) -> str:
    return f"{path}.metrics-{upto_round:08d}.npz"


def _metric_rounds_on_disk(path: str) -> list:
    """Sorted end rounds of the metric-trace files written next to
    ``path``, found on disk rather than assumed on a chunk grid (a run
    whose ``n_rounds`` is not a multiple of ``chunk`` ends with a short
    chunk, and a later extension's boundaries are offset from the grid).
    """
    directory = os.path.dirname(os.path.abspath(path)) or "."
    if not os.path.isdir(directory):
        return []
    # {:08d} pads to 8 digits and grows wider past 99,999,999 rounds.
    pat = re.compile(re.escape(os.path.basename(path))
                     + r"\.metrics-(\d{8,})\.npz$")
    return sorted(int(m.group(1)) for m in map(pat.match,
                                                os.listdir(directory)) if m)


def _delete_traces_above(path: str, above_round: int) -> list:
    """Delete the trace files past ``above_round`` (leftovers of an
    earlier run lineage, or of a kill between a trace write and its
    checkpoint write), so the traces always cover a prefix of
    [0, next_round).  Returns the deleted paths."""
    deleted = []
    for upto in _metric_rounds_on_disk(path):
        if upto > above_round:
            fn = _metrics_path(path, upto)
            os.unlink(fn)
            deleted.append(fn)
    return deleted


def _host_metrics(metrics: dict) -> dict:
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in metrics.items()}


def run_checkpointed(run_fn, seed: int, params, world, n_rounds: int,
                     path: str, chunk: int = 1000, state=None,
                     start_round: int = 0, meta: Optional[dict] = None,
                     log=None, device="cuda"):
    """Drive ``run_fn`` (``swim.run``-shaped: ``run_fn(seed, params,
    world, n, state=, start_round=)``) in chunks, checkpointing each.

    Resumes from ``path`` when it exists (``start_round`` / ``state`` are
    then ignored, and the stored seed replaces ``seed``); the state loads
    on ``device``.  On resume the stored ``meta`` must equal the caller's
    (both JSON-normalised, so tuples and int keys compare as stored): a
    mismatch raises instead of continuing a different run.  Each chunk's
    metrics are written next to the checkpoint
    (``<path>.metrics-<round>.npz``) before the checkpoint itself and
    reloaded on resume (boundaries found on disk, so resuming with
    another ``chunk`` is fine); a trace file missing inside the covered
    rounds raises.  Returns ``(final_state, metrics chunks)``, covering
    rounds [0, n_rounds) across any number of resumes: reloaded chunks
    hold CPU tensors, fresh ones what ``run_fn`` returned."""
    meta = json.loads(json.dumps(meta)) if meta is not None else None
    metrics_chunks = []
    if os.path.exists(path):
        state, start_round, saved_seed, saved_meta = load(
            path, params=params, device=device)
        if saved_seed is not None:
            seed = saved_seed
        if meta is not None and saved_meta != meta:
            raise ValueError(
                f"checkpoint meta mismatch: saved {saved_meta!r} != "
                f"current {meta!r} — refusing to resume a different run")
        meta = saved_meta
        covered = 0
        for upto in _metric_rounds_on_disk(path):
            if upto > start_round:
                break
            with np.load(_metrics_path(path, upto)) as z:
                mchunk = {k: torch.from_numpy(z[k]) for k in z.files}
            n_in_chunk = len(next(iter(mchunk.values())))
            if covered + n_in_chunk != upto:
                raise ValueError(
                    f"metric traces covering rounds [{covered}, "
                    f"{upto - n_in_chunk}) are missing next to {path!r} — "
                    f"a trace file was deleted out-of-band; restore it or "
                    f"delete the checkpoint to start over")
            metrics_chunks.append(mchunk)
            covered = upto
        if covered != start_round:
            raise ValueError(
                f"metric traces covering rounds [{covered}, {start_round}) "
                f"are missing next to {path!r} — a trace file was deleted "
                f"out-of-band; restore it or delete the checkpoint to "
                f"start over")
        if log is not None:
            log.info("resumed from %s at round %d (%d metric chunks)",
                     path, start_round, len(metrics_chunks))
        _delete_traces_above(path, start_round)
    else:
        deleted = _delete_traces_above(path, -1)
        if deleted:
            msg = (f"fresh run at {path!r}: removing {len(deleted)} "
                   f"pre-existing metric trace file(s) from an earlier "
                   f"run lineage: {deleted}")
            if log is not None:
                log.warning(msg)
            else:
                warnings.warn(msg, stacklevel=2)
    r = start_round
    while r < n_rounds:
        step = min(chunk, n_rounds - r)
        state, metrics = run_fn(seed, params, world, step, state=state,
                                start_round=r)
        r += step
        # Trace first, checkpoint second: a kill between the two re-runs
        # this chunk on resume and overwrites the orphaned trace with the
        # same bits.
        _atomic_savez(_metrics_path(path, r), _host_metrics(metrics))
        save(path, state, r, key=seed, meta=meta)
        metrics_chunks.append(metrics)
        if log is not None:
            log.info("checkpointed round %d/%d", r, n_rounds)
    return state, metrics_chunks
