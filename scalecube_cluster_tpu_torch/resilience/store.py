"""Generation-rotated, checksummed checkpoint store.

Counterpart of ``scalecube_cluster_tpu/resilience/store.py``, in its
format, so either package reads the other's generations.
``utils/checkpoint`` writes one ``.npz`` per run: atomic against a kill
mid-write, but one bad byte in that file strands the whole run.  This
store keeps the last ``keep`` generations (``<base>.gen-<next_round>.npz``),
deleting older ones, and every payload carries a sha256 checksum computed
over the arrays themselves:

  - :meth:`CheckpointStore.save`: atomic write of the new generation,
    then the deletion of old ones (write first, delete second: the store
    never holds fewer intact generations than before the call);
  - :meth:`CheckpointStore.load_latest`: newest first.  A candidate that
    fails to open (a truncated zip), fails its CRC, lacks required
    members or fails the checksum is recorded and skipped; the newest
    intact generation wins.  When every candidate is corrupt the error
    names each one tried and why it was rejected;
  - a legacy single-file checkpoint (the plain ``<base>`` path written by
    ``utils/checkpoint.save``) still loads, as the last candidate,
    without a checksum.

The payload is a flat ``{name: np.ndarray}`` dict plus the cursor
(``next_round``), the run's key and a JSON meta blob, the layout
``utils/checkpoint`` uses (``state/<field>`` keys for the ``SwimState``).
The port's key is its int seed, stored as the key data of the
reference's ``jax.random.key(seed)`` (``checkpoint.seed_key_data``).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from typing import List, Optional, Tuple

import numpy as np

from scalecube_cluster_tpu_torch.utils import checkpoint as ckpt

CHECKSUM_KEY = "__checksum_sha256__"
_GEN_RE_TMPL = r"\.gen-(\d{8,})\.npz$"


class CheckpointCorruptError(RuntimeError):
    """One candidate failed verification (internal; callers normally see
    only :class:`CheckpointExhaustedError` after every fallback fails)."""


class CheckpointExhaustedError(RuntimeError):
    """No intact generation left.  ``candidates`` is the ordered list of
    (path, reason-rejected) pairs — every file tried, newest first."""

    def __init__(self, base_path: str, candidates: List[Tuple[str, str]]):
        self.candidates = candidates
        lines = "\n".join(f"  - {p}: {why}" for p, why in candidates)
        super().__init__(
            f"no intact checkpoint generation for {base_path!r}; "
            f"tried {len(candidates)} candidate(s):\n{lines}\n"
            f"restore a generation or delete the lineage to start over"
        )


def payload_checksum(arrays: dict) -> str:
    """sha256 hex over the payload arrays (sorted name order; name,
    dtype, shape and raw bytes all covered).  The checksum array itself
    is excluded, so verification recomputes exactly this."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        if name == CHECKSUM_KEY:
            continue
        a = np.ascontiguousarray(np.asarray(arrays[name]))
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


class CheckpointStore:
    """Rotated + checksummed checkpoint lineage at ``base_path``
    (module docstring).  ``keep`` >= 1 generations are retained."""

    def __init__(self, base_path: str, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.base_path = base_path
        self.keep = keep
        self._gen_re = re.compile(
            re.escape(os.path.basename(base_path)) + _GEN_RE_TMPL
        )

    # -- paths -------------------------------------------------------------

    def gen_path(self, generation: int) -> str:
        return f"{self.base_path}.gen-{generation:08d}.npz"

    def generations_on_disk(self) -> List[int]:
        """Sorted (ascending) generation cursors present next to base."""
        directory = os.path.dirname(os.path.abspath(self.base_path)) or "."
        if not os.path.isdir(directory):
            return []
        gens = []
        for fn in os.listdir(directory):
            m = self._gen_re.match(fn)
            if m:
                gens.append(int(m.group(1)))
        return sorted(gens)

    # -- write -------------------------------------------------------------

    def save(self, arrays: dict, next_round: int, key=None,
             meta: Optional[dict] = None) -> str:
        """Write generation ``next_round`` atomically, then GC older
        generations past ``keep``.  ``key`` is the run's int seed (or raw
        key data, an array).  Returns the path written.

        GC runs strictly AFTER the new generation is durable (write-
        first, delete-second), so a kill anywhere in this method leaves
        at least as many intact generations as before it started.

        GC considers only generations strictly OLDER than the one just
        written — never the new file itself, and never a NEWER one.
        Newer generations can only exist after load_latest fell back
        past corrupt ones (the cursor moved backwards); blindly keeping
        "the newest keep by number" would then delete the just-written
        and the intact older generations in favor of the corrupt ones,
        exhausting the lineage.  Left alone, the corrupt stragglers age
        out of the window once the cursor passes them again.
        """
        payload = {k: np.asarray(v) for k, v in arrays.items()}
        payload["next_round"] = np.int64(next_round)
        if key is not None:
            payload["key_data"] = ckpt._key_array(key)
        payload["meta_json"] = np.frombuffer(
            json.dumps(meta or {}).encode(), dtype=np.uint8
        )
        digest = payload_checksum(payload)
        payload[CHECKSUM_KEY] = np.frombuffer(digest.encode(),
                                              dtype=np.uint8)
        path = self.gen_path(next_round)
        ckpt._atomic_savez(path, payload)
        older = [g for g in self.generations_on_disk() if g < next_round]
        keep_older = self.keep - 1      # the new generation counts
        for gen in (older[:-keep_older] if keep_older else older):
            try:
                os.unlink(self.gen_path(gen))
            except FileNotFoundError:  # concurrent GC — already gone
                pass
        return path

    # -- read --------------------------------------------------------------

    def _load_candidate(self, path: str, checksummed: bool = True) -> tuple:
        """(arrays, next_round, seed, meta) of one verified candidate, or
        raise :class:`CheckpointCorruptError` with the reason."""
        try:
            with np.load(path) as z:
                raw = {name: z[name] for name in z.files}
        except Exception as e:  # noqa: BLE001 — any read failure IS
            # corruption for fallback purposes: zipfile raises
            # BadZipFile on truncation, zlib.error / EOFError on
            # damaged streams, OSError on filesystem trouble,
            # ValueError on malformed .npy members — the correct
            # response to all of them is "try the previous generation".
            raise CheckpointCorruptError(
                f"unreadable npz ({type(e).__name__}: {e})"
            ) from e
        if checksummed:
            if CHECKSUM_KEY not in raw:
                raise CheckpointCorruptError("missing content checksum")
            stored = bytes(raw[CHECKSUM_KEY].tobytes()).decode(
                "ascii", "replace"
            )
            actual = payload_checksum(raw)
            if stored != actual:
                raise CheckpointCorruptError(
                    f"content checksum mismatch (stored {stored[:12]}…, "
                    f"recomputed {actual[:12]}…)"
                )
        if "next_round" not in raw or "meta_json" not in raw:
            raise CheckpointCorruptError(
                "payload lacks next_round/meta_json members"
            )
        next_round = int(raw["next_round"])
        key = None
        if "key_data" in raw:
            try:
                key = ckpt.seed_from_key_data(raw["key_data"])
            except ValueError as e:
                raise CheckpointCorruptError(str(e)) from e
        meta = json.loads(
            bytes(raw["meta_json"].tobytes()).decode() or "{}"
        )
        arrays = {
            k: v for k, v in raw.items()
            if k not in ("next_round", "key_data", "meta_json",
                         CHECKSUM_KEY)
        }
        return arrays, next_round, key, meta

    def load_latest(self, log=None) -> Optional[tuple]:
        """Newest intact generation, or None when the lineage is empty.

        Returns ``(arrays, next_round, seed, meta, info)`` where ``info``
        is ``{"path", "generation", "fallbacks": [(path, reason), ...]}``
        — a non-empty ``fallbacks`` list means newer generations were
        rejected as corrupt (each with its reason).  Raises
        :class:`CheckpointExhaustedError` when candidates exist but none
        verifies.
        """
        rejected: List[Tuple[str, str]] = []
        for gen in reversed(self.generations_on_disk()):
            path = self.gen_path(gen)
            try:
                arrays, next_round, key, meta = self._load_candidate(path)
            except CheckpointCorruptError as e:
                rejected.append((path, str(e)))
                if log is not None:
                    log.warning("checkpoint %s rejected: %s — falling "
                                "back to previous generation", path, e)
                continue
            return arrays, next_round, key, meta, {
                "path": path, "generation": gen, "fallbacks": rejected,
            }
        # Legacy single-file checkpoint (pre-rotation format): accepted
        # without a checksum — it predates the field.
        if os.path.exists(self.base_path):
            try:
                arrays, next_round, key, meta = self._load_candidate(
                    self.base_path, checksummed=False
                )
            except CheckpointCorruptError as e:
                rejected.append((self.base_path, str(e)))
            else:
                return arrays, next_round, key, meta, {
                    "path": self.base_path, "generation": None,
                    "fallbacks": rejected, "legacy": True,
                }
        if rejected:
            raise CheckpointExhaustedError(self.base_path, rejected)
        return None
