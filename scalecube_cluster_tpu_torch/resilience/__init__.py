"""Preemption-safe running: rotated, checksummed checkpoints.

Counterpart of ``scalecube_cluster_tpu/resilience/``, as far as it is
ported: :mod:`resilience.store` keeps generation-rotated ``.npz``
checkpoints whose payload carries a content checksum; a load falls back
to the newest intact generation when the latest is truncated or
corrupted, and an old single-file ``utils/checkpoint`` file still loads.
The reference's segment supervisor (``supervisor.py``) and its
kill-injection harness (``harness.py``) are not ported yet.
"""

from scalecube_cluster_tpu_torch.resilience.store import (  # noqa: F401
    CheckpointCorruptError,
    CheckpointExhaustedError,
    CheckpointStore,
    payload_checksum,
)
