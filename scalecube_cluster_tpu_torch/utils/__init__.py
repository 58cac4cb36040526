"""Host-side utilities for long runs: checkpointing, metadata and logging.

Counterpart of ``scalecube_cluster_tpu/utils/``:

  - ``checkpoint``  atomic on-disk save and resume of the round carry in
                    the reference's ``.npz`` format (``save``, ``load``,
                    ``run_checkpointed``);
  - ``metadata``    the host-side (id, incarnation) metadata table
                    (``TickMetadataStore``, ``updated_events``);
  - ``runlog``      stdlib logging, metric digests and the
                    ``torch.profiler`` hook.
"""

from scalecube_cluster_tpu_torch.utils import checkpoint, runlog
from scalecube_cluster_tpu_torch.utils.runlog import get_logger

__all__ = ["checkpoint", "runlog", "get_logger"]
