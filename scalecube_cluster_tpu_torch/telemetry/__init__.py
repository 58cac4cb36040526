"""The membership event trace and its segmented host-side runner.

Counterpart of ``scalecube_cluster_tpu/telemetry/``, its trace slice:

  - ``events``  the typed event schema (``MembershipTraceEvent``), pure
                Python;
  - ``trace``   the fixed-capacity event buffer riding the rounds
                (int32 lanes, overflow counted, never silently cut), the
                first-suspect and first-removal round matrices, the
                latency histograms, and ``TracePlane``, the trace as a
                plane of ``models/compose``;
  - ``sink``    ``stream_traced_run``, the segmented traced runner with
                each segment's offload overlapped against the next.

The reference's metrics registry, JSONL sink, TensorBoard export and
query layer are not ported yet.  Importing this package imports none of
its modules.
"""
