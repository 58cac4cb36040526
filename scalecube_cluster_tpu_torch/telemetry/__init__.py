"""Telemetry: the membership event trace, the health-metrics registry and
their host-side journals.

Counterpart of ``scalecube_cluster_tpu/telemetry/``:

  - ``events``   the typed event schema (``MembershipTraceEvent``), pure
                 Python;
  - ``trace``    the fixed-capacity event buffer riding the rounds (int32
                 lanes, overflow counted, never silently cut), the
                 first-suspect and first-removal round matrices, the
                 latency histograms, and ``TracePlane``;
  - ``metrics``  the always-on health registry (``MetricsSpec``,
                 ``MetricsState``, ``observe_tick``, ``sample_gauges``,
                 ``MetricsPlane``, ``to_json``, ``stream_metered_run``);
  - ``sink``     JSONL run journals (``TelemetrySink``, ``read_records``,
                 ``covered_upto``, ``JournalFollower``, ...) in the
                 reference's record kinds, ``stream_traced_run``, and the
                 gated TensorBoard export;
  - ``query``    the blame engine over provenance rows
                 (``blame_report``, ``channel_mix``, ``provenance_slos``,
                 ``infection_paths``, ``explain_belief``).

The reference's alarm engine and the rest of its query layer are not
ported yet.
Importing this package imports none of its modules.
"""
