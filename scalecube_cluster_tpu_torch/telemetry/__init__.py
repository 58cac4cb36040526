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
                 ``MetricsPlane``, ``to_json``, ``stream_metered_run``
                 with its live alarms);
  - ``sink``     JSONL run journals (``TelemetrySink``, ``read_records``,
                 ``covered_upto``, ``JournalFollower``, ...) in the
                 reference's record kinds, ``stream_traced_run``, and the
                 gated TensorBoard export;
  - ``alarms``   the live SLO alarm engine (``AlarmSpec``,
                 ``default_specs``, ``AlarmEngine``, ``replay_journal``,
                 ``write_transitions``);
  - ``query``    health reports over journals (``load_report``,
                 ``merge_reports``, ``compute_slos``, ``diff_reports``),
                 the ``regress`` gate over bench artifacts, and the blame
                 engine over provenance rows (``blame_report``,
                 ``channel_mix``, ``provenance_slos``,
                 ``infection_paths``, ``explain_belief``);
  - ``__main__`` the CLI, ``python -m
                 scalecube_cluster_tpu_torch.telemetry {report, diff,
                 watch, explain, regress}``.

Importing this package imports none of its modules.
"""
