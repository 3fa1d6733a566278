"""Observability of the port (the counterpart of ``hydragnn_tpu/obs/``):
the metrics registry (with the process-global one of the training loop)
and its exporters, the flight recorder, per-request traces, the training
loop's step spans, compile monitor, per-head diagnostics and hardware
ledger, the drift reference window and the live drift monitor, the
sampled request spool, the Chrome trace export, and the SLO and drift
triggers with their incident bundles, and the pod-visibility plane
(per-host flight shards, their merge, the skew monitor).

``HGTORCH_TELEMETRY=0`` disables the global registry and everything the
training loop wires up; each piece can also be made enabled or
disabled on its own."""

from hydragnn_tpu_torch.obs.compile_monitor import CompileMonitor  # noqa: F401
from hydragnn_tpu_torch.obs.drift import (  # noqa: F401
    QUANTILE_PROBES,
    REFERENCE_SCHEMA,
    DriftMonitor,
    P2Quantile,
    RunningMoments,
    build_reference,
    load_reference,
    psi,
    validate_drift_report,
)
from hydragnn_tpu_torch.obs.export import (  # noqa: F401
    prometheus_name,
    registry_to_jsonl,
    registry_to_prometheus,
    registry_to_prometheus_text,
    registry_to_tensorboard,
)
from hydragnn_tpu_torch.obs.flight import (  # noqa: F401
    SCHEMA_VERSION,
    SUPPORTED_SCHEMA_VERSIONS,
    FlightRecorder,
    flight_record_warnings,
    read_flight_record,
    validate_flight_record,
)
from hydragnn_tpu_torch.obs.introspect import (  # noqa: F401
    HardwareLedger,
    HeadDiagnostics,
    collect_head_series,
    conv_traffic_model,
    device_memory_stats,
    flag_anomalies,
    make_diagnostics_step,
    pad_waste_from_batch,
    peak_flops,
    peak_hbm_bw,
    per_head_error_metrics,
)
from hydragnn_tpu_torch.obs.podview import (  # noqa: F401
    MergedFlights,
    SkewMonitor,
    collective_attribution,
    host_artifact_path,
    host_epoch_table,
    host_flight_path,
    host_identity,
    list_host_shards,
    merge_host_flights,
    podview_enabled,
    resolve_run_id,
    straggler_spec,
    validate_podview_report,
)
from hydragnn_tpu_torch.obs.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    reset_registry,
    telemetry_enabled,
)
from hydragnn_tpu_torch.obs.spans import StepSpans  # noqa: F401
from hydragnn_tpu_torch.obs.spool import RequestSpool, list_shards, read_spool, validate_spool_manifest  # noqa: F401
from hydragnn_tpu_torch.obs.trace import (  # noqa: F401
    RequestTrace,
    Tracer,
    export_flight_chrome,
    flight_to_chrome,
    new_trace_id,
    trace_enabled,
)
from hydragnn_tpu_torch.obs.triggers import (  # noqa: F401
    RULE_KINDS,
    Incident,
    IncidentRecorder,
    TriggerEngine,
    TriggerRule,
    TriggerVerdict,
    list_incidents,
    validate_incident_bundle,
    validate_incident_manifest,
)
