"""Observability of the port (the counterpart of ``hydragnn_tpu/obs/``):
the metrics registry and its exporters, the flight recorder and
per-request traces. Spool, drift, triggers, incidents and podview wait
for ROADMAP A-6."""

from hydragnn_tpu_torch.obs.flight import FlightRecorder, read_flight_record, validate_flight_record  # noqa: F401
from hydragnn_tpu_torch.obs.registry import MetricsRegistry  # noqa: F401
from hydragnn_tpu_torch.obs.trace import RequestTrace, Tracer  # noqa: F401
