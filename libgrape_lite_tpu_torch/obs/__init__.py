"""obs/ -- superstep tracing, a metrics registry and the telemetry plane.

Counterpart of `libgrape_lite_tpu/obs/`.  The worker emits nested host
spans (`query`, `peval`, one `superstep` a round) under the CUDA timing
convention of tracer.py; the loader, the serving session and pump, the
fleet router and the SLO surface attach their spans, instants and
metrics to the same timeline; a `MetricsRegistry` holds counters,
gauges, histograms and per-round series.  Export: JSONL and Chrome
`trace_event` JSON (Perfetto loads it), and Prometheus-text / JSON
metrics.  `libgrape_lite_tpu_torch/scripts/trace_report.py` renders the
per-superstep table.

Off by default: `obs.tracer()` returns a disarmed singleton whose
`span()` is a sub-microsecond no-op.  Arming: GRAPE_TRACE=/path/t.json
and GRAPE_METRICS=/path/m (read once, lazily), `--trace` / `--metrics`
on `run_app` and `serve`, or `obs.configure(...)`.

The telemetry plane: `federation` (one snapshot of every ``*_STATS``
surface), `exporter` (the live OpenMetrics endpoint, GRAPE_METRICS_PORT
or `serve --metrics_port`), `slo` (latency objectives; a breach is an
instant and a counter, never an exception) and `recorder` (the flight
recorder's postmortem bundles, rendered by the `postmortem` subcommand).
`truth` joins a pipelined query's modeled hidden exchange to its measured
rounds.  `gang` is the plane across ranks: the clock handshake, per-rank
trace sidecars and their assembler (`trace_report --gang`), and the
distributed flight recorder under a shared incident id.
"""

from libgrape_lite_tpu_torch.obs import federation
from libgrape_lite_tpu_torch.obs import gang
from libgrape_lite_tpu_torch.obs.config import (
    METRICS_ENV,
    TRACE_ENV,
    armed,
    configure,
    flush,
    history,
    metrics,
    reset,
    trace_id,
    tracer,
)
from libgrape_lite_tpu_torch.obs.exporter import (
    METRICS_PORT_ENV,
    MetricsExporter,
    maybe_start_from_env,
    start_exporter,
    stop_exporter,
)
from libgrape_lite_tpu_torch.obs.export import (
    load_trace,
    rollup,
    write_chrome_trace,
)
from libgrape_lite_tpu_torch.obs.federation import FederatedStats
from libgrape_lite_tpu_torch.obs import slo
from libgrape_lite_tpu_torch.obs.metrics import NULL_METRICS, MetricsRegistry
from libgrape_lite_tpu_torch.obs.recorder import RECORDER, FlightRecorder
from libgrape_lite_tpu_torch.obs.slo import SLO_STATS
from libgrape_lite_tpu_torch.obs.tracer import NULL_SPAN, Span, Tracer

__all__ = [
    "federation",
    "gang",
    "slo",
    "FederatedStats",
    "SLO_STATS",
    "METRICS_PORT_ENV",
    "MetricsExporter",
    "maybe_start_from_env",
    "start_exporter",
    "stop_exporter",
    "RECORDER",
    "FlightRecorder",
    "METRICS_ENV",
    "TRACE_ENV",
    "armed",
    "configure",
    "flush",
    "history",
    "metrics",
    "reset",
    "trace_id",
    "tracer",
    "load_trace",
    "rollup",
    "write_chrome_trace",
    "MetricsRegistry",
    "NULL_METRICS",
    "NULL_SPAN",
    "Span",
    "Tracer",
]
