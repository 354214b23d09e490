"""Observability (port of `observability/`): the span tracer (`trace.py`,
host-side timeline, Chrome trace export), the metrics registry
(`metrics.py`, streaming quantiles, Prometheus and JSON export), the
cost engine (`cost.py`, H100 constants, and `costgate.py` over
`cost_ledger.json`), and the measured half that closes the loop: trace
attribution over the tracer's traces and torch.profiler's
(`attribution.py`), constant calibration from measured rows
(`calibrate.py`), and the unified run report with its pre-gate
(`report.py`)."""

from distributed_model_parallel_tpu_torch.observability.metrics import (  # noqa: F401,E501
    MetricsRegistry,
    exact_quantile,
    get_metrics,
    set_metrics,
)
from distributed_model_parallel_tpu_torch.observability.trace import (  # noqa: F401,E501
    Tracer,
    disable,
    enable,
    get_tracer,
    set_tracer,
)

__all__ = [
    "MetricsRegistry",
    "Tracer",
    "disable",
    "enable",
    "exact_quantile",
    "get_metrics",
    "get_tracer",
    "set_metrics",
    "set_tracer",
]
