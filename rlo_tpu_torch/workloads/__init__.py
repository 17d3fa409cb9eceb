"""Traffic laboratory (docs/DESIGN.md §14): seeded trace generators
(traces.py) and network-weather profiles (weather.py) feeding the
deterministic simulator, the serving benches, and
benchmarks/workload_bench.py. Everything here is clock-free and
seed-replayable (rlo-lint R5 scope).

The port's own copy of ``rlo_tpu/workloads/__init__.py``, line for line:
only the imports and the logger names differ, so both packages give the
same results and the same bytes for the same seed
(``tests/test_torch_workloads.py`` holds them equal)."""

from rlo_tpu_torch.workloads.traces import (TRACE_KINDS, TRACE_SCHEMA, Trace,
                                            TraceError, TraceRequest,
                                            compat_digest, make_trace,
                                            poisson_compat, trace_digest)
from rlo_tpu_torch.workloads.weather import (WEATHER_KINDS, GilbertLoss,
                                             HeavyTailDelay, Weather,
                                             churn_script, make_weather)

__all__ = [
    "TRACE_KINDS", "TRACE_SCHEMA", "Trace", "TraceError",
    "TraceRequest", "compat_digest", "make_trace", "poisson_compat",
    "trace_digest",
    "WEATHER_KINDS", "GilbertLoss", "HeavyTailDelay", "Weather",
    "churn_script", "make_weather",
]
