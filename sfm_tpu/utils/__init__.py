"""Utilities: profiling/tracing hooks and metrics aggregation (the
compile-cache helper lives in ``utils.cache``)."""

from .profiling import (PhaseTimer, device_trace, summarize_metrics,
                        write_metrics_jsonl)
