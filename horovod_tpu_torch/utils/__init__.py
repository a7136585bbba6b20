"""Aux subsystems (port of ``horovod_tpu/utils``): timeline tracing with
its flight recorder, job-wide trace merge and clock sync, and the
``torch.profiler`` glue.  The JAX package's checkpoint module is not
ported (ROADMAP.md A)."""

from .timeline import Timeline  # noqa: F401
from .profiler import (  # noqa: F401
    annotate, profile, start_profile, stop_profile,
)
from .clock_sync import ClockSync, estimate_offset  # noqa: F401
from .trace_merge import load_trace, merge_traces  # noqa: F401
