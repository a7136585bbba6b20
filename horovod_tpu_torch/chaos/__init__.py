"""Chaos subsystem (port of ``horovod_tpu/chaos``): deterministic fault
injection for the robustness surface.

* :mod:`.plan` — the seeded, declarative fault-plan schema
  (``HOROVOD_FAULT_PLAN`` / ``horovodrun --fault-plan``);
* :mod:`.inject` — the worker-side injector threading plans through
  the real fabric client, engine loop and process lifecycle, and the
  launcher's and aggregator owner's service fault runners.

Coordinator-side events (``"side": "coord"``) are installed by the
launcher into its rendezvous service
(runner/http/http_server.py ``Coordinator.add_chaos_rule``); the
service-targeting kinds (``coord_kill`` / ``coord_restart``) are
applied by the launcher's :class:`.inject.CoordFaultRunner`, which
kills the rendezvous HTTP service itself and (for restarts) rebuilds
it from the control-plane journal; ``agg_kill`` / ``agg_restart`` by
the aggregator owner's :class:`.inject.AggFaultRunner`.
"""

from .plan import (  # noqa: F401
    COORD_KINDS, FaultEvent, FaultPlan, KINDS, load_plan, parse_plan,
    plan_from_env,
)
from .inject import (  # noqa: F401
    CoordFaultRunner, FaultInjector, current, current_skew_seconds,
    install, install_coordinator_rules, start_coordinator_faults,
)
