"""The port's serving stack: the dense and paged engines, the page
allocator, and the fleet above them (router, streaming front end, SLO
accounting, workloads and the capacity planner)."""

from repro_torch.serve.engine import (  # noqa: F401
    PagedServeEngine, Request, ServeEngine,
)
from repro_torch.serve.fleet import (  # noqa: F401
    FleetEngine, FleetReplica, RouteDecision, RouteScore,
    resolve_fleet_profile,
)
from repro_torch.serve.frontend import (  # noqa: F401
    Backpressure, FleetFrontend, StreamHandle,
)
from repro_torch.serve.paging import (  # noqa: F401
    OutOfPages, PageAllocator, choose_page_len, page_len_rationale,
)
from repro_torch.serve.planner import (  # noqa: F401
    CapacityPlan, ReplicaModel, SLOTarget, characterize_replica,
    plan_capacity, plan_for_trace, rank_profiles,
)
from repro_torch.serve.slo import (  # noqa: F401
    SLOReport, SLOTracker, percentile,
)
from repro_torch.serve.workload import (  # noqa: F401
    ARRIVALS, SCENARIOS, Scenario, Trace, TraceRequest, WorkloadSpec,
    generate_trace, replay_trace,
)
