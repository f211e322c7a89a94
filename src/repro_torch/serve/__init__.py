from repro_torch.serve.autotune import (AUTOTUNE_MODES, GridDecision,
                                       GridPlanner, default_candidates)
from repro_torch.serve.engine import (ContinuousEngine, EngineMetrics,
                                      GenerateResult, ServeEngine,
                                      sample_tokens)
from repro_torch.serve.faults import (ENGINE_FAULT_KINDS, FAULT_KINDS,
                                      FAULT_REQ, FLEET_FAULT_KINDS,
                                      FaultInjector, FaultPlan, FaultSpec,
                                      TransientFault, canned_fleet_plan,
                                      canned_plan)
from repro_torch.serve.frontend import (AsyncFrontend, AsyncStream,
                                        RequestResult, RequestTracker,
                                        TrackedRequest)
from repro_torch.serve.guard import (GUARD_STATES, EngineGuard,
                                     EngineSheddingError, GuardConfig,
                                     GuardSignals)
from repro_torch.serve.invariants import (InvariantViolation,
                                          check_invariants, leaked_blocks)
from repro_torch.serve.journal import (FSYNC_POLICIES, Journal,
                                       JournalCorrupt, ReplayedRequest,
                                       ReplayState, replay, state_digest)
from repro_torch.serve.kernel_costs import (DEFAULT_COST_PARAMS, CostParams,
                                            LaunchCost, decode_launch_cost,
                                            estimate_seconds,
                                            prefill_launch_cost)
from repro_torch.serve.kv_pool import PagedKVCache, PoolExhausted, PoolStats
from repro_torch.serve.metrics import (Counter, Gauge, Histogram,
                                       MetricRegistry, parse_prometheus_text)
from repro_torch.serve.radix_cache import CacheStats, RadixCache
from repro_torch.serve.router import (ROUTING_POLICIES, PlacementDecision,
                                      Router)
from repro_torch.serve.scheduler import (FINISH_CANCELLED, FINISH_DEADLINE,
                                         FINISH_FAILOVER, FINISH_LENGTH,
                                         FINISH_QUARANTINED,
                                         CapacityExceededError,
                                         DuplicateRequestError,
                                         EmptyPromptError, Request, Scheduler,
                                         SubmitError)
from repro_torch.serve.snapshot import (Snapshot, SnapshotCorrupt,
                                        apply_snapshot, engine_fingerprint,
                                        requeue_inflight, restore_engine,
                                        snapshot_state, write_snapshot)
from repro_torch.serve.supervisor import (FleetSupervisor, ReplicaHandle,
                                          snapshot_path)
from repro_torch.serve.telemetry import (ManualClock, RequestTrace,
                                         StepTimeline, Telemetry)

__all__ = ["AUTOTUNE_MODES", "GridDecision", "GridPlanner",
           "default_candidates", "DEFAULT_COST_PARAMS", "CostParams",
           "LaunchCost", "decode_launch_cost", "estimate_seconds",
           "prefill_launch_cost", "ContinuousEngine", "EngineMetrics",
           "GenerateResult", "ServeEngine", "sample_tokens",
           "InvariantViolation", "check_invariants", "leaked_blocks",
           "PagedKVCache", "PoolExhausted", "PoolStats", "CacheStats",
           "RadixCache", "Request", "Scheduler",
           "Counter", "Gauge", "Histogram", "MetricRegistry",
           "parse_prometheus_text", "ManualClock", "RequestTrace",
           "StepTimeline", "Telemetry",
           # resilience layer
           "FAULT_KINDS", "FAULT_REQ", "FaultInjector", "FaultPlan",
           "FaultSpec", "TransientFault", "canned_plan",
           "ENGINE_FAULT_KINDS", "FLEET_FAULT_KINDS", "canned_fleet_plan",
           "GUARD_STATES", "EngineGuard", "EngineSheddingError",
           "GuardConfig", "GuardSignals",
           "SubmitError", "EmptyPromptError", "DuplicateRequestError",
           "CapacityExceededError", "FINISH_LENGTH", "FINISH_CANCELLED",
           "FINISH_DEADLINE", "FINISH_QUARANTINED", "FINISH_FAILOVER",
           # fleet serving layer
           "AsyncFrontend", "AsyncStream", "RequestResult", "RequestTracker",
           "TrackedRequest", "Journal", "JournalCorrupt", "ReplayState",
           "ReplayedRequest", "replay", "ROUTING_POLICIES",
           "PlacementDecision", "Router", "FleetSupervisor", "ReplicaHandle",
           # durability layer
           "FSYNC_POLICIES", "state_digest", "Snapshot", "SnapshotCorrupt",
           "apply_snapshot", "engine_fingerprint", "requeue_inflight",
           "restore_engine", "snapshot_state", "write_snapshot",
           "snapshot_path"]
