from repro_torch.serve.autotune import (AUTOTUNE_MODES, GridDecision,
                                       GridPlanner, default_candidates)
from repro_torch.serve.engine import (ContinuousEngine, EngineMetrics,
                                      GenerateResult, ServeEngine,
                                      sample_tokens)
from repro_torch.serve.invariants import (InvariantViolation,
                                          check_invariants, leaked_blocks)
from repro_torch.serve.kernel_costs import (DEFAULT_COST_PARAMS, CostParams,
                                            LaunchCost, decode_launch_cost,
                                            estimate_seconds,
                                            prefill_launch_cost)
from repro_torch.serve.kv_pool import PagedKVCache, PoolExhausted, PoolStats
from repro_torch.serve.radix_cache import CacheStats, RadixCache
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["AUTOTUNE_MODES", "GridDecision", "GridPlanner",
           "default_candidates", "DEFAULT_COST_PARAMS", "CostParams",
           "LaunchCost", "decode_launch_cost", "estimate_seconds",
           "prefill_launch_cost", "ContinuousEngine", "EngineMetrics", "GenerateResult",
           "ServeEngine", "sample_tokens",
           "InvariantViolation", "check_invariants", "leaked_blocks",
           "PagedKVCache", "PoolExhausted", "PoolStats", "CacheStats",
           "RadixCache", "Request", "Scheduler"]
