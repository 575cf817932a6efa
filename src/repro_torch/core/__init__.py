"""FLEXIS core — the paper's contribution as a composable PyTorch module."""
from .graph import DataGraph, DeviceGraph, build_graph
from .pattern import Pattern, pattern_from_edges, paper_fig1
from .canonical import (
    are_isomorphic,
    automorphisms,
    canonical_form,
    canonical_key,
    dedupe_patterns,
)
from .generation import (
    core_graphs,
    core_groups,
    edge_extension_candidates,
    generate_new_patterns,
    size2_patterns,
)
from .health import HealthEvent, RunHealth
from .plan import PatternPlan, make_plan, stack_plans
from .matcher import MatchConfig, match_block
from .planner import (
    CostModel,
    ExecutionPlanner,
    LevelPlan,
    block_degree_stat,
    load_calibration,
    root_block_order,
)
from .flexis import (
    MiningConfig,
    MiningLoopState,
    MiningResult,
    PatternStats,
    evaluate_pattern,
    initial_candidates,
    mine,
    tau_threshold,
)

__all__ = [
    "DataGraph", "DeviceGraph", "build_graph",
    "Pattern", "pattern_from_edges", "paper_fig1",
    "are_isomorphic", "automorphisms", "canonical_form", "canonical_key",
    "dedupe_patterns",
    "core_graphs", "core_groups", "edge_extension_candidates",
    "generate_new_patterns", "size2_patterns",
    "HealthEvent", "RunHealth",
    "PatternPlan", "make_plan", "stack_plans", "MatchConfig", "match_block",
    "CostModel", "ExecutionPlanner", "LevelPlan", "block_degree_stat",
    "load_calibration", "root_block_order",
    "MiningConfig", "MiningLoopState", "MiningResult", "PatternStats", "evaluate_pattern",
    "initial_candidates", "mine", "tau_threshold",
]
