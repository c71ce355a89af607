"""Cluster simulator + compound-LLM workload generators (paper §V)."""

from .simulator import ClusterSim, SimResult, default_latency_profile, simulate
from .workloads import (
    ALL_GENERATORS,
    WORKLOAD_MIXES,
    AppGenerator,
    CodeGeneration,
    DocMerging,
    GeneratedJob,
    LLMCompiler,
    SequenceSorting,
    TaskAutomation,
    WebSearch,
    TIER_POOLS,
    generate_traces,
    generate_workload,
    get_generators,
    tier_pool,
)

__all__ = [
    "ClusterSim", "SimResult", "default_latency_profile", "simulate",
    "ALL_GENERATORS", "WORKLOAD_MIXES", "AppGenerator", "CodeGeneration",
    "DocMerging", "GeneratedJob", "LLMCompiler", "SequenceSorting",
    "TaskAutomation", "WebSearch", "TIER_POOLS", "generate_traces",
    "generate_workload", "get_generators", "tier_pool",
]
