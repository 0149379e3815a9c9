"""POAS core — the paper's contribution (Predict, Optimize, Adapt, Schedule).

Public API:
    DeviceProfile, LinearTimeModel, RooflineTimeModel, CopyModel
    fit_linear, Profiler, host_cpu_runner, cuda_kernel_runner
    solve_bisection, solve_analytic, solve_local_search, OptimizeResult
    ops_to_mnk, decompose_square, squareness, GemmPlan
    Link, BusTopology, build_timeline, engine_finish_times, with_pipeline
    StaticScheduler, DynamicScheduler, simulate_timeline, Timeline
    Domain, PlanCache, register_domain, get_domain, list_domains
    OverlappedExecutor, DeviceTask
    POAS, GemmWorkload, GemmDomain, make_gemm_poas, HGemms
    TaskGraph, TaskNode, TaskGraphDomain, solve_list_schedule,
    build_graph_timeline, transformer_block, CoExecutionRuntime,
    ObservationPump, Tenant, StreamJob
"""
from .bus import (BusEvent, BusTopology, ClockState, GraphSimContext,
                  GraphSimState, GraphTimelineSpec,
                  Link, TaskSpec, Timeline, TimelineSpec,
                  build_graph_timeline, build_timeline, carry_clocks,
                  engine_finish_times, graph_finish_times)
from .device_model import (CopyModel, DeviceProfile, LinearTimeModel, NO_COPY,
                           RooflineTimeModel, paper_mach1, paper_mach2,
                           priority_order, tpu_group, with_pipeline,
                           TPU_PEAK_FLOPS, TPU_HBM_BW, TPU_ICI_BW,
                           TPU_VMEM_BYTES)
from .predict import (Profiler, cuda_kernel_runner, fit_linear,
                      host_cpu_runner, load_profiles, relative_error, rmse,
                      save_profiles, simulated_runner)
from .optimize import (GraphScheduleResult, MAKESPAN_OBJECTIVE, Objective,
                       OptimizeResult, SHARED_TEMPLATE_CACHE,
                       TemplatePlanCache, divisible_energy, graph_energy,
                       solve_analytic, solve_bisection, solve_hierarchical,
                       solve_list_schedule, solve_local_search)
from .adapt import (DeviceAssignment, GemmPlan, SubProduct, decompose_square,
                    ops_to_mnk, squareness)
from .schedule import (DynamicScheduler, Schedule, StaticScheduler,
                       simulate_graph_timeline, simulate_timeline)
from .graph import (GraphPlan, TaskGraph, TaskGraphDomain, TaskNode,
                    TemplatePartition, detect_templates, diamond, moe_block,
                    moe_stack, ssm_block, ssm_stack, transformer_block,
                    transformer_stack, verify_graph_dependencies)
from .domain import (Domain, FunctionDomain, PlanCache, QoS, TIER_BATCH,
                     TIER_LATENCY, Workload, device_signature, get_domain,
                     list_domains, register_domain)
from .executor import (DeviceTask, JobHandle, OverlappedExecutor, StreamCore,
                       TicketBus)
from .framework import (GemmDomain, GemmWorkload, POAS, POASPlan,
                        make_gemm_poas)
from .hgemms import ExecutionReport, HGemms
from .runtime import (AdmissionRejected, CoExecutionRuntime, FairAdmission,
                      ObservationPump, ReplanRecord, StreamJob, Tenant,
                      copy_throttled, model_sleep_tasks, throttled,
                      truth_from_profiles, verify_stream_invariants)

__all__ = [
    "BusEvent", "BusTopology", "Link", "build_timeline",
    "engine_finish_times",
    "CopyModel", "DeviceProfile", "LinearTimeModel", "NO_COPY",
    "RooflineTimeModel", "paper_mach1", "paper_mach2", "priority_order",
    "tpu_group", "with_pipeline", "TPU_PEAK_FLOPS", "TPU_HBM_BW",
    "TPU_ICI_BW", "TPU_VMEM_BYTES",
    "Profiler", "cuda_kernel_runner", "fit_linear", "host_cpu_runner",
    "load_profiles", "relative_error", "rmse", "save_profiles",
    "simulated_runner",
    "OptimizeResult", "solve_analytic", "solve_bisection",
    "solve_local_search",
    "DeviceAssignment", "GemmPlan", "SubProduct", "decompose_square",
    "ops_to_mnk", "squareness",
    "DynamicScheduler", "Schedule", "StaticScheduler",
    "Timeline", "simulate_timeline",
    "Domain", "FunctionDomain", "PlanCache", "QoS", "TIER_BATCH",
    "TIER_LATENCY", "Workload", "device_signature",
    "get_domain", "list_domains", "register_domain",
    "DeviceTask", "JobHandle", "OverlappedExecutor", "StreamCore",
    "TicketBus",
    "GemmDomain", "GemmWorkload", "POAS", "POASPlan", "make_gemm_poas",
    "ExecutionReport", "HGemms",
    "ClockState", "TimelineSpec", "carry_clocks",
    "AdmissionRejected", "CoExecutionRuntime", "FairAdmission",
    "ObservationPump", "ReplanRecord", "StreamJob", "Tenant",
    "copy_throttled", "model_sleep_tasks", "throttled",
    "truth_from_profiles", "verify_stream_invariants",
    "GraphSimContext", "GraphSimState",
    "GraphTimelineSpec", "TaskSpec", "build_graph_timeline",
    "graph_finish_times", "GraphScheduleResult", "solve_list_schedule",
    "simulate_graph_timeline",
    "GraphPlan", "TaskGraph", "TaskGraphDomain", "TaskNode", "diamond",
    "moe_block", "moe_stack", "ssm_block", "ssm_stack",
    "transformer_block", "transformer_stack",
    "verify_graph_dependencies",
    "SHARED_TEMPLATE_CACHE", "TemplatePlanCache", "TemplatePartition",
    "detect_templates", "solve_hierarchical",
    "MAKESPAN_OBJECTIVE", "Objective", "divisible_energy", "graph_energy",
]
