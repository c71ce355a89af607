"""Workload generators: the paper's six compound LLM applications (§V).

Each generator builds an :class:`ApplicationTemplate` and samples runtime
jobs with ground-truth durations/structures.  Ground truth is *hidden*
from schedulers: they see stage durations only after completion, chain
lengths only as iterations reveal themselves, and dynamic-stage contents
only after the planner LLM stage finishes.

Duration models follow the paper's measured characteristics (§III):
- sequence sorting : job duration ~10–300 s, stage durations strongly
  correlated through the latent sequence length (Fig. 5a: r≈0.7);
- code generation  : chain length 3–15 stages (Fig. 1b), iterations
  correlated (Fig. 5b: r≈0.9) via a latent task complexity;
- task automation  : 1–8 generated stages (Fig. 1c), job 1–116 s;
- doc merging / web search / LLMCompiler follow the same recipes.

LLM-task durations are expressed as ``out_tokens`` × per-token latency at
batch size 1; the simulator stretches them with the batching profile, so
batching-aware calibration (Eq. 2) has a real effect to correct for.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.dag import (
    SLO,
    ApplicationTemplate,
    Job,
    Stage,
    StageTemplate,
    StageType,
    Task,
    make_job,
)
from ..core.profiler import JobTrace

# per-token decode latency at batch size 1 used to convert token counts
# into seconds (the simulator's l(1); see repro_torch.core.calibration).
TOKEN_LATENCY_B1 = 0.02  # 20 ms/token — Llama2-7B-class on one accelerator


# ---------------------------------------------------------------------------
# Generator base
# ---------------------------------------------------------------------------
@dataclass
class GeneratedJob:
    job: Job
    # ground-truth per-stage durations (for traces/inspection)
    durations: Dict[str, float] = field(default_factory=dict)


class AppGenerator:
    """Base class: builds the template and samples jobs."""

    name: str = "base"

    def __init__(self) -> None:
        self.template = self.build_template()

    def build_template(self) -> ApplicationTemplate:
        raise NotImplementedError

    def sample(self, rng: np.random.Generator, arrival_time: float) -> GeneratedJob:
        raise NotImplementedError

    # -- shared helpers -----------------------------------------------------
    def _set_llm_stage(self, job: Job, name: str, out_tokens: int,
                       n_tasks: Optional[int] = None) -> float:
        st = job.stages[name]
        dur = out_tokens * TOKEN_LATENCY_B1
        for t in st.tasks:
            t.true_duration = dur
            t.out_tokens = out_tokens
        return dur

    def _set_regular_stage(self, job: Job, name: str, duration: float) -> float:
        st = job.stages[name]
        for t in st.tasks:
            t.true_duration = duration
        return duration

    def trace_of(self, gj: GeneratedJob) -> JobTrace:
        """Offline trace (durations at batch size 1) for BN training."""
        dyn_durs: Dict[str, Dict[str, float]] = {}
        for dname, (cands, _e) in gj.job.dynamic_realization.items():
            dyn_durs[dname] = {
                c: gj.durations.get(f"{dname}.{c}", 0.0) for c in cands
            }
        return JobTrace(
            app_name=self.name,
            durations={
                k: v for k, v in gj.durations.items() if "." not in k
            },
            dynamic=dict(gj.job.dynamic_realization),
            dynamic_durations=dyn_durs,
        )


# ---------------------------------------------------------------------------
# 1. Sequence sorting (predefined — Graph-of-Thoughts)
# ---------------------------------------------------------------------------
class SequenceSorting(AppGenerator):
    """GoT sorting: split → per-part candidate generation (multi-task LLM)
    → scoring (regular) → merge (LLM) → refine (LLM) → final score.
    Stage durations proportional to the latent sequence length."""

    name = "seq_sort"

    def build_template(self) -> ApplicationTemplate:
        stages = [
            StageTemplate("split", StageType.LLM),
            StageTemplate("sort_p1", StageType.LLM, num_tasks=3),
            StageTemplate("sort_p2", StageType.LLM, num_tasks=3),
            StageTemplate("score_p1", StageType.REGULAR),
            StageTemplate("score_p2", StageType.REGULAR),
            StageTemplate("merge", StageType.LLM),
            StageTemplate("refine", StageType.LLM, num_tasks=2),
            StageTemplate("final_score", StageType.REGULAR),
        ]
        edges = [
            ("split", "sort_p1"), ("split", "sort_p2"),
            ("sort_p1", "score_p1"), ("sort_p2", "score_p2"),
            ("score_p1", "merge"), ("score_p2", "merge"),
            ("merge", "refine"), ("refine", "final_score"),
        ]
        return ApplicationTemplate(self.name, stages, edges)

    def sample(self, rng: np.random.Generator, arrival_time: float) -> GeneratedJob:
        job = make_job(self.template, arrival_time)
        seq_len = int(rng.integers(16, 65))  # paper: 16–64
        latent = float(rng.lognormal(0.0, 0.5))      # job-level difficulty
        noise = lambda: latent * float(rng.lognormal(0.0, 0.2))
        durs: Dict[str, float] = {}
        durs["split"] = self._set_llm_stage(job, "split", int(seq_len * 2 * noise()))
        half = seq_len / 2
        durs["sort_p1"] = self._set_llm_stage(job, "sort_p1", int(half * 16 * noise()))
        durs["sort_p2"] = self._set_llm_stage(job, "sort_p2", int(half * 16 * noise()))
        durs["score_p1"] = self._set_regular_stage(job, "score_p1", 0.2 + 0.01 * half * noise())
        durs["score_p2"] = self._set_regular_stage(job, "score_p2", 0.2 + 0.01 * half * noise())
        durs["merge"] = self._set_llm_stage(job, "merge", int(seq_len * 10 * noise()))
        durs["refine"] = self._set_llm_stage(job, "refine", int(seq_len * 8 * noise()))
        durs["final_score"] = self._set_regular_stage(job, "final_score", 0.3 * noise())
        for s in job.stages.values():
            s.revealed = True  # predefined: structure known upfront
        return GeneratedJob(job, durs)


# ---------------------------------------------------------------------------
# 2. Document merging (predefined — Graph-of-Thoughts)
# ---------------------------------------------------------------------------
class DocMerging(AppGenerator):
    name = "doc_merge"

    def build_template(self) -> ApplicationTemplate:
        stages = [
            StageTemplate("gen_merge", StageType.LLM, num_tasks=4),
            StageTemplate("score_cand", StageType.REGULAR, num_tasks=4),
            StageTemplate("select", StageType.REGULAR),
            StageTemplate("final_merge", StageType.LLM),
            StageTemplate("final_score", StageType.REGULAR),
        ]
        edges = [
            ("gen_merge", "score_cand"), ("score_cand", "select"),
            ("select", "final_merge"), ("final_merge", "final_score"),
        ]
        return ApplicationTemplate(self.name, stages, edges)

    def sample(self, rng: np.random.Generator, arrival_time: float) -> GeneratedJob:
        job = make_job(self.template, arrival_time)
        doc_size = float(rng.lognormal(math.log(600), 0.7))  # latent doc tokens
        noise = lambda: float(rng.lognormal(0.0, 0.2))
        durs: Dict[str, float] = {}
        durs["gen_merge"] = self._set_llm_stage(job, "gen_merge", int(doc_size * noise()))
        durs["score_cand"] = self._set_regular_stage(job, "score_cand", 0.4 + doc_size * 4e-4 * noise())
        durs["select"] = self._set_regular_stage(job, "select", 0.1)
        durs["final_merge"] = self._set_llm_stage(job, "final_merge", int(doc_size * 0.8 * noise()))
        durs["final_score"] = self._set_regular_stage(job, "final_score", 0.3 * noise())
        for s in job.stages.values():
            s.revealed = True
        return GeneratedJob(job, durs)


# ---------------------------------------------------------------------------
# Chain-like base: padded iterations + early stopping
# ---------------------------------------------------------------------------
class ChainApp(AppGenerator):
    """Chain pattern: prologue + N iterations of (llm → regular → llm).
    Padded to MAX_ITERS (paper §IV-A); unexecuted stages get duration 0."""

    MAX_ITERS: int = 5
    PATTERN: List[Tuple[str, StageType]] = []
    PROLOGUE: List[Tuple[str, StageType]] = []

    def build_template(self) -> ApplicationTemplate:
        stages: List[StageTemplate] = []
        edges: List[Tuple[str, str]] = []
        prev: Optional[str] = None
        for n, st in self.PROLOGUE:
            stages.append(StageTemplate(n, st))
            if prev:
                edges.append((prev, n))
            prev = n
        for i in range(self.MAX_ITERS):
            for n, st in self.PATTERN:
                name = f"{n}_{i}"
                stages.append(StageTemplate(name, st, exec_prob=1.0))
                if prev:
                    edges.append((prev, name))
                prev = name
        return ApplicationTemplate(self.name, stages, edges)

    def _chain_iters(self, rng: np.random.Generator) -> int:
        """Number of executed iterations, 1..MAX_ITERS (geometric-ish)."""
        n = 1
        while n < self.MAX_ITERS and rng.random() > self.stop_prob:
            n += 1
        return n

    stop_prob = 0.45

    def mark_chain(self, job: Job, iters: int) -> None:
        """Set will_execute + reveal rules: finishing the last stage of
        iteration i reveals whether iteration i+1 runs."""
        for i in range(self.MAX_ITERS):
            execute = i < iters
            for n, _ in self.PATTERN:
                job.stages[f"{n}_{i}"].will_execute = execute
        # prologue + iteration 0 visible upfront
        for n, _ in self.PROLOGUE:
            job.stages[n].revealed = True
        for n, _ in self.PATTERN:
            job.stages[f"{n}_0"].revealed = True
        last = self.PATTERN[-1][0]
        for i in range(self.MAX_ITERS - 1):
            trigger = f"{last}_{i}"
            job.reveal_rules[trigger] = [f"{n}_{i+1}" for n, _ in self.PATTERN]


# ---------------------------------------------------------------------------
# 3. Code generation (chain-like — Reflexion on MBPP)
# ---------------------------------------------------------------------------
class CodeGeneration(ChainApp):
    name = "code_gen"
    MAX_ITERS = 5  # pattern of 3 → chain length 3–15+prologue ≈ paper Fig. 1b
    PROLOGUE = [("gen_tests", StageType.LLM)]
    PATTERN = [
        ("code_gen", StageType.LLM),
        ("code_exec", StageType.REGULAR),
        ("reflect", StageType.LLM),
    ]

    def sample(self, rng: np.random.Generator, arrival_time: float) -> GeneratedJob:
        job = make_job(self.template, arrival_time)
        iters = self._chain_iters(rng)
        self.mark_chain(job, iters)
        complexity = float(rng.lognormal(math.log(140), 0.8))  # latent tokens/iter
        noise = lambda: float(rng.lognormal(0.0, 0.15))
        durs: Dict[str, float] = {}
        durs["gen_tests"] = self._set_llm_stage(job, "gen_tests", int(60 * noise()))
        for i in range(self.MAX_ITERS):
            if i < iters:
                # iterations correlated through `complexity` (Fig. 5b r≈0.9)
                durs[f"code_gen_{i}"] = self._set_llm_stage(
                    job, f"code_gen_{i}", int(complexity * noise())
                )
                durs[f"code_exec_{i}"] = self._set_regular_stage(
                    job, f"code_exec_{i}", 0.3 + 0.2 * noise()
                )
                durs[f"reflect_{i}"] = self._set_llm_stage(
                    job, f"reflect_{i}", int(0.5 * complexity * noise())
                )
            else:
                for n, _ in self.PATTERN:
                    durs[f"{n}_{i}"] = 0.0
        return GeneratedJob(job, durs)


# ---------------------------------------------------------------------------
# 4. Web search (chain-like — ReAct on HotpotQA)
# ---------------------------------------------------------------------------
class WebSearch(ChainApp):
    name = "web_search"
    MAX_ITERS = 4
    PROLOGUE: List[Tuple[str, StageType]] = []
    PATTERN = [
        ("think", StageType.LLM),
        ("search", StageType.REGULAR),
    ]
    stop_prob = 0.5

    def sample(self, rng: np.random.Generator, arrival_time: float) -> GeneratedJob:
        job = make_job(self.template, arrival_time)
        iters = self._chain_iters(rng)
        self.mark_chain(job, iters)
        hop = float(rng.lognormal(math.log(45), 0.7))
        noise = lambda: float(rng.lognormal(0.0, 0.2))
        durs: Dict[str, float] = {}
        for i in range(self.MAX_ITERS):
            if i < iters:
                durs[f"think_{i}"] = self._set_llm_stage(job, f"think_{i}", int(hop * noise()))
                durs[f"search_{i}"] = self._set_regular_stage(job, f"search_{i}", 0.5 + 0.5 * noise())
            else:
                durs[f"think_{i}"] = 0.0
                durs[f"search_{i}"] = 0.0
        return GeneratedJob(job, durs)


# ---------------------------------------------------------------------------
# Planning base: LLM plan stage + dynamic stage
# ---------------------------------------------------------------------------
class PlanningApp(AppGenerator):
    CANDIDATES: List[Tuple[str, StageType, float]] = []  # (name, type, select prob)
    CAND_EDGES: List[Tuple[str, str, float]] = []        # (u, v, prob | both chosen)
    MAX_STAGES = 8

    def expand_dynamic(self, job: Job, dyn_name: str) -> List[Stage]:
        """Realize the dynamic stage: create inner stages + dependencies.
        Called by the runtime when the preceding LLM stage finishes."""
        chosen, edges = job.dynamic_realization.get(dyn_name, ((), ()))
        dyn = job.stages[dyn_name]
        created: List[Stage] = []
        parent_names = job.parents_of(dyn_name)
        for c in chosen:
            full = f"{dyn_name}.{c}"
            tpl = StageTemplate(full, self._cand_type(c))
            st = Stage(job_id=job.job_id, template=tpl, revealed=True)
            st.tasks = [
                Task(
                    job_id=job.job_id,
                    stage_name=full,
                    index=0,
                    is_llm=(tpl.stype is StageType.LLM),
                    true_duration=job._dyn_durs[dyn_name][c],  # type: ignore[attr-defined]
                    out_tokens=int(job._dyn_durs[dyn_name][c] / TOKEN_LATENCY_B1),  # type: ignore[attr-defined]
                )
            ]
            job.stages[full] = st
            job.extra_parents[full] = list(parent_names)
            created.append(st)
        for u, v in edges:
            job.extra_parents.setdefault(f"{dyn_name}.{v}", []).append(f"{dyn_name}.{u}")
        # dynamic stage children wait on the inner sinks (stages with no
        # outgoing edge inside the plan)
        sinks = [f"{dyn_name}.{c}" for c in chosen if all(u != c for u, _v in edges)]
        for child in job.app.children(dyn_name):
            job.extra_parents.setdefault(child, []).extend(
                sinks or [f"{dyn_name}.{c}" for c in chosen]
            )
        # the placeholder itself becomes a structural no-op
        dyn.will_execute = False
        dyn.revealed = True
        return created

    def _cand_type(self, cand: str) -> StageType:
        for n, t, _ in self.CANDIDATES:
            if n == cand:
                return t
        return StageType.REGULAR

    def _sample_plan(
        self, rng: np.random.Generator
    ) -> Tuple[Tuple[str, ...], Tuple[Tuple[str, str], ...]]:
        chosen = [n for n, _, p in self.CANDIDATES if rng.random() < p]
        if not chosen:
            chosen = [self.CANDIDATES[int(rng.integers(len(self.CANDIDATES)))][0]]
        chosen = chosen[: self.MAX_STAGES]
        edges = [
            (u, v)
            for u, v, p in self.CAND_EDGES
            if u in chosen and v in chosen and rng.random() < p
        ]
        return tuple(chosen), tuple(edges)


# ---------------------------------------------------------------------------
# 5. Task automation (planning — TaskBench / HuggingGPT)
# ---------------------------------------------------------------------------
class TaskAutomation(PlanningApp):
    name = "task_auto"
    CANDIDATES = [
        ("translate", StageType.REGULAR, 0.55),
        ("img_seg", StageType.REGULAR, 0.45),
        ("obj_detect", StageType.REGULAR, 0.5),
        ("asr", StageType.REGULAR, 0.3),
        ("summarize", StageType.LLM, 0.4),
        ("caption", StageType.LLM, 0.35),
        ("qa", StageType.LLM, 0.3),
        ("tts", StageType.REGULAR, 0.2),
    ]
    CAND_EDGES = [
        ("obj_detect", "caption", 0.6),
        ("img_seg", "obj_detect", 0.5),
        ("asr", "translate", 0.5),
        ("translate", "summarize", 0.5),
        ("caption", "qa", 0.4),
        ("summarize", "tts", 0.5),
    ]

    def build_template(self) -> ApplicationTemplate:
        stages = [
            StageTemplate("plan", StageType.LLM),
            StageTemplate(
                "auto_tools",
                StageType.DYNAMIC,
                candidates=tuple(n for n, _, _ in self.CANDIDATES),
                candidate_edges=tuple((u, v) for u, v, _ in self.CAND_EDGES),
            ),
            StageTemplate("respond", StageType.LLM),
        ]
        edges = [("plan", "auto_tools"), ("auto_tools", "respond")]
        return ApplicationTemplate(self.name, stages, edges)

    TOOL_DUR = {
        "translate": (1.2, 0.4), "img_seg": (2.0, 0.6), "obj_detect": (1.5, 0.5),
        "asr": (2.5, 0.8), "summarize": (150, 0.8), "caption": (80, 0.7),
        "qa": (120, 0.8), "tts": (1.8, 0.5),
    }

    def sample(self, rng: np.random.Generator, arrival_time: float) -> GeneratedJob:
        job = make_job(self.template, arrival_time)
        chosen, edges = self._sample_plan(rng)
        job.dynamic_realization["auto_tools"] = (chosen, edges)
        noise = lambda s: float(rng.lognormal(0.0, s))
        durs: Dict[str, float] = {}
        durs["plan"] = self._set_llm_stage(job, "plan", int(40 * (1 + 0.3 * len(chosen)) * noise(0.2)))
        dyn_durs: Dict[str, float] = {}
        total_inner = 0.0
        for c in chosen:
            mu, sig = self.TOOL_DUR[c]
            if self._cand_type(c) is StageType.LLM:
                d = mu * TOKEN_LATENCY_B1 * 10 * noise(sig)  # token-count based
            else:
                d = mu * noise(sig)
            dyn_durs[c] = d
            durs[f"auto_tools.{c}"] = d
            total_inner += d
        job._dyn_durs = {"auto_tools": dyn_durs}  # type: ignore[attr-defined]
        durs["auto_tools"] = total_inner  # BN variable: total inner duration
        durs["respond"] = self._set_llm_stage(job, "respond", int(50 * noise(0.3)))
        job.stages["plan"].revealed = True
        job.stages["respond"].revealed = True
        # dynamic stage: existence known, contents not; carries no tasks itself
        job.stages["auto_tools"].tasks = []
        job.stages["auto_tools"].revealed = False
        return GeneratedJob(job, durs)


# ---------------------------------------------------------------------------
# 6. LLMCompiler (planning — parallel function calling on HotpotQA)
# ---------------------------------------------------------------------------
class LLMCompiler(PlanningApp):
    name = "llm_compiler"
    CANDIDATES = [
        (f"call_{i}", StageType.REGULAR, p)
        for i, p in enumerate([0.9, 0.8, 0.6, 0.5, 0.4, 0.3, 0.2, 0.15])
    ]
    CAND_EDGES: List[Tuple[str, str, float]] = []  # high stage parallelism

    def build_template(self) -> ApplicationTemplate:
        stages = [
            StageTemplate("plan", StageType.LLM),
            StageTemplate(
                "calls",
                StageType.DYNAMIC,
                candidates=tuple(n for n, _, _ in self.CANDIDATES),
                candidate_edges=(),
            ),
            StageTemplate("join", StageType.LLM),
        ]
        return ApplicationTemplate(self.name, stages, [("plan", "calls"), ("calls", "join")])

    def sample(self, rng: np.random.Generator, arrival_time: float) -> GeneratedJob:
        job = make_job(self.template, arrival_time)
        chosen, edges = self._sample_plan(rng)
        job.dynamic_realization["calls"] = (chosen, edges)
        noise = lambda s: float(rng.lognormal(0.0, s))
        durs: Dict[str, float] = {}
        durs["plan"] = self._set_llm_stage(job, "plan", int(60 * noise(0.3)))
        dyn_durs: Dict[str, float] = {}
        total = 0.0
        for c in chosen:
            d = 0.8 * noise(0.5)
            dyn_durs[c] = d
            durs[f"calls.{c}"] = d
            total += d
        job._dyn_durs = {"calls": dyn_durs}  # type: ignore[attr-defined]
        durs["calls"] = total
        durs["join"] = self._set_llm_stage(job, "join", int(90 * noise(0.4)))
        job.stages["plan"].revealed = True
        job.stages["join"].revealed = True
        job.stages["calls"].tasks = []
        job.stages["calls"].revealed = False
        return GeneratedJob(job, durs)


# ---------------------------------------------------------------------------
# Stage-completion bookkeeping shared by every runtime
# ---------------------------------------------------------------------------
def reveal_after_stage(
    job: Job, stage: Stage, gens: Dict[str, AppGenerator]
) -> None:
    """Apply the observable consequences of ``stage`` finishing.

    Used by the discrete-event simulator, the serving testbed, and the
    scheduling benchmarks so all runtimes emit identical evidence events:
    chain reveals, dynamic-stage expansion, and the ``evidence_version``
    bump that invalidates incremental-scheduler caches for this job.
    """
    stage.revealed = True
    # chain reveals
    for name in job.reveal_rules.get(stage.name, []):
        job.stages[name].revealed = True
    # dynamic expansion: when the parent LLM stage finishes
    gen = gens.get(job.app.name)
    for child in job.app.children(stage.name):
        cst = job.stages.get(child)
        if (
            cst is not None
            and cst.stype is StageType.DYNAMIC
            and not cst.revealed
            and isinstance(gen, PlanningApp)
        ):
            gen.expand_dynamic(job, child)
    job.bump_evidence()


# ---------------------------------------------------------------------------
# Workload mixes (paper §V "Workload generation")
# ---------------------------------------------------------------------------
ALL_GENERATORS: Dict[str, AppGenerator] = {}


def get_generators() -> Dict[str, AppGenerator]:
    global ALL_GENERATORS
    if not ALL_GENERATORS:
        ALL_GENERATORS = {
            g.name: g
            for g in [
                SequenceSorting(), DocMerging(), CodeGeneration(),
                WebSearch(), TaskAutomation(), LLMCompiler(),
            ]
        }
    return ALL_GENERATORS


WORKLOAD_MIXES: Dict[str, Dict[str, float]] = {
    "mixed": {n: 1 / 6 for n in
              ["seq_sort", "doc_merge", "code_gen", "web_search",
               "task_auto", "llm_compiler"]},
    "predefined": {"seq_sort": 0.5, "doc_merge": 0.5},
    "chain": {"code_gen": 0.5, "web_search": 0.5},
    "planning": {"task_auto": 0.5, "llm_compiler": 0.5},
}


def generate_workload(
    mix: str,
    n_jobs: int,
    arrival_rate: float = 0.9,
    seed: int = 0,
) -> List[GeneratedJob]:
    """Poisson arrivals at rate λ, apps drawn from the mix distribution."""
    gens = get_generators()
    probs = WORKLOAD_MIXES[mix]
    rng = np.random.default_rng(seed)
    names = list(probs)
    p = np.array([probs[n] for n in names])
    p /= p.sum()
    t = 0.0
    out: List[GeneratedJob] = []
    for _ in range(n_jobs):
        t += float(rng.exponential(1.0 / arrival_rate))
        g = gens[str(rng.choice(names, p=p))]
        out.append(g.sample(rng, arrival_time=t))
    return out


# ---------------------------------------------------------------------------
# SLO-tiered workloads (deadline scheduling)
# ---------------------------------------------------------------------------
# Default tier mix: mostly latency-sensitive traffic with a batch tail,
# mirroring production serving splits (SLO-aware LLM scheduling papers).
SLO_TIER_PROBS: Dict[str, float] = {
    "interactive": 0.4,
    "batch": 0.4,
    "best_effort": 0.2,
}

# Deadline = arrival + slack_factor × ground-truth duration / tightness.
# Interactive jobs get the least headroom; best-effort deadlines are so
# loose they only miss under heavy queueing.
SLO_SLACK_FACTORS: Dict[str, float] = {
    "interactive": 2.5,
    "batch": 5.0,
    "best_effort": 12.0,
}


def _ground_truth_duration(gj: GeneratedJob) -> float:
    """Total batch-1 work of a generated job (serial execution bound).

    Sums top-level stage durations only (dotted keys are dynamic-stage
    inner durations already counted in the placeholder's total), giving
    a deterministic per-job scale for deadline assignment.
    """
    return sum(v for k, v in gj.durations.items() if "." not in k)


def assign_slos(
    jobs: Sequence[GeneratedJob],
    tier_probs: Optional[Dict[str, float]] = None,
    slack_factors: Optional[Dict[str, float]] = None,
    tightness: float = 1.0,
    seed: int = 0,
) -> List[GeneratedJob]:
    """Attach an :class:`~repro_torch.core.dag.SLO` to each generated job.

    Tiers are drawn i.i.d. from ``tier_probs`` and deadlines are set to
    ``arrival + slack_factor[tier] * work / tightness`` where ``work`` is
    the job's ground-truth serial duration.  ``tightness`` > 1 shrinks
    every deadline proportionally, which is the knob the monotonicity
    property test sweeps.  Mutates ``jobs`` in place and returns them.

    Parameters
    ----------
    jobs : sequence of GeneratedJob
        Output of :func:`generate_workload` (or compatible).
    tier_probs : dict, optional
        ``tier → probability``; defaults to :data:`SLO_TIER_PROBS`.
    slack_factors : dict, optional
        ``tier → slack multiplier``; defaults to
        :data:`SLO_SLACK_FACTORS`.
    tightness : float
        Global deadline-tightening factor (1.0 = defaults).
    seed : int
        RNG seed for the tier draw (independent of workload sampling).
    """
    probs = dict(SLO_TIER_PROBS if tier_probs is None else tier_probs)
    slack = dict(SLO_SLACK_FACTORS if slack_factors is None else slack_factors)
    rng = np.random.default_rng(seed)
    names = list(probs)
    p = np.array([probs[n] for n in names], dtype=float)
    p /= p.sum()
    for gj in jobs:
        tier = str(rng.choice(names, p=p))
        work = _ground_truth_duration(gj)
        deadline = gj.job.arrival_time + slack[tier] * work / max(tightness, 1e-9)
        gj.job.slo = SLO(tier=tier, deadline=deadline)
    return list(jobs)


def generate_tiered_workload(
    mix: str,
    n_jobs: int,
    arrival_rate: float = 0.9,
    seed: int = 0,
    tier_probs: Optional[Dict[str, float]] = None,
    slack_factors: Optional[Dict[str, float]] = None,
    tightness: float = 1.0,
) -> List[GeneratedJob]:
    """Poisson-arrival workload where every job carries a tiered SLO.

    Identical job stream to :func:`generate_workload` with the same
    ``(mix, n_jobs, arrival_rate, seed)`` — SLOs are assigned by a
    *separate* RNG stream (``seed + 1``) so adding deadlines never
    perturbs job structure, which the golden-trajectory degeneracy test
    relies on.
    """
    jobs = generate_workload(mix, n_jobs, arrival_rate=arrival_rate, seed=seed)
    return assign_slos(
        jobs,
        tier_probs=tier_probs,
        slack_factors=slack_factors,
        tightness=tightness,
        seed=seed + 1,
    )


def generate_traces(mix: str, n_jobs: int, seed: int = 1234) -> List[JobTrace]:
    """Offline history for BN training (paper: recorded runtime durations)."""
    gens = get_generators()
    out: List[JobTrace] = []
    for gj in generate_workload(mix, n_jobs, arrival_rate=1.0, seed=seed):
        g = gens[gj.job.app.name]
        out.append(g.trace_of(gj))
    return out


# ---------------------------------------------------------------------------
# Heterogeneous replica-pool presets (cascade benchmark currency)
# ---------------------------------------------------------------------------
#: Named per-replica model-tier pools shared by the fig10 cascade
#: benchmark and the sim tests, so "the 3-replica cheap/mid/top fleet"
#: means the same thing everywhere.  Keys of each entry are model-zoo
#: names accepted by :func:`repro_torch.models.zoo.resolve_tier`.
TIER_POOLS: Dict[str, Tuple[str, ...]] = {
    # one replica per rung of a cheap → capable ladder
    "ladder3": ("stablelm_1_6b", "internlm2_20b", "kimi_k2_1t_a32b"),
    # single-tier control pools of the ladder's extremes
    "cheap3": ("stablelm_1_6b",) * 3,
    "large3": ("kimi_k2_1t_a32b",) * 3,
}


def tier_pool(name: str, n_llm: Optional[int] = None) -> Tuple[str, ...]:
    """Return a named replica pool, optionally resized.

    Parameters
    ----------
    name : str
        A :data:`TIER_POOLS` key.
    n_llm : int, optional
        Desired replica count; the pool is cycled to length (so
        ``ladder3`` at 6 replicas repeats the ladder twice).  ``None``
        keeps the preset size.

    Returns
    -------
    tuple of str
        Per-replica model names for ``ClusterSim(model_tiers=...)`` or
        ``ServeConfig(models=...)``.
    """
    pool = TIER_POOLS[name]
    if n_llm is None:
        return pool
    return tuple(pool[i % len(pool)] for i in range(int(n_llm)))
