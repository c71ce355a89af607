"""Frozen serving configuration: one object instead of kwarg sprawl.

Port of ``repro/serving/config.py``: :class:`ServeConfig` is a copy;
:func:`build_engines` builds the port's engines on an explicit device.

Five PRs of feature growth left the serving stack's knobs scattered
across ``ServingCluster.__init__``, ``repro_torch.launch.serve``'s argparse
surface, ``examples/serve_compound.py``, and the fig8 benchmark modes —
each spelling the same options slightly differently.  ``ServeConfig``
is the single, validated, hashable source of truth: engine selection,
replica fleet shape, KV budgets, prefix caching, migration, workload
scaling, seeds, and the SLO knobs introduced with deadline scheduling.

``ServingCluster`` accepts a ``ServeConfig`` only; the transitional
legacy-kwargs shim shipped for one release after the consolidation has
been removed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..configs import get_smoke_config
from ..device import DeviceLike, resolve_device
from ..models import init_params
from .engine import LLMEngine
from .paged_engine import PagedLLMEngine


@dataclass(frozen=True)
class ServeConfig:
    """Validated, immutable configuration for the serving testbed.

    Attributes
    ----------
    engine : str
        ``"slot"`` (dense per-slot KV) or ``"paged"`` (block-table
        pool with capacity-based admission).
    replicas : int
        Number of LLM engine replicas (shared weights unless ``models``
        declares a heterogeneous pool).
    models : tuple of str, optional
        Per-replica model names (``repro_torch.configs`` spellings), one per
        replica — a heterogeneous pool mixing capability/cost tiers.
        ``None`` (default) builds the homogeneous fleet from the model
        config handed to :func:`build_engines`.  Replicas sharing a
        name share weights; live migration only moves requests between
        same-name replicas.
    cascade : bool
        Escalate quality-gate rejections one cost tier up (requires a
        gate on the cluster and a fleet whose model names all price in
        ``repro_torch.models.zoo.MODEL_TIERS``).  Off by default: rejections
        then only mark the job in ``RunMetrics.quality_by_job``.
    max_batch : int
        Per-replica concurrent-request capacity.
    max_len : int
        Engine sequence capacity (prompt + decode) in tokens.
    page_size : int
        KV page size in tokens (paged engines only).
    kv_pages : tuple of int, optional
        Per-replica page-pool sizes (heterogeneous KV budgets);
        ``None`` lets each engine size its own pool.
    kv_dtype : str
        Page-pool storage dtype (paged engines only): ``"fp32"`` keeps
        the historical compute-dtype pages, ``"int8"`` stores quantized
        pages with per-page scale pools (~4x tokens per byte).
    kv_budget_bytes : int, optional
        Per-replica KV budget in *bytes* (paged only); the pool is
        sized to as many whole pages as fit.  Mutually exclusive with
        ``kv_pages`` — this is how fp32 and int8 fleets are compared
        at equal memory.
    migrate : bool
        Live-migrate decoding requests off KV-starved paged replicas.
    prefix_cache : bool
        Shared-prefix KV reuse via the radix index (paged only).
    shared_prompt_tokens : int
        Per-application shared system-prompt tokens synthesized into
        every LLM task's prompt (0 keeps historical 2-token prompts).
    n_regular : int
        Regular executor slots.
    token_scale : float
        Divide task token budgets by this so smoke runs finish quickly.
    time_scale : float
        Compress arrival times and regular durations by this factor.
    min_tokens : int
        Floor for a scaled LLM task's token budget.
    seed : int
        Seed threaded to engines (sampling) and schedulers.
    plan_ahead_s : float
        SLO plan-ahead window W (workload seconds) for deadline-aware
        schedulers; ignored by deadline-blind policies.
    slo_tightness : float
        Deadline-tightening factor for tiered workload generation
        (1.0 = the generator's default slack).
    """

    engine: str = "slot"
    replicas: int = 1
    models: Optional[Tuple[str, ...]] = None
    cascade: bool = False
    max_batch: int = 4
    max_len: int = 96
    page_size: int = 16
    kv_pages: Optional[Tuple[int, ...]] = None
    kv_dtype: str = "fp32"
    kv_budget_bytes: Optional[int] = None
    migrate: bool = False
    prefix_cache: bool = False
    shared_prompt_tokens: int = 0
    n_regular: int = 4
    token_scale: float = 8.0
    time_scale: float = 8.0
    min_tokens: int = 2
    seed: int = 0
    plan_ahead_s: float = 30.0
    slo_tightness: float = 1.0

    def __post_init__(self) -> None:
        """Validate cross-field invariants at construction time."""
        if self.engine not in ("slot", "paged"):
            raise ValueError(f"engine must be 'slot' or 'paged', got {self.engine!r}")
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        if self.models is not None:
            object.__setattr__(self, "models", tuple(str(m) for m in self.models))
            if len(self.models) != self.replicas:
                raise ValueError(
                    f"models needs {self.replicas} entries, got {len(self.models)}"
                )
        if self.kv_pages is not None:
            object.__setattr__(self, "kv_pages", tuple(int(p) for p in self.kv_pages))
            if len(self.kv_pages) != self.replicas:
                raise ValueError(
                    f"kv_pages needs {self.replicas} entries, got {len(self.kv_pages)}"
                )
        if self.kv_dtype not in ("fp32", "int8"):
            raise ValueError(
                f"kv_dtype must be 'fp32' or 'int8', got {self.kv_dtype!r}"
            )
        if self.kv_dtype != "fp32" and self.engine != "paged":
            raise ValueError("kv_dtype='int8' requires engine='paged'")
        if self.kv_budget_bytes is not None:
            if self.engine != "paged":
                raise ValueError("kv_budget_bytes requires engine='paged'")
            if self.kv_pages is not None:
                raise ValueError(
                    "kv_budget_bytes and kv_pages are mutually exclusive; "
                    "pick one way to size the pool"
                )
            if self.kv_budget_bytes <= 0:
                raise ValueError("kv_budget_bytes must be positive")
        # synthesized prompt = shared prefix + 2 suffix tokens, and the
        # engine needs at least one decode slot on top
        if self.shared_prompt_tokens > self.max_len - 3:
            raise ValueError(
                f"shared_prompt_tokens {self.shared_prompt_tokens} too large: "
                f"the synthesized prompt (+2 suffix tokens) must fit "
                f"max_len {self.max_len}"
            )


def build_engines(model_cfg, cfg: ServeConfig, params=None,
                  device: DeviceLike = None) -> List:
    """Build the replica fleet described by ``cfg`` on ``device``.

    Without ``params``, slot engines get per-replica seeds
    (``cfg.seed + i``) and paged engines share one set of weights per
    *model name* (initialised from ``cfg.seed``), which is what makes
    live migration between same-name replicas lossless.  ``params``,
    when given, is shared by every replica, slot or paged (the JAX
    package hands it to paged replicas only).

    With ``cfg.models`` set, the fleet is heterogeneous: replica ``i``
    runs the smoke config of ``cfg.models[i]`` and ``model_cfg`` is
    ignored (pass ``None``).  Same-name replicas still share weights.

    Parameters
    ----------
    model_cfg
        Model configuration (e.g. from ``repro_torch.configs``); ignored
        when ``cfg.models`` is set.
    cfg : ServeConfig
        Fleet shape and engine options.
    params : optional
        Pre-initialised model parameters (homogeneous fleets only).
    device : str or torch.device, optional
        Where every replica runs; ``None`` means the CUDA device (and
        raises without one), ``"cpu"`` the plain PyTorch path.

    Returns
    -------
    list
        ``cfg.replicas`` engine instances.

    Raises
    ------
    ValueError
        When ``migrate``/``prefix_cache`` are requested for slot
        engines (both need the paged KV pool), or when ``params`` is
        supplied for a heterogeneous fleet.
    """
    if cfg.engine != "paged" and cfg.migrate:
        raise ValueError("migrate=True requires engine='paged'")
    if cfg.engine != "paged" and cfg.prefix_cache:
        raise ValueError("prefix_cache=True requires engine='paged'")
    dev = resolve_device(device)
    if cfg.models is not None:
        if params is not None:
            raise ValueError(
                "params cannot be shared across a heterogeneous fleet; "
                "leave it None when cfg.models is set"
            )
        model_cfgs = [get_smoke_config(m) for m in cfg.models]
    else:
        model_cfgs = [model_cfg] * cfg.replicas
    if cfg.engine == "paged":
        # one weight set per distinct model (dict insertion order keeps
        # init deterministic in fleet order)
        params_by_name = {}
        for mc in model_cfgs:
            if mc.name not in params_by_name:
                params_by_name[mc.name] = (
                    params if params is not None
                    else init_params(mc, cfg.seed, dev)
                )

        def pool_pages(mc):
            if cfg.kv_budget_bytes is not None:
                return PagedLLMEngine.pages_for_byte_budget(
                    mc, cfg.page_size, cfg.kv_budget_bytes, cfg.kv_dtype
                )
            return None

        return [
            PagedLLMEngine(
                mc,
                max_seqs=cfg.max_batch,
                max_len=cfg.max_len,
                page_size=cfg.page_size,
                num_pages=cfg.kv_pages[i] if cfg.kv_pages else pool_pages(mc),
                params=params_by_name[mc.name],
                prefix_cache=cfg.prefix_cache,
                kv_dtype=cfg.kv_dtype,
                device=dev,
            )
            for i, mc in enumerate(model_cfgs)
        ]
    return [
        LLMEngine(
            mc,
            max_batch=cfg.max_batch,
            max_len=cfg.max_len,
            seed=cfg.seed + i,
            params=params,
            device=dev,
        )
        for i, mc in enumerate(model_cfgs)
    ]
