"""Continuous-batching LLM engine: one "LLM executor" of the paper.

Port of ``repro/serving/engine.py``: the :class:`Request` record, the
:class:`LatencyProfileMixin` that turns measured per-step latencies into
the per-token latency profile l(b) the LLMSched scheduler reads through
Eq. 2, and the slot engine :class:`LLMEngine`:

- up to ``max_batch`` concurrent requests (slots), each with a dense
  ``max_len`` KV cache;
- each step decodes one token for every slot (iteration-level scheduling
  à la Orca — new requests join between steps via prefill);
- per-token latency is measured per batch size, feeding the
  batching-aware calibration profile (Eq. 2) back to the scheduler.

The host logic is the JAX engine's, line for line.  The model runs
eagerly on ``device`` (the CUDA device unless the caller passes
``device="cpu"``): prefill through the flash-attention kernel, decode
through the slot decode-attention kernel, Mamba layers (the hybrid
family) through the selective-scan kernel in both, xLSTM cells in plain
PyTorch, and the caches and recurrent states are written in place.  The
VLM and Whisper families are refused: the engines pass no encoder input
(the JAX engine fails on them), so they run through the model functions
with ``enc_input``.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..bridge import params_to, tensor_to_numpy
from ..core.calibration import LatencyProfile, measured_profile
from ..device import DeviceLike, resolve_device
from ..kernels import ops
from ..models import decode_step, init_cache, init_params, prefill
from ..models.config import ModelConfig
from ..models.transformer import ENC_FAMILIES


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    stop_token: Optional[int] = None
    out_tokens: List[int] = field(default_factory=list)
    submitted_at: float = 0.0
    started_at: float = -1.0
    finished_at: float = -1.0
    on_finish: Optional[Callable[["Request"], None]] = None
    # prompt tokens actually run through prefill (cumulative across
    # recompute restarts; prefix-cache hits skip tokens and so reduce it)
    prefill_tokens: int = 0
    # admission urgency: lower drains first from a paged engine's
    # waiting queue (SLO jobs carry their scaled deadline — EDF);
    # inf (default) keeps the historical FIFO order byte-for-byte
    priority: float = math.inf
    # fleet-global first-admission stamp (set by the first engine that
    # places the request; preserved across eviction and migration).
    # Equal-priority waiting requests drain in this order — the deque
    # itself reflects *eviction* order, and a migrated-in request
    # evicted late would otherwise jump ahead of an older waiter.
    arrival_seq: int = -1

    def done(self) -> bool:
        return self.finished_at >= 0


def refuse_encoder_families(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a VLM or Whisper config: the engines take no
    encoder input, which their cross layers need."""
    if cfg.family in ENC_FAMILIES:
        raise ValueError(f"config {cfg.name!r} (family {cfg.family!r}) needs encoder "
                         "input, which the engines do not take; use the model "
                         "functions with enc_input")


class LatencyProfileMixin:
    """Measured l(b) bookkeeping shared by the slot and paged engines.

    ``_lat_samples`` maps batch size -> per-step latencies; the profile is
    refit only when new measurements arrived, so the returned object's
    identity is stable between measurements and schedulers can key
    calibration caches on it.
    """

    _lat_samples: Dict[int, List[float]]
    _profile_memo: Optional[Tuple[Tuple[Tuple[int, int], ...], Optional[LatencyProfile]]]

    def _init_latency(self) -> None:
        self._lat_samples = {}
        self._profile_memo = None

    def record_latency(self, batch: int, dt: float) -> None:
        self._lat_samples.setdefault(batch, []).append(dt)

    def latency_profile(self) -> Optional[LatencyProfile]:
        """Measured l(b): per-token step latency per batch size (Eq. 2).
        The first sample per batch size is dropped (first-call warm-up)."""
        fp = tuple(sorted((b, len(v)) for b, v in self._lat_samples.items()))
        if self._profile_memo is not None and self._profile_memo[0] == fp:
            return self._profile_memo[1]
        samples = {
            b: (v[1:] if len(v) > 1 else v)
            for b, v in self._lat_samples.items()
            if v
        }
        prof = measured_profile(samples) if samples else None
        self._profile_memo = (fp, prof)
        return prof


class LLMEngine(LatencyProfileMixin):
    """One LLM executor with continuous batching over static slots.

    Parameters
    ----------
    cfg : ModelConfig
        A model config of a family with no encoder (not ``vlm`` or
        ``audio``: :func:`refuse_encoder_families`).
    max_batch : int, optional
        Slots: the most requests held at once.
    max_len : int, optional
        Tokens per slot (prompt + generated); a request stops once its
        slot holds ``max_len - 2`` tokens.
    seed : int, optional
        Parameter-init seed (ignored when ``params`` is given).
    params : dict, optional
        Pre-built weights (copied to ``device`` when they lie elsewhere).
    greedy : bool, optional
        Greedy decoding (the only mode the engines use).
    device : str or torch.device, optional
        Where the weights, caches and model run.  ``None`` means the
        CUDA device, and raises when there is none; pass ``"cpu"`` for
        the plain PyTorch path.  On a CUDA device the kernels are built
        (at first use) and loaded here, never inside :meth:`step`.

    Attributes
    ----------
    admissions, decode_steps : int
        Prefills and batched decode steps run so far; each runs every
        layer's kernels once (the launch accounting of
        ``chip_smoke.py`` rests on them).
    """

    preemptions = 0  # slot engines never evict (interface parity)

    def __init__(
        self,
        cfg: ModelConfig,
        max_batch: int = 8,
        max_len: int = 256,
        seed: int = 0,
        params: Optional[Any] = None,
        greedy: bool = True,
        device: DeviceLike = None,
    ) -> None:
        refuse_encoder_families(cfg)
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.greedy = greedy
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            ops.load_kernels()  # the one-time build stays out of step()
        self.params = (
            params_to(params, self.device) if params is not None
            else init_params(cfg, seed, self.device)
        )
        # slot state
        self.cache = init_cache(cfg, max_batch, max_len, device=self.device)
        self.active: Dict[int, Request] = {}      # slot -> request
        self.free_slots = list(range(max_batch))
        self._tokens = np.zeros((max_batch,), np.int32)
        # host copy of cache["lengths"], so step() reads no device scalar
        self._lengths = np.zeros((max_batch,), np.int64)
        self.admissions = 0
        self.decode_steps = 0
        self._init_latency()

    # -- admission ----------------------------------------------------------
    def can_admit(self) -> bool:
        return len(self.free_slots) > 0

    @property
    def batch_size(self) -> int:
        return len(self.active)

    def admit(self, req: Request) -> bool:
        """Prefill the request into a free slot."""
        if not self.free_slots:
            return False
        slot = self.free_slots.pop(0)
        toks = torch.tensor([req.prompt], dtype=torch.int32, device=self.device)
        req.prefill_tokens += len(req.prompt)
        last_logits, req_cache = prefill(self.params, self.cfg, toks,
                                         max_len=self.max_len)
        self._merge_slot(slot, req_cache, len(req.prompt))
        self.admissions += 1
        first = self._pick(last_logits[0])
        req.out_tokens.append(int(first))
        req.started_at = time.perf_counter()
        self._tokens[slot] = int(first)
        self.active[slot] = req
        return True

    def _pick(self, logits: torch.Tensor) -> int:
        return int(np.argmax(tensor_to_numpy(logits)))

    def _merge_slot(self, slot: int, req_cache: Dict[str, Any], plen: int) -> None:
        """Copy a single-request prefill cache into the engine's slot.

        A leaf under ``blocks`` is ``(n_sb, B, ...)`` (the slot is axis
        1), a ``prefix_{i}`` leaf ``(B, ...)`` (axis 0), as the JAX
        engine's ``merge_by_path`` reads them.  The whole slot row is
        replaced: the K/V past the prompt become zeros and a Mamba
        layer's state becomes the prompt's, whatever the slot's previous
        request (or the decode steps run over the free slot) left there.
        """
        def merge(dst: Dict[str, Any], src: Dict[str, Any], axis: int) -> None:
            for name, s in src.items():
                if isinstance(s, dict):
                    merge(dst[name], s, axis)
                else:
                    dst[name].select(axis, slot).copy_(s.select(axis, 0))

        for key, sub in req_cache.items():
            if key != "lengths":
                merge(self.cache[key], sub, 1 if key == "blocks" else 0)
        self.cache["lengths"][slot] = plen
        self._lengths[slot] = plen

    # -- decode loop ----------------------------------------------------------
    def step(self) -> List[Request]:
        """One decode step for all active slots; returns finished requests."""
        if not self.active:
            return []
        b = self.batch_size
        t0 = time.perf_counter()
        logits, self.cache = decode_step(
            self.params, self.cfg, self.cache,
            torch.from_numpy(self._tokens.copy()).to(self.device),
        )
        # the clock is read once the logits are on the host (the copy
        # waits for the device), so l(b) covers the step's work
        logits = tensor_to_numpy(logits)
        self.record_latency(b, time.perf_counter() - t0)
        self._lengths += 1
        self.decode_steps += 1

        finished = []
        for slot, req in list(self.active.items()):
            nxt = int(np.argmax(logits[slot]))
            req.out_tokens.append(nxt)
            self._tokens[slot] = nxt
            limit = (
                len(req.out_tokens) >= req.max_new_tokens
                or (req.stop_token is not None and nxt == req.stop_token)
                or int(self._lengths[slot]) >= self.max_len - 2
            )
            if limit:
                req.finished_at = time.perf_counter()
                finished.append(req)
                del self.active[slot]
                self.free_slots.append(slot)
                if req.on_finish:
                    req.on_finish(req)
        return finished
