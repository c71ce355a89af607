"""The yardstick's counts: the H100's peaks, the model FLOPs a token
needs, and each attention call's FLOPs and bytes, counted once.

Peaks are NVIDIA's data-sheet figures for one H100 SXM (dense, no
sparsity, at its 700 W limit), the same the port's dry run uses
(``repro_torch.launch.dryrun``'s ``PEAK_FLOPS`` / ``HBM_BW``, and
``chip_smoke.py``'s ``card_rates`` / ``bound``); frozen here so that no
change to the program moves them.

Model FLOPs follow ``launch/roofline_model.py``'s rule, from the
configuration file alone (its reference module counts the matrices):
2 FLOPs per active matrix parameter a token (the LM head included, the
embedding lookup not), plus attention at each token's context,
``2 (d_qk + d_v)`` per head per attended position per layer (the causal
triangle counts each position once).  Whatever implements the model, the
count is the same.

An attention call's bound time is the larger of its FLOPs over the bf16
peak and its bytes over HBM's rate; bytes count each input element read
once and each output element written once (queries, the keys and values
of each attended position, the output; block tables at 4 bytes a page),
FLOPs the products the call needs (``QK^T`` and ``PV``, causal where the
call is).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

PEAK_BF16_FLOPS = 989e12        # FLOP/s, bf16 dense, one H100 SXM
HBM_BYTES_PER_S = 3.35e12       # B/s, one H100 SXM 80 GB HBM3


def model_flops(cfg: Dict[str, Any]) -> Dict[str, float]:
    """FLOPs a token needs: ``per_token`` plus ``per_ctx`` times the number
    of positions it attends to (itself included); the parameter count and
    the attention's widths come from the configuration's reference module."""
    from bench.reference import module

    ref = module(cfg["reference"])
    L, H, dqk, dv = ref.attention_dims(cfg)
    return {"per_token": 2.0 * ref.matrix_params(cfg),
            "per_ctx": 2.0 * L * H * (dqk + dv)}


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations or bytes."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def attention_call(name: str, info: Dict[str, Any]) -> Tuple[float, float]:
    """(FLOPs, bytes) of one attention call from its recorded shapes.

    ``attention``: q ``(B, Sq, H, dk)``, k ``(B, Sk, K, dk)``, v
    ``(B, Sk, K, dv)``, ``causal`` (with Sq == Sk: the triangle).
    ``paged_prefill_attention``: q ``(C, H, dk)``, pools ``(P, ps, K, d)``,
    ``past`` positions before the chunk.  ``paged_decode_attention``: q
    ``(B, H, dk)``, pools ``(P, ps, K, d)``, ``lengths`` (tokens attended,
    the new one included) of each row.
    """
    it = info["itemsize"]
    if name == "attention":
        B, Sq, H, dk = info["q"]
        _, Sk, K, _ = info["k"]
        dv = info["v"][-1]
        if info.get("causal", True) and Sq == Sk:
            pairs = B * Sq * (Sq + 1) // 2
        else:
            pairs = B * Sq * Sk
        flops = 2.0 * H * (dk + dv) * pairs
        nbytes = it * (B * Sq * H * dk + B * Sk * K * (dk + dv) + B * Sq * H * dv)
        return flops, nbytes
    if name == "paged_prefill_attention":
        C, H, dk = info["q"]
        _, ps, K, _ = info["k"]
        dv = info["v"][-1]
        past = info["past"]
        n = past + C
        pairs = C * past + C * (C + 1) // 2
        flops = 2.0 * H * (dk + dv) * pairs
        nbytes = it * (C * H * dk + n * K * (dk + dv) + C * H * dv) + 4 * -(-n // ps)
        return flops, nbytes
    if name == "paged_decode_attention":
        B, H, dk = info["q"]
        _, ps, K, _ = info["k"]
        dv = info["v"][-1]
        lens: List[int] = info["lengths"]
        rows = [n for n in lens if n > 0]
        flops = 2.0 * H * (dk + dv) * sum(rows)
        nbytes = (it * (len(rows) * H * (dk + dv) + sum(rows) * K * (dk + dv))
                  + 4 * sum(-(-n // ps) for n in rows) + 4 * len(rows))
        return flops, nbytes
    raise ValueError(f"no count for attention call {name!r}")


#: the port's attention kernels, by the names the profiler gives them
ATTENTION_KERNELS = ("attention_tc_kernel", "flash_attention_kernel", "paged_prefill_kernel",
                     "paged_decode_kernel", "decode_split_kernel", "decode_split_tc_kernel",
                     "decode_attention_kernel")


def is_attention_kernel(name: str) -> bool:
    return any(k in name for k in ATTENTION_KERNELS)
