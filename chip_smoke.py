#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paged serving path on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit (``nvcc``)::

    python3 chip_smoke.py

It builds the port's hand-written kernels from ``src/repro_torch/kernels/
csrc`` (``nvcc``, ``sm_90a``), then prints one JSON line per phase:

1. ``env``     — the card (``nvidia-smi`` name and power limit), torch,
   CUDA, nvcc and triton versions, and the kernels' build time;
2. ``kernels`` — each kernel against its plain PyTorch version on the
   card, in bf16 and f32, at the main path's shapes (stablelm-1.6b:
   H = K = 32, hd = 64, page 16) and at internlm2-20b's GQA widths
   (H = 48, K = 8, hd = 128), with unreferenced pages and the tails past
   each length poisoned with finite values; the attention kernels also
   with those regions set to NaN, which must not change their output.
   Times (CUDA events, median) of the kernel, its plain version and one
   PyTorch library call for the same function (a yardstick the port
   never calls), beside the least time the card could take;
3. ``held``    — stablelm-1.6b at full width cut to 2 layers, float32:
   the same weights and requests through the engine on the card and on
   the CPU must give the same greedy tokens;
4. ``engine``  — the full stablelm-1.6b in bf16 through
   ``PagedLLMEngine.admit``/``step``: 8 requests of 96-768 prompt
   tokens and 32 new tokens each, once with the default pool and once
   with the prefix cache on a pool small enough to force eviction,
   re-admission and copy-on-write; every kernel launch is counted and
   must match the steps run exactly.

Then a ``kernels`` summary line, the ``nvidia-smi`` name/power-limit line,
and a last line ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the script exits non-zero and prints no last line; it also
fails when no CUDA device is present or the port is not beside it.
``--phases`` runs a subset (``env`` always runs).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet (dense, no sparsity): HBM rate and peak rates
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}
PHASES = ("kernels", "held", "engine")
KERNEL_META = {
    "paged_decode_attention": ("src/repro_torch/kernels/csrc/paged_decode.cu",
                               "src/repro/kernels/paged_attention.py:119"),
    "paged_prefill_attention": ("src/repro_torch/kernels/csrc/paged_prefill.cu",
                                "src/repro/kernels/paged_attention.py:257"),
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:27"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, groups: int = 15, per_group: int = 10) -> float:
    """Median over groups of the mean time of one call (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_group):
            fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) / per_group for s, e in spans)


def bound(nbytes: float, flops: float, dtype: torch.dtype):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase: env
# ---------------------------------------------------------------------------
def phase_env(build_mod) -> dict:
    nvcc = subprocess.run([build_mod.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    release = next((ln.strip() for ln in nvcc.splitlines() if "release" in ln), nvcc)
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    t0 = time.perf_counter()
    info = build_mod.build()
    build_mod.library()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "Compiling entry" in ln or "error" in ln]
    env = {
        "nvidia_smi": smi_line(),
        "device": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": release,
        "triton": triton_version,
        "build_s": time.perf_counter() - t0,
        "built_now": info["built"],
        "ptxas": ptxas,
    }
    emit("env", **env)
    return env


# ---------------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------------
def _on(dev, dtype, *arrays):
    return [torch.from_numpy(a).to(dev, dtype) for a in arrays]


def _poisoned(kp, vp, garbage, value):
    """Copies of the pools with every garbage slot set to +-value."""
    k, v = kp.clone(), vp.clone()
    k[garbage], v[garbage] = value, -value
    return k, v


def _decode_case(rng, B, H, K, hd, ps, npp, lens, dtype, dev):
    """q, clean pools, tables, lengths and the (P, ps) mask of garbage
    slots: pages no row references and the tail past each length."""
    P = B * npp + 3
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    kp = rng.normal(size=(P, ps, K, hd)).astype(np.float32)
    vp = rng.normal(size=(P, ps, K, hd)).astype(np.float32)
    bt = rng.permutation(np.arange(1, P))[: B * npp].reshape(B, npp).astype(np.int32)
    garbage = np.ones((P, ps), bool)
    for b in range(B):
        for t in range(int(lens[b])):
            garbage[bt[b, t // ps], t % ps] = False
    q, kp, vp = _on(dev, dtype, q, kp, vp)
    lens_t = torch.from_numpy(np.asarray(lens, np.int32)).to(dev)
    return (q, kp, vp, torch.from_numpy(bt).to(dev), lens_t,
            torch.from_numpy(garbage).to(dev))


def _prefill_case(rng, C, H, K, hd, ps, past, dtype, dev):
    """q, clean pools, table and the garbage mask (every slot at or past
    ctx = past + C, and every page outside the context's table entries)."""
    ctx = past + C
    npp = -(-ctx // ps) + 2
    P = npp + 6
    q = rng.normal(size=(C, H, hd)).astype(np.float32)
    kp = rng.normal(size=(P, ps, K, hd)).astype(np.float32)
    vp = rng.normal(size=(P, ps, K, hd)).astype(np.float32)
    bt = rng.permutation(np.arange(1, P))[:npp].astype(np.int32)
    garbage = np.ones((P, ps), bool)
    for t in range(ctx):
        garbage[bt[t // ps], t % ps] = False
    q, kp, vp = _on(dev, dtype, q, kp, vp)
    return q, kp, vp, torch.from_numpy(bt).to(dev), torch.from_numpy(garbage).to(dev)


def _err(got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    check(bool(torch.isfinite(got).all()), "kernel output is not finite")
    g, w = got.float(), want.float()
    excess = (g - w).abs() - (TOL[dtype] + TOL[dtype] * w.abs())
    check(float(excess.max()) <= 0, f"kernel outside tolerance {TOL[dtype]}: "
          f"max |err| {float((g - w).abs().max())}")
    return float((g - w).abs().max())


def phase_kernels(dev) -> dict:
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention, paged_prefill_attention,
    )
    from repro_torch.kernels.rmsnorm import rmsnorm

    rng = np.random.default_rng(0)
    widths = {"stablelm-1.6b": (32, 32, 64), "internlm2-20b GQA": (48, 8, 128)}
    errs = {k: 0.0 for k in KERNEL_META}
    cases = []
    ps, npp = 16, 64
    for label, (H, K, hd) in widths.items():
        for dtype in (torch.bfloat16, torch.float32):
            for B in (1, 8):
                lens = np.concatenate([[1024, 1, ps, ps + 1],
                                       rng.integers(1, 1025, size=4)])[:B]
                q, kp, vp, bt, ln, garbage = _decode_case(
                    rng, B, H, K, hd, ps, npp, lens, dtype, dev)
                # finite garbage (as tests/test_paged_kernels.py) vs the plain version
                k99, v99 = _poisoned(kp, vp, garbage, 99.0)
                got = paged_decode_attention(q, k99, v99, bt, ln)
                want = R.paged_decode_attention_ref(q, k99, v99, bt, ln)
                errs["paged_decode_attention"] = max(
                    errs["paged_decode_attention"], _err(got, want, dtype))
                # NaN garbage: the kernel's output equals its output on clean pages
                knan, vnan = _poisoned(kp, vp, garbage, float("nan"))
                check(torch.equal(paged_decode_attention(q, kp, vp, bt, ln),
                                  paged_decode_attention(q, knan, vnan, bt, ln)),
                      f"decode output changed under NaN garbage ({label}, {dtype})")
                cases.append(("decode", label, str(dtype), B))
            for past in (0, 64, 448, 960):
                C = 64
                q, kp, vp, bt, garbage = _prefill_case(
                    rng, C, H, K, hd, ps, past, dtype, dev)
                k77, v77 = _poisoned(kp, vp, garbage, 77.0)
                got = paged_prefill_attention(q, k77, v77, bt, past)
                want = R.paged_prefill_attention_ref(q, k77, v77, bt, past)
                errs["paged_prefill_attention"] = max(
                    errs["paged_prefill_attention"], _err(got, want, dtype))
                knan, vnan = _poisoned(kp, vp, garbage, float("nan"))
                check(torch.equal(paged_prefill_attention(q, kp, vp, bt, past),
                                  paged_prefill_attention(q, knan, vnan, bt, past)),
                      f"prefill output changed under NaN garbage ({label}, {dtype})")
                cases.append(("prefill", label, str(dtype), past))
    for dtype in (torch.bfloat16, torch.float32):
        for rows in (1, 8, 64):
            x = torch.from_numpy(rng.normal(size=(rows, 2048)).astype(np.float32) * 3)
            g = torch.from_numpy(rng.normal(size=(2048,)).astype(np.float32))
            x, g = x.to(dev, dtype), g.to(dev, dtype)
            errs["rmsnorm"] = max(errs["rmsnorm"],
                                  _err(rmsnorm(x, g), R.rmsnorm_ref(x, g), dtype))
    torch.cuda.synchronize()

    # times at the main path's shapes, bf16: decode B = 8 over 96..800
    # tokens, a prefill chunk C = 64 at past = 448, RMSNorm of a chunk
    import torch.nn.functional as F

    dt = torch.bfloat16
    es = 2
    H, K, hd = widths["stablelm-1.6b"]
    timing = {}
    lens = rng.integers(96, 801, size=8)
    q, kp, vp, bt, ln, _ = _decode_case(rng, 8, H, K, hd, ps, npp, lens, dt, dev)
    kd, vd = R.gather_pages(kp, bt), R.gather_pages(vp, bt)       # (B, S, K, hd)
    mask = (torch.arange(npp * ps, device=dev)[None, :] < ln[:, None].long())
    q4 = q[:, :, None]
    k4, v4 = kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
    tokens = int(lens.sum())
    nb, fl = bound(
        2 * 8 * H * hd * es + 2 * tokens * K * hd * es
        + 4 * int(sum(-(-int(n) // ps) for n in lens)) + 4 * 8,
        4 * H * hd * tokens, dt)
    timing["paged_decode_attention"] = dict(
        ms=time_ms(lambda: paged_decode_attention(q, kp, vp, bt, ln)),
        plain_ms=time_ms(lambda: R.paged_decode_attention_ref(q, kp, vp, bt, ln)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask[:, None, None, :])),
        bound_ms=nb, bound_by=fl, shape=f"B=8 H=K={H} hd={hd} ps={ps} "
        f"tokens={tokens}")
    past, C = 448, 64
    q, kp, vp, bt, _ = _prefill_case(rng, C, H, K, hd, ps, past, dt, dev)
    ctx = past + C
    n_ctx = -(-ctx // ps)
    kc = R.gather_pages(kp, bt[None, :n_ctx])[:, :ctx].transpose(1, 2).contiguous()
    vc = R.gather_pages(vp, bt[None, :n_ctx])[:, :ctx].transpose(1, 2).contiguous()
    cmask = (torch.arange(ctx, device=dev)[None, :]
             <= past + torch.arange(C, device=dev)[:, None])
    qc = q.transpose(0, 1)[None].contiguous()
    pairs = sum(past + c + 1 for c in range(C))
    nb, fl = bound(2 * C * H * hd * es + 2 * ctx * K * hd * es + 4 * n_ctx,
                   4 * H * hd * pairs, dt)
    timing["paged_prefill_attention"] = dict(
        ms=time_ms(lambda: paged_prefill_attention(q, kp, vp, bt, past)),
        plain_ms=time_ms(lambda: R.paged_prefill_attention_ref(q, kp, vp, bt, past)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, attn_mask=cmask)),
        bound_ms=nb, bound_by=fl, shape=f"C={C} past={past} H=K={H} hd={hd} ps={ps}")
    x = torch.randn(64, 2048, device=dev, dtype=dt,
                    generator=torch.Generator(device=dev).manual_seed(3))
    g = torch.ones(2048, device=dev, dtype=dt)
    nb, fl = bound(2 * 64 * 2048 * es + 2048 * es, 4 * 64 * 2048, dt)
    timing["rmsnorm"] = dict(
        ms=time_ms(lambda: rmsnorm(x, g)),
        plain_ms=time_ms(lambda: R.rmsnorm_ref(x, g)),
        library_ms=time_ms(lambda: F.rms_norm(x, (2048,), g, 1e-5)),
        bound_ms=nb, bound_by=fl, shape="rows=64 d=2048")
    out = {"max_abs_err": errs, "tol": {str(k): v for k, v in TOL.items()},
           "cases": len(cases), "nan_invariant": True, "timing_bf16": timing,
           "peaks": "H100 SXM data sheet: 3.35 TB/s HBM, 989 TFLOP/s bf16 dense"}
    emit("kernels", **out)
    return out


# ---------------------------------------------------------------------------
# phase: held (card vs CPU, float32)
# ---------------------------------------------------------------------------
def phase_held(dev, cfg) -> dict:
    from repro_torch.bridge import params_to
    from repro_torch.models import init_params
    from repro_torch.models.paged import init_paged_pools, paged_prefill_chunk
    from repro_torch.serving import PagedLLMEngine, Request

    cpu_params = init_params(cfg, seed=1, device="cpu")
    gpu_params = params_to(cpu_params, dev)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist() for n in (40, 97, 150, 200)]

    # first prefill chunk of the first prompt, straight through the model
    logits = {}
    for name, params, d in (("cuda", gpu_params, dev), ("cpu", cpu_params, "cpu")):
        pools = init_paged_pools(cfg, 8, 16, device=d)
        toks = torch.tensor([prompts[0][:40]], dtype=torch.int32, device=d)
        bt = torch.arange(1, 5, dtype=torch.int32, device=d)
        lg, _ = paged_prefill_chunk(params, cfg, pools, toks, bt, 0)
        logits[name] = lg.float().cpu()
    gap = float((logits["cuda"] - logits["cpu"]).abs().max())

    outs, secs = {}, {}
    for name, params, d in (("cuda", gpu_params, dev), ("cpu", cpu_params, "cpu")):
        eng = PagedLLMEngine(cfg, max_seqs=4, max_len=256, params=params, device=d)
        out = {}
        for i, p in enumerate(prompts):
            check(eng.admit(Request(
                rid=i, prompt=p, max_new_tokens=16,
                on_finish=lambda r, out=out: out.__setitem__(r.rid, list(r.out_tokens)))),
                "held: admission refused")
        t0 = time.perf_counter()
        while eng.batch_size or eng.waiting:
            eng.step()
        secs[name] = time.perf_counter() - t0
        outs[name] = out
    torch.cuda.synchronize()
    equal = outs["cuda"] == outs["cpu"]
    res = {"model": "stablelm-1.6b width, 2 layers, float32, TF32 off",
           "tokens_equal": equal, "n_tokens": sum(len(v) for v in outs["cuda"].values()),
           "max_logit_gap_first_chunk": gap, "seconds": secs}
    emit("held", **res)
    check(equal and len(outs["cuda"]) == 4, "card and CPU engines disagree")
    return res


# ---------------------------------------------------------------------------
# phase: engine (the main path at full width)
# ---------------------------------------------------------------------------
def _serve(eng, reqs) -> dict:
    """Drive admit/step until every request finished; per-step timing.

    Each step ends in ``torch.cuda.synchronize()``.  ``prefill_tok_s`` is
    the prompt tokens run over the time of the steps that ran a prefill
    chunk (they may also decode); ``decode_tok_s`` the tokens decoded
    over the time of the steps that only decoded."""
    from repro_torch.kernels import ops

    pending = deque(reqs)
    finished = []
    step_ms, pre_tok, pre_s, dec_tok, dec_s = [], 0, 0.0, 0, 0.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t_start = time.perf_counter()
    while pending or eng.batch_size or eng.waiting:
        while pending and eng.can_admit() and eng.admit(pending[0]):
            pending.popleft()
        chunks0, prefill0 = eng.prefill_chunks, sum(r.prefill_tokens for r in reqs)
        steps0 = eng.decode_steps
        t0 = time.perf_counter()
        done = eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        finished.extend(done)
        decoded = len(eng.active) + len(done)   # rows the decode ran on
        step_ms.append(dt * 1e3)
        if eng.prefill_chunks > chunks0:
            pre_tok += sum(r.prefill_tokens for r in reqs) - prefill0
            pre_s += dt
        elif eng.decode_steps > steps0:
            dec_tok += decoded
            dec_s += dt
    wall = time.perf_counter() - t_start
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    prof = eng.latency_profile()
    res = {
        "requests": len(reqs), "finished": len(finished),
        "new_tokens": sum(len(r.out_tokens) for r in finished),
        "prompt_tokens": sum(len(r.prompt) for r in reqs),
        "decode_steps": eng.decode_steps, "prefill_chunks": eng.prefill_chunks,
        "launches": counts, "wall_s": wall,
        "prefill_tok_s": pre_tok / pre_s if pre_s else None,
        "decode_tok_s": dec_tok / dec_s if dec_s else None,
        "p50_step_ms": statistics.median(step_ms),
        "l_b_ms": ({int(b): float(v) * 1e3 for b, v in
                    zip(prof.batch_sizes, prof.latency)} if prof else {}),
        "preemptions": eng.preemptions, "cow_copies": eng.cow_copies,
        "prefix_hits": eng.prefix_index.hits if eng.prefix_index else None,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    check(len(finished) == len(reqs), "not every request finished")
    check(all(len(r.out_tokens) == r.max_new_tokens for r in finished),
          "a request finished with the wrong token count")
    n_steps = eng.decode_steps + eng.prefill_chunks
    layers = eng.cfg.n_layers
    check(counts["paged_decode_attention"] == layers * eng.decode_steps,
          f"decode launches {counts} vs {eng.decode_steps} steps")
    check(counts["paged_prefill_attention"] == layers * eng.prefill_chunks,
          f"prefill launches {counts} vs {eng.prefill_chunks} chunks")
    check(counts["rmsnorm"] == (2 * layers + 1) * n_steps,
          f"rmsnorm launches {counts} vs {n_steps} steps")
    check(all(v > 0 for v in counts.values()), f"a kernel never ran: {counts}")
    eng.allocator.check_no_leaks()
    return res


def phase_engine(dev, cfg) -> dict:
    from repro_torch.models import init_params
    from repro_torch.serving import PagedLLMEngine, Request

    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(4)
    lens = rng.integers(96, 769, size=8)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=n).tolist(),
                    max_new_tokens=32) for i, n in enumerate(lens)]
    eng = PagedLLMEngine(cfg, max_seqs=8, max_len=1024, params=params, device=dev)
    run1 = _serve(eng, reqs)
    run1["pool_pages"] = eng.num_pages
    emit("engine", run="default pool", init_s=init_s, **run1)
    main_counts = run1["launches"]
    del eng

    shared = rng.integers(0, cfg.vocab, size=256).tolist()
    # prompt + 1 ends on a page boundary, so decode growth meets a pool that
    # admissions have filled: this mix evicts (and re-admits) twice
    tails = [479, 687, 415, 223, 303, 255]
    prompts = [shared + rng.integers(0, cfg.vocab, size=n).tolist() for n in tails]
    prompts += [list(shared), list(shared)]       # page-aligned duplicates: CoW
    reqs = [Request(rid=i, prompt=p, max_new_tokens=32) for i, p in enumerate(prompts)]
    pages_per_seq = 1024 // 16
    eng = PagedLLMEngine(cfg, max_seqs=8, max_len=1024, params=params, device=dev,
                         num_pages=1 + 3 * pages_per_seq, prefix_cache=True)
    run2 = _serve(eng, reqs)
    run2["pool_pages"] = eng.num_pages
    emit("engine", run="prefix cache, small pool", **run2)
    check(run2["preemptions"] > 0 and run2["cow_copies"] > 0
          and run2["prefix_hits"] > 0,
          "the small-pool run did not exercise eviction, prefix hits and CoW")
    del eng
    emit("profile", **_profile_decode(
        PagedLLMEngine(cfg, max_seqs=8, max_len=1024, params=params, device=dev),
        [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=512).tolist(),
                 max_new_tokens=64) for i in range(8)]))
    return {"launches": main_counts, "runs": [run1, run2]}


def _profile_decode(eng, reqs, n_steps: int = 8) -> dict:
    """Trace ``n_steps`` steady decode steps at batch 8 with torch.profiler:
    device time by kernel, and the share of the window the device idled."""
    from torch.profiler import ProfilerActivity, profile

    for r in reqs:
        check(eng.admit(r), "profile: admission refused")
    while eng.prefilling:
        eng.step()
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = evt.name if len(evt.name) < 90 else evt.name[:87] + "..."
        tot, n = by_kernel.get(name, (0.0, 0))
        by_kernel[name] = (tot + evt.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(t for t, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:10]
    return {
        "top_host_ops_ms": [{"name": e.key, "self_ms": e.self_cpu_time_total / 1e3,
                             "count": e.count} for e in host],
        "window": f"{n_steps} decode steps, batch 8, 512-token prompts",
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
        "device_events": sum(n for _, n in by_kernel.values()),
        "top_kernels_ms": [{"name": k, "ms": t, "count": n} for k, (t, n) in top],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    check(set(phases) <= set(PHASES), f"unknown phase in {phases}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    phase_env(_build)
    kern = phase_kernels(dev) if "kernels" in phases else None
    from repro_torch.configs import get_config

    if "held" in phases:
        phase_held(dev, get_config("stablelm_1_6b").with_(n_layers=2, dtype="float32"))
    eng = None
    if "engine" in phases:
        eng = phase_engine(dev, get_config("stablelm_1_6b"))
    if kern is not None and eng is not None:
        summary = [
            {"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": eng["launches"][name],
             "max_abs_err": kern["max_abs_err"][name],
             **{k: kern["timing_bf16"][name][k]
                for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
            for name, (src, rep) in KERNEL_META.items()
        ]
        print(json.dumps({"kernels": summary}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
