#!/usr/bin/env python3
"""Time build variants of the flash kernels' tensor-core bodies at MLA's
head dims (hd 192 / hd_v 128) on one CUDA card.

Each variant is the package's ``csrc`` with one constant changed: the
forward's ring depth at 192 / 128 (``kWideStages`` in
``attention_tc.cuh``: 2 or 3 stages of 40 KB), the backward dK/dV pass's
folded rows a step (``kWideRows`` in ``flash_attention_bwd.cu``: 32 or 16)
and the dQ pass's keys a step (``kWideDqKeys``: 32 or 64).  Each is
compiled by its own ``nvcc`` (the package's flags) into a library of its
own under ``kernels/build/variants/``, loaded with ctypes, held against
the package's own build on the same inputs (bit-equal for the package's
value, within the bf16 tolerance for the other), and timed:
``graph_ms``, a CUDA graph of 20 back-to-back calls replayed between two
events (no host time between the calls), median of 5 replays over 20, and
``ms``, CUDA events around eager calls (``chip_smoke.time_ms``), with
``ptxas``'s registers and spills of the variant's 192 / 128 kernels and the
CTAs a SM that registers and shared memory allow them.
Shapes: DeepSeek-V2-Lite's prefill (B = 1, Sq = Sk = 512, H = K = 16,
causal) and its training shape (B = 4, S = 1024, H = K = 16, causal).
The variants run in turns (package value, other, other, package value).
Prints one JSON line; needs a card and ``nvcc``::

    python3 tools/flash_mla_variants.py
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

#: (source to compile, file edited, the line as the package has it, the
#: line's template with {} for the value, the package's value, the other)
VARIANTS = {
    "forward stages": ("flash_attention.cu", "attention_tc.cuh",
                       "constexpr int kWideStages = {};", 2, 3),
    "backward rows": ("flash_attention_bwd.cu", "flash_attention_bwd.cu",
                      "constexpr int kWideRows = {};", 32, 16),
    "backward dq keys": ("flash_attention_bwd.cu", "flash_attention_bwd.cu",
                         "constexpr int kWideDqKeys = {};", 32, 64),
}
#: (label, B, S, H) of the timed calls, causal, H = K
SHAPES = (("prefill", 1, 512, 16), ("train", 4, 1024, 16))


def _build_variant(src: str, edited: str, line: str, value: int, out_dir: Path) -> dict:
    """Compile ``src`` with ``line`` set to ``value`` into a library; its
    path and ``ptxas``'s registers and spills of the 192 / 128 kernels."""
    from repro_torch.kernels import _build

    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        csrc = Path(tmp) / "csrc"
        shutil.copytree(_build.CSRC, csrc)
        path = csrc / edited
        text = path.read_text()
        old = line.format(_package_value(line))
        if text.count(old) != 1:
            raise RuntimeError(f"{edited}: '{old}' not found once")
        path.write_text(text.replace(old, line.format(value)))
        lib = out_dir / f"{Path(src).stem}_{value}.so"
        cmd = [_build.nvcc_path(), *_build.ARCH_FLAGS, *_build.CFLAGS, "-I", str(csrc),
               "-shared", "-o", str(lib), str(csrc / src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(proc.stdout + proc.stderr)
    ptxas, key = {}, None
    for ln in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            m = re.search(r"(attention_tc|dkdv_tc|dq_tc)_kernelILi192ELi128E", name)
            key = m.group(1) if m else None
        elif key and "spill stores" in ln:
            words = ln.replace(",", "").split()
            ptxas.setdefault(key, {})["spill_bytes"] = int(words[words.index("spill") - 2])
        elif key and "Used" in ln and "registers" in ln:
            words = ln.split()
            ptxas.setdefault(key, {})["registers"] = int(words[words.index("registers,") - 1])
    return {"path": str(lib), "ptxas": ptxas}


def _package_value(line: str) -> int:
    return next(v[3] for v in VARIANTS.values() if v[2] == line)


def _entry(lib_path: str, name: str):
    from repro_torch.kernels import _build

    fn = getattr(ctypes.CDLL(lib_path), name)
    fn.argtypes = _build.SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def _forward(fn, q, k, v, out):
    from repro_torch.kernels import _build

    B, S, H, hd = q.shape
    K, hd_v = k.shape[2], v.shape[3]
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, B, S, S, H, K,
              hd, hd_v, 1, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], hd ** -0.5,
              _build.current_stream(q.device))
    _build.check(code, "flash_attention_tc_bf16 variant")
    return out


def _backward(fn, q, k, v, o, lse, do, grads, delta):
    from repro_torch.kernels import _build

    B, S, H, hd = q.shape
    K, hd_v = k.shape[2], v.shape[3]
    dq, dk, dv = grads
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
              B, S, S, H, K, hd, hd_v, 1, *q.stride(), *k.stride(), *v.stride(), *o.stride(),
              *do.stride(), hd ** -0.5, _build.current_stream(q.device))
    _build.check(code, "flash_attention_bwd_tc_bf16 variant")
    return grads


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device ms of one call of ``fn``: ``calls`` calls captured in one CUDA
    graph, the graph replayed ``reps`` times between two events; the
    median replay over ``calls``."""
    import statistics

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    spans = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) / calls for s, e in spans)


def _ctas_per_sm(regs: int, smem: int) -> int:
    """CTAs of 128 threads a SM holds at ``regs`` registers a thread and
    ``smem`` bytes of shared memory (H100: 64K registers, allocated 256 a
    warp, 227 KB of shared memory a CTA and 228 KB a SM, 1 KB a CTA kept)."""
    by_regs = 65536 // (4 * (-(-regs * 32 // 256) * 256))
    by_smem = (228 * 1024) // (smem + 1024)
    return min(by_regs, by_smem, 16)


def main() -> int:
    import chip_smoke as C
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd

    if not torch.cuda.is_available():
        print("flash_mla_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    _build.library()
    g = torch.Generator(device=dev).manual_seed(71)
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": C.smi_line()}
    for what, (src, edited, line, mine, other) in VARIANTS.items():
        libs = {v: _build_variant(src, edited, line, v, out_dir) for v in (mine, other)}
        rows = {}
        for label, B, S, H in SHAPES:
            hd, hd_v = 192, 128
            q, k = (torch.randn(B, S, H, hd, generator=g, device=dev).bfloat16() for _ in "qk")
            v, do = (torch.randn(B, S, H, hd_v, generator=g, device=dev).bfloat16()
                     for _ in "vd")
            if what.startswith("forward"):
                want = flash_attention(q, k, v, causal=True)
                bufs = {x: torch.empty_like(want) for x in libs}
                fns = {x: _entry(libs[x]["path"], "flash_attention_tc_bf16") for x in libs}
                run = {x: (lambda x=x: _forward(fns[x], q, k, v, bufs[x])) for x in libs}
                got = {x: [run[x]()] for x in libs}
                want = [want]
            else:
                o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
                want = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
                bufs = {x: (tuple(torch.empty_like(t) for t in (q, k, v)),
                            torch.empty_like(lse)) for x in libs}
                fns = {x: _entry(libs[x]["path"], "flash_attention_bwd_tc_bf16") for x in libs}
                run = {x: (lambda x=x: _backward(fns[x], q, k, v, o, lse, do, *bufs[x]))
                       for x in libs}
                got = {x: list(run[x]()) for x in libs}
            torch.cuda.synchronize()
            C.check(all(torch.equal(a, b) for a, b in zip(got[mine], want)),
                    f"{what} {label}: the package's value is not the package's build")
            err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got[other], want))
            scale = max(float(b.float().abs().max()) for b in want)
            C.check(err <= C.BWD_TOL[torch.bfloat16] * max(1.0, scale),
                    f"{what} {label}: the other value is off by {err}")
            times = {x: [] for x in libs}
            for x in (mine, other, other, mine):
                times[x].append({"graph_ms": graph_ms(run[x]), "ms": C.time_ms(run[x])})
            rows[label] = {"shape": f"B={B} S={S} H=K={H} causal", "max_abs_err_other": err,
                           **{f"{line.format(x)}": t for x, t in times.items()}}
            del q, k, v, do, got, bufs
        result[what] = {"package": mine, "other": other, "timed": rows,
                        "ptxas": {line.format(x): libs[x]["ptxas"] for x in libs}}
    # shared memory a CTA: the forward's ring of 40 KB stages; the dK/dV
    # pass's resident K and V (40 KB) and two stages of Q, dout, LSE and D
    smem = {("forward stages", "attention_tc", x): x * 40960 for x in (2, 3)}
    smem.update({("backward rows", "dkdv_tc", x): 40960 + 2 * x * (2 * 320 + 8)
                 for x in (16, 32)})
    smem.update({("backward dq keys", "dq_tc", x): 40960 + 2 * x * 2 * 320 for x in (32, 64)})
    for (what, kernel, x), nbytes in smem.items():
        regs = result[what]["ptxas"][VARIANTS[what][2].format(x)][kernel]["registers"]
        result[what].setdefault("ctas_per_sm", {})[x] = {
            "shared_bytes": nbytes, "registers": regs, "ctas": _ctas_per_sm(regs, nbytes)}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
