"""Build and load the port's CUDA kernels (nvcc + ctypes).

At first use, every ``csrc/*.cu`` is compiled for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) by its own ``nvcc`` process,
all started together, and the objects are linked into one shared
library under ``kernels/build/`` (ignored by git).  The library has a
plain C interface and is loaded with :mod:`ctypes`: no PyTorch headers
are compiled, so a cold build takes seconds.

The library's file name carries a hash of the sources and flags, so an
edited source never loads a stale build; a finished build is moved into
place atomically, so concurrent processes never load a half-written
file.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
#: channels one CTA of the selective scan's forward and backward kernels
#: holds (the backward's dB and dC partials are one row a CTA), and the steps
#: between the forward's checkpoints (its optional ``states`` output, (B,
#: ceil(T / SSM_CKPT_STEPS), D, N) float32), which is also the chunk the
#: backward recomputes.  Both kernels are compiled with these values
#: (``-DREPRO_SSM_CHANNELS``, ``-DREPRO_SSM_CKPT``), and the wrappers size
#: the buffers those kernels write from them: this is their one owner.
SSM_CHANNELS_PER_CTA = 64
SSM_CKPT_STEPS = 32
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
          f"-DREPRO_SSM_CHANNELS={SSM_CHANNELS_PER_CTA}", f"-DREPRO_SSM_CKPT={SSM_CKPT_STEPS}"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
L = ctypes.c_longlong

_STRIDES = [L] * 8
_SCALE_STRIDES = [L] * 6  # (P, ps, K) strides of the k and v scale pools
#: C signature of every entry point (all return an int cudaError_t)
SIGNATURES: Dict[str, List] = {
    "rmsnorm_f32": [P, P, P, I, I, I, F, P],
    "rmsnorm_bf16": [P, P, P, I, I, I, F, P],
    "paged_decode_f32": [P] * 6 + [I] * 7 + _STRIDES + [F, P],
    "paged_decode_bf16": [P] * 6 + [I] * 7 + _STRIDES + [F, P],
    "paged_prefill_f32": [P] * 5 + [I] * 8 + _STRIDES + [F, P],
    "paged_prefill_bf16": [P] * 5 + [I] * 8 + _STRIDES + [F, P],
    "paged_decode_q8_f32": [P] * 8 + [I] * 7 + _STRIDES + _SCALE_STRIDES + [F, P],
    "paged_decode_q8_bf16": [P] * 8 + [I] * 7 + _STRIDES + _SCALE_STRIDES + [F, P],
    "paged_prefill_q8_f32": [P] * 7 + [I] * 8 + _STRIDES + _SCALE_STRIDES + [F, P],
    "paged_prefill_q8_bf16": [P] * 7 + [I] * 8 + _STRIDES + _SCALE_STRIDES + [F, P],
    "decode_attention_f32": [P] * 5 + [I] * 6 + _STRIDES + [F, P],
    "decode_attention_bf16": [P] * 5 + [I] * 6 + _STRIDES + [F, P],
    "flash_attention_f32": [P] * 5 + [I] * 9 + [L] * 12 + [F, P],
    "flash_attention_bf16": [P] * 5 + [I] * 9 + [L] * 12 + [F, P],
    "ssm_scan_f32": [P] * 10 + [I] * 5 + [L] * 12 + [P],
    "ssm_scan_bf16": [P] * 10 + [I] * 5 + [L] * 12 + [P],
    # the tensor-core bodies (csrc/attention_tc.cuh), bf16 only
    "flash_attention_tc_bf16": [P] * 5 + [I] * 8 + [L] * 9 + [F, P],
    "paged_prefill_tc_bf16": [P] * 5 + [I] * 8 + [L] * 6 + [F, P],
    "paged_prefill_q8_tc_bf16": [P] * 7 + [I] * 8 + [L] * 12 + [F, P],
    # the split-context decode bodies (csrc/decode_split.cuh), f32 and bf16
    "decode_attention_split_f32": [P] * 5 + [I] * 7 + [L] * 6 + [F, P],
    "decode_attention_split_bf16": [P] * 5 + [I] * 7 + [L] * 6 + [F, P],
    "paged_decode_split_f32": [P] * 6 + [I] * 9 + [L] * 6 + [F, P],
    "paged_decode_split_bf16": [P] * 6 + [I] * 9 + [L] * 6 + [F, P],
    "paged_decode_q8_split_f32": [P] * 8 + [I] * 9 + [L] * 12 + [F, P],
    "paged_decode_q8_split_bf16": [P] * 8 + [I] * 9 + [L] * 12 + [F, P],
    # the backward kernels (csrc/flash_attention_bwd.cu, csrc/rmsnorm_bwd.cu,
    # csrc/ssm_scan_bwd.cu)
    "flash_attention_bwd_f32": [P] * 10 + [I] * 8 + [L] * 20 + [F, P],
    "flash_attention_bwd_bf16": [P] * 10 + [I] * 8 + [L] * 20 + [F, P],
    "flash_attention_bwd_tc_bf16": [P] * 10 + [I] * 8 + [L] * 20 + [F, P],
    "rmsnorm_bwd_f32": [P] * 6 + [I] * 5 + [F, P],
    "rmsnorm_bwd_bf16": [P] * 6 + [I] * 5 + [F, P],
    "rmsnorm_bwd_ctas_per_sm_f32": [I] * 3 + [P],
    "rmsnorm_bwd_ctas_per_sm_bf16": [I] * 3 + [P],
    "ssm_scan_bwd_f32": [P] * 19 + [I] * 5 + [L] * 12 + [P],
    "ssm_scan_bwd_bf16": [P] * 19 + [I] * 5 + [L] * 12 + [P],
    "ssm_scan_bwd_form_f32": [I, I, P],
    "ssm_scan_bwd_form_bf16": [I, I, P],
}
#: head dims the tensor-core attention body is built for at hd == hd_v (the
#: paged prefill's, and flash's there)
TC_HEAD_DIMS = (16, 64, 128)
#: (hd, hd_v) pairs the flash forward's and backward's tensor-core bodies
#: are built for: hd == hd_v in TC_HEAD_DIMS, and MLA's (192, 128)
#: (DeepSeek-V2-Lite); MLA's smoke (24, 16) is no multiple of 16 and stays
#: on the CUDA-core bodies
TC_HEAD_DIM_PAIRS = tuple((d, d) for d in TC_HEAD_DIMS) + ((192, 128),)
#: folded query rows per CTA and key tokens per tile of that body
TC_ROWS = 64
TC_TILE = 64
#: most context splits of one row block (its CTAs form one cluster, and 8
#: is the largest cluster every Hopper part schedules)
TC_MAX_SPLITS = 8
#: head dims the split-context decode body is built for (hd == hd_v)
SPLIT_HEAD_DIMS = (16, 64, 128)
#: tokens of the whole tiles a decode split's run is made of
SPLIT_TILE = 32
#: most context splits of one decode row (one cluster, as above)
SPLIT_MAX_SPLITS = 8
#: query rows a decode CTA holds beyond a group of 2: 16 (one mma.sync
#: operand) in the tensor-core form that bf16 queries take, 4 on CUDA
#: cores for f32 (:func:`decode_group_rows`; the launcher has a form for
#: 1, 2, these two, and no other size)
SPLIT_TC_ROWS = 16
SPLIT_CUDA_CORE_ROWS = 4
#: SMs a decode launch aims to give each CTA at most: a CTA's 8 warps walk
#: one row's keys side by side, and each split costs a cluster merge (and,
#: where the clusters do not all fit at once, a wave), so splits are added
#: only until every third SM holds a CTA (chip_smoke.py's split sweep)
SPLIT_SMS_PER_CTA = 3


#: 16-byte vectors of a row one thread of the RMSNorm kernel holds, and the
#: warps a row its launcher has a form for (csrc/rmsnorm.cu)
RMSNORM_SLOTS = 8
RMSNORM_WARPS = (1, 2, 4, 8, 16)
#: lanes a channel the selective-scan launcher has a form for, and the
#: states each lane holds (csrc/ssm_scan.cu)
SSM_LANES = (1, 2, 4)
#: (hd, hd_v) pairs the flash backward kernel is built for: hd == hd_v at 16,
#: 64 and 128, MLA's (24, 16) (DeepSeek's smoke config) and (192, 128)
#: (DeepSeek-V2-Lite); bf16 calls with 16-byte rows take its tensor-core body
#: at the pairs of TC_HEAD_DIM_PAIRS, every other call its CUDA-core body
BWD_HEAD_DIM_PAIRS = ((16, 16), (64, 64), (128, 128), (24, 16), (192, 128))
#: widest row the RMSNorm backward kernel takes (the part of a row past its
#: register slots keeps its f32 dgamma partial in a CTA's shared memory),
#: and the 16-byte vectors of a row one of its threads can hold in
#: registers (csrc/rmsnorm_bwd.cu)
RMSNORM_BWD_MAX_D = 28672
RMSNORM_BWD_SLOTS = (1, 2, 4)
#: threads of that kernel's CTA, which holds one row at a time
RMSNORM_BWD_THREADS = 256
SSM_STATES_PER_LANE = 4
SSM_MAX_STATE = 16


def ssm_checkpoints(T: int) -> int:
    """Checkpoints the selective scan's forward writes for ``T`` steps:
    the state before steps 0, ``SSM_CKPT_STEPS``, ... (32 at T = 1024)."""
    return -(-T // SSM_CKPT_STEPS)


@functools.lru_cache(maxsize=None)
def rmsnorm_warps(d: int, dtype: torch.dtype) -> int:
    """Warps that hold one row of ``d`` ``dtype`` values (float32 or
    bfloat16) in the RMSNorm kernel: the fewest of ``RMSNORM_WARPS`` whose
    slots (``RMSNORM_SLOTS`` 16-byte vectors a thread) take the row, at most
    16 (a wider row, past 32768 bf16 or 16384 f32 values, streams its rest;
    32 warps would cap a thread at 64 registers and spill).  One warp at
    stablelm-1.6b's d = 2048 in bf16, 4 at Jamba's 8192 (chip_smoke.py's
    ``rmsnorm_sweep``: twice as many is slower at every timed shape).  The
    launcher takes it and refuses a value it has no form for, so this is the
    one place that picks it.  Cached: it runs on every launch.
    """
    if dtype not in (torch.float32, torch.bfloat16) or d < 1:
        raise ValueError(f"rmsnorm_warps: no form for d={d}, {dtype}")
    per_warp = 32 * RMSNORM_SLOTS * (16 // (4 if dtype == torch.float32 else 2))
    return next((w for w in RMSNORM_WARPS if w * per_warp >= d), RMSNORM_WARPS[-1])


def rmsnorm_bwd_rows(rows: int, sms: int, ctas_per_sm: int) -> int:
    """Rows one CTA of the RMSNorm backward kernel walks: an equal run that
    gives ``ctas_per_sm`` CTAs to each of the ``sms`` (fewer for fewer
    rows), so that the launch runs in one wave.  Each CTA leaves one f32
    dgamma partial row, summed by a second launch (a CTA a 32-column slice,
    16 warps over the partials), so the run also sets the scratch
    (``ceil(rows / run)`` rows of d).  Shapes only: the result is the same
    call after call."""
    ctas = max(1, min(rows, ctas_per_sm * sms))
    return -(-rows // ctas)


@functools.lru_cache(maxsize=None)
def rmsnorm_bwd_ctas_per_sm(dtype: torch.dtype, d: int, slots: int, aligned: bool,
                            index: int) -> int:
    """CTAs of the RMSNorm backward kernel's form (``slots``, ``aligned``)
    at width ``d`` that one SM of CUDA device ``index`` holds at once: the
    CUDA occupancy of the kernel as ``ptxas`` built it (its registers and
    shared memory), asked of the launcher.  Two of the aligned one-slot
    form at 128 registers a thread, one of a form near 170.  Cached: it
    runs on every launch."""
    out = ctypes.c_int(0)
    name = f"rmsnorm_bwd_ctas_per_sm_{'f32' if dtype == torch.float32 else 'bf16'}"
    with torch.cuda.device(index):
        check(entry(name)(d, slots, int(aligned), ctypes.addressof(out)), name)
    return out.value


@functools.lru_cache(maxsize=None)
def rmsnorm_bwd_slots(d: int, dtype: torch.dtype) -> int:
    """16-byte vectors of a row of ``d`` ``dtype`` values (float32 or
    bfloat16) each thread of the RMSNorm backward kernel holds in
    registers: the fewest of ``RMSNORM_BWD_SLOTS`` whose slots take the row
    (one at stablelm-1.6b's d = 2048 in bf16, four at Jamba's 8192), else
    the most (a wider row streams the rest).  The kernel keeps
    ``4 / slots`` rows in flight, so a thread's loads in flight stay four
    vectors of x and four of dy.  The launcher takes it and refuses a value
    it has no form for.  Cached: it runs on every launch."""
    if dtype not in (torch.float32, torch.bfloat16) or d < 1:
        raise ValueError(f"rmsnorm_bwd_slots: no form for d={d}, {dtype}")
    per_slot = RMSNORM_BWD_THREADS * (16 // (4 if dtype == torch.float32 else 2))
    return next((s for s in RMSNORM_BWD_SLOTS if s * per_slot >= d), RMSNORM_BWD_SLOTS[-1])


def ssm_scan_lanes(N: int) -> int:
    """Lanes that hold one channel's ``N`` states in the selective-scan
    kernel: the fewest of ``SSM_LANES`` whose ``SSM_STATES_PER_LANE``
    states each hold ``N`` (4 lanes at Jamba's N = 16).  The launcher takes
    it and refuses a value it has no form for, or whose lanes cannot hold
    N."""
    if not 1 <= N <= SSM_MAX_STATE:
        raise ValueError(f"ssm_scan_lanes: no form for N={N} (1 <= N <= {SSM_MAX_STATE})")
    return next(L for L in SSM_LANES if L * SSM_STATES_PER_LANE >= N)


@functools.lru_cache(maxsize=None)
def ssm_scan_bwd_form(dtype: torch.dtype, N: int, index: int, vector: bool = True
                      ) -> Dict[str, int]:
    """What the form of the selective scan's backward kernel that a call at
    state size ``N`` launches (``ssm_scan_lanes(N)`` lanes a channel; the
    vector form where x, dt, dy, dx and ddt rows are contiguous and on 16
    bytes, as the trainer's are, else the strided form) takes on CUDA device
    ``index``, asked of the launcher: ``ctas_per_sm`` (the CUDA occupancy of
    the kernel as ``ptxas`` built it), ``shared_bytes`` (its dynamic shared
    memory a CTA), ``registers`` a thread and ``spill_bytes`` (local memory a
    thread).  Two CTAs a SM at N = 16.  Cached: the answer is the build's."""
    out = (ctypes.c_int * 4)()
    name = f"ssm_scan_bwd_form_{'f32' if dtype == torch.float32 else 'bf16'}"
    with torch.cuda.device(index):
        check(entry(name)(ssm_scan_lanes(N), int(vector), ctypes.addressof(out)), name)
    return {"ctas_per_sm": out[0], "shared_bytes": out[1], "registers": out[2],
            "spill_bytes": out[3]}


def decode_group_rows(g: int, q_dtype: torch.dtype) -> int:
    """Query rows one CTA of the split-context decode body holds, of a
    group of ``g`` that share a kv head: all of them when ``g <= 2``, else
    ``SPLIT_TC_ROWS`` (bf16 queries, the tensor-core form) or
    ``SPLIT_CUDA_CORE_ROWS`` (f32, CUDA cores); a group then takes
    ``ceil(g / rows)`` CTAs.  The launch takes this size as an argument and
    refuses one it has no form for, so this is the one place that picks it.
    """
    if g <= 2:
        return g
    return SPLIT_TC_ROWS if q_dtype == torch.bfloat16 else SPLIT_CUDA_CORE_ROWS


def decode_splits(B: int, K: int, capacity: int, sms: int, groups: int = 1) -> int:
    """Context splits of a split-body decode call.

    ``B * K * groups`` CTAs (``groups``: the CTAs a query group takes, from
    :func:`decode_group_rows`) hold the rows' kv heads over caches of
    ``capacity`` tokens (the slot cache's S_max, or the block table's
    ``pages_per_seq * page_size``): the fewest power-of-two splits (up to
    ``SPLIT_MAX_SPLITS``, and at most the ``SPLIT_TILE``-token tiles of the
    capacity) that give at least one CTA to every ``SPLIT_SMS_PER_CTA`` SMs
    of the ``sms``.  Only shapes go in, never the lengths, so the choice
    needs no device read; each split then walks an equal run of whole tiles
    of its row's visible tokens, computed on the device.
    """
    ctas = B * K * groups
    n_tiles = -(-capacity // SPLIT_TILE)
    splits = 1
    while (splits < SPLIT_MAX_SPLITS and 2 * splits <= n_tiles
           and ctas * splits * SPLIT_SMS_PER_CTA < sms):
        splits *= 2
    return splits


def decode_launch(B: int, H: int, K: int, capacity: int, q_dtype: torch.dtype,
                  index: int) -> tuple:
    """``(rows, splits)`` of a split-body decode call on CUDA device
    ``index``: :func:`decode_group_rows` and :func:`decode_splits`."""
    g = H // K
    rows = decode_group_rows(g, q_dtype)
    return rows, decode_splits(B, K, capacity, sm_count(index), -(-g // rows))

class KernelError(RuntimeError):
    """A kernel failed to build, or its launch was refused."""


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built "
            "from source at first use"
        )
    return found


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(ARCH_FLAGS + CFLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"


def build() -> Dict[str, object]:
    """Compile the kernels if no current build exists.

    Returns
    -------
    dict
        ``{"path", "seconds", "built", "log"}``: the library, the wall
        time spent here, whether this call compiled, and the compilers'
        output (``-Xptxas -v`` lists registers and shared memory).
    """
    t0 = time.perf_counter()
    lib = library_path()
    log_path = lib.with_suffix(".log")
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": str(lib), "seconds": time.perf_counter() - t0,
                "built": False, "log": log}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    logs: List[str] = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in _sources()]
        procs = [
            subprocess.Popen(
                [nvcc, *ARCH_FLAGS, *CFLAGS, "-I", str(CSRC), "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(_sources(), objs)
        ]
        failed = []
        for src, proc in zip(_sources(), procs):
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise KernelError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        logs.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            raise KernelError("nvcc link failed:\n" + "\n".join(logs))
        log = "\n".join(logs)
        log_path.write_text(log)
        os.replace(tmp_lib, lib)
    return {"path": str(lib), "seconds": time.perf_counter() - t0,
            "built": True, "log": log}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library, once per process."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def entry(name: str):
    """The C entry point ``name``, looked up once per process."""
    return getattr(library(), name)


def rows_16b(shape, strides, misalign: int, itemsize: int) -> bool:
    """Whether a tensor's rows (its last dim) can be copied 16 bytes at a time.

    Pure Python on what the tensor describes: its ``shape``, ``strides``
    (in elements), ``data_ptr() % 16`` and element size.  True when the
    inner stride is 1 and every row starts on a 16-byte boundary: the data
    pointer is, and every outer stride is a multiple of 16 bytes (a dim of
    size 1 is never stepped, so its stride is not checked).  It runs on
    every launch, so it is written for speed.
    """
    if misalign or strides[-1] != 1:
        return False
    per = 16 // itemsize
    for i in range(len(shape) - 1):
        if strides[i] % per and shape[i] != 1:
            return False
    return True


def current_stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current CUDA stream: what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without
    building a Stream object (a few microseconds less a launch)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def refuse_grad(name: str, *tensors) -> None:
    """Raise when a kernel wrapper would hand out an output with no gradient.

    A wrapper's output is a fresh tensor with no ``grad_fn``: called with
    grad mode on and an input that requires grad, it would cut the graph
    there and leave every gradient behind it silently wrong.  The
    differentiable route is :mod:`repro_torch.kernels.ops` (its autograd
    functions run the wrappers with grad mode off and the backward kernels
    after them); serving runs without grad.  Checked first, before any
    other check, so it holds for tensors on every device.
    """
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and a kernel wrapper returns an output "
            "with no gradient; call it through repro_torch.kernels.ops (autograd) or "
            "under torch.no_grad()")


def check(code: int, name: str) -> None:
    """Raise :class:`KernelError` when a C entry point returned an error."""
    if code != 0:
        msg = library().repro_cuda_error_string(code).decode()
        raise KernelError(f"{name}: launch failed with CUDA error {code} ({msg})")
