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

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
L = ctypes.c_longlong

_STRIDES = [L] * 8
#: C signature of every entry point (all return an int cudaError_t)
SIGNATURES: Dict[str, List] = {
    "rmsnorm_f32": [P, P, P, I, I, F, P],
    "rmsnorm_bf16": [P, P, P, I, I, F, P],
    "paged_decode_f32": [P] * 6 + [I] * 7 + _STRIDES + [F, P],
    "paged_decode_bf16": [P] * 6 + [I] * 7 + _STRIDES + [F, P],
    "paged_prefill_f32": [P] * 5 + [I] * 8 + _STRIDES + [F, P],
    "paged_prefill_bf16": [P] * 5 + [I] * 8 + _STRIDES + [F, P],
    "decode_attention_f32": [P] * 5 + [I] * 6 + _STRIDES + [F, P],
    "decode_attention_bf16": [P] * 5 + [I] * 6 + _STRIDES + [F, P],
    "flash_attention_f32": [P] * 4 + [I] * 9 + [L] * 12 + [F, P],
    "flash_attention_bf16": [P] * 4 + [I] * 9 + [L] * 12 + [F, P],
}


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


def check(code: int, name: str) -> None:
    """Raise :class:`KernelError` when a C entry point returned an error."""
    if code != 0:
        msg = library().repro_cuda_error_string(code).decode()
        raise KernelError(f"{name}: launch failed with CUDA error {code} ({msg})")
