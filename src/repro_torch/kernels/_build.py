"""Build and load the hand-written CUDA kernels (``kernels/csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface and loaded with ``ctypes``: no
PyTorch headers, so a build takes seconds. All sources build at first use,
one ``nvcc`` process each, started together. A library's file name carries
a hash of its source, so an edited source builds anew and an unchanged one
is loaded from the build directory (``kernels/_build_out/``, listed in
``.gitignore``). ``nvcc`` runs with ``-Xptxas -v`` and keeps what it
printed (each kernel's registers, shared memory and spills) in a log beside
the library.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build_out"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry point and argument types of every source's launcher
SIGNATURES = {
    "apply_write": (
        "apply_write_launch", (_P, _P, _P, _P, _I, _L, _L, _P)),
    "apply_trim": (
        "apply_trim_launch", (_P, _P, _P, _I, _L, _L, _P)),
    "write_run": (
        "write_run_launch", (_P, _I, _P, _I, _I, _I, _I, _I, _P)),
    "compact_slots": (
        "compact_slots_launch", (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)),
    "gc_one": (
        "gc_one_launch", (_P, _I, _P, _I, _I, _I, _I, _P)),
    "gc_compact": (
        "gc_compact_launch", (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)),
    "paged_attention": (
        "paged_attention_launch",
        (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)),
    "flash_attention": (
        "flash_attention_launch",
        (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P)),
}

_loaded: dict = {}  # kernel name -> its loaded ctypes launcher


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found at {path} (set CUDA_HOME)")
    return str(path)


def library(name: str) -> pathlib.Path:
    """The built library of source ``name`` (its nvcc log: suffix .log)."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source whose library is missing, all in parallel.
    Returns the wall seconds taken; raises with nvcc's output on failure."""
    t0 = time.perf_counter()
    todo = [n for n in SIGNATURES if not library(n).exists()]
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for name in todo:
            tmp = library(name).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        failed = []
        for name, tmp, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}.cu (rc {proc.returncode}):\n{out}")
            else:
                library(name).with_suffix(".log").write_text(out)
                os.replace(tmp, library(name))
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def launcher(name: str):
    """The ctypes function of kernel ``name``, building at first use."""
    if name not in _loaded:
        if not library(name).exists():
            build_all()
        lib = ctypes.CDLL(str(library(name)))
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return _loaded[name]


def check_tensors(op: str, **specs) -> None:
    """Raise unless every ``name=(tensor, dtype, shape)`` matches and all
    tensors are contiguous and on one device: what a kernel is handed is
    a raw pointer, so nothing else may reach it."""
    device = None
    for name, (t, dtype, shape) in specs.items():
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{op}: {name} is {t.dtype} {tuple(t.shape)}, "
                f"wants {dtype} {tuple(shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} is not contiguous")
        device = t.device if device is None else device
        if t.device != device:
            raise ValueError(f"{op}: {name} is on {t.device}, not {device}")


def check_aligned(op: str, **tensors) -> None:
    """Raise unless every tensor starts on a 16-byte boundary: the kernels
    load 16 bytes a thread."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} is not 16-byte aligned")


def check_launch(name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
