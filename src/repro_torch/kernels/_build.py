"""Build and load the CUDA kernels: nvcc by hand, a plain C interface, ctypes.

Every ``*.cu`` under ``kernels/csrc`` compiles, one ``nvcc`` process per
source started together, into an object for ``sm_90a``; the objects link
into one shared library loaded with ``ctypes``. The library's name
carries a hash of the sources and flags, so an edited source rebuilds
and an unchanged one loads the library already built. Nothing happens at
import: the first CUDA launch calls ``library()``. Machines without
``nvcc`` (the CPU test runs) never get here, because CPU tensors take
the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
# <repo>/build/repro_torch for a source checkout (src/repro_torch/kernels)
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# --split-compile=0: each nvcc runs its optimisation passes on as many
# threads as the machine has cores; the flash sources' 40 and 52 kernels
# otherwise go through ptxas one after another
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "--split-compile=0")

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_c_ll = ctypes.c_longlong
_c_int = ctypes.c_int
_c_ptr = ctypes.c_void_p
_c_float = ctypes.c_float
# C signatures, in the order of the extern "C" declarations in csrc/*.cu
_SIGNATURES = {
    "repro_bvsb": [_c_ptr, _c_int, _c_ll, _c_ll, _c_int, _c_int, _c_int,
                   _c_ptr, _c_ptr, _c_ptr, _c_ptr],
    "repro_bvsb_partials": [_c_ptr, _c_int, _c_ll, _c_ll, _c_int, _c_int,
                            _c_int, _c_ptr, _c_ptr, _c_int, _c_ptr],
    "repro_bvsb_merge": [_c_ptr, _c_ll, _c_int, _c_ptr, _c_ptr, _c_ptr],
    "repro_flash_attention": [_c_ptr] * 4 + [_c_int] * 7 + [_c_ll] * 12
    + [_c_int, _c_int, _c_float, _c_float, _c_ptr, _c_ptr],
    "repro_flash_attention_kernel": [_c_ptr] * 4 + [_c_int] * 7 + [_c_ll] * 12
    + [_c_int, _c_int, _c_float, _c_float, _c_ptr, _c_ptr, _c_int],
    "repro_flash_uses_tensor_cores": [_c_int] * 3,
    "repro_flash_attention_bwd_kernel": [_c_ptr] * 10 + [_c_int] * 7
    + [_c_ll] * 15 + [_c_int, _c_int, _c_float, _c_float, _c_ptr, _c_int,
                      _c_ptr, _c_int],
    "repro_flash_bwd_uses_tensor_cores": [_c_int] * 3,
    "repro_flash_attention_bwd": [_c_ptr] * 10 + [_c_int] * 7 + [_c_ll] * 15
    + [_c_int, _c_int, _c_float, _c_float, _c_ptr, _c_int, _c_ptr],
    "repro_rglru_scan": [_c_ptr] * 4 + [_c_int] * 4 + [_c_ll] * 4
    + [_c_int] * 3 + [_c_ptr],
    "repro_rglru_scan_bwd": [_c_ptr] * 7 + [_c_int] * 4 + [_c_ll] * 2
    + [_c_int] * 3 + [_c_ptr],
    "repro_decode_attention": [_c_ptr] * 6 + [_c_int] * 9 + [_c_ll] * 10
    + [_c_float, _c_float, _c_ptr],
    "repro_decode_attention_partials": [_c_ptr] * 5 + [_c_int] * 12
    + [_c_ll] * 8 + [_c_float, _c_float, _c_ptr],
    "repro_decode_attention_merge": [_c_ptr] * 2 + [_c_int] * 6
    + [_c_ll] * 2 + [_c_ptr],
}

_LOCK = threading.Lock()
_LIB = None
_SMS = {}
# the SMs that plan a call on ``meta`` tensors, where no card is asked: the
# production card's (an H100 SXM5 has 132); the dry-run may set it
META_SMS = 132


def sources():
    return sorted(CSRC.glob("*.cu"))


def build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built from kernels/csrc on the machine with the card")


def _run_all(cmds, cwd, verbose):
    """Start every command at once, wait for all; raise with the first
    failure's output, and print every output when ``verbose``."""
    procs = [subprocess.Popen(c, cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
        if verbose and out:
            print(out, end="", file=sys.stderr)


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the library for this source hash unless it exists; its path.
    ``verbose`` adds ptxas's register/spill report to stderr."""
    lib_path = BUILD_DIR / f"librepro_torch_kernels_{build_key()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ("-Xptxas", "-v") if verbose else ()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [pathlib.Path(tmp) / f"{src.stem}.o" for src in sources()]
        _run_all([[nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
                  for src, obj in zip(sources(), objs)], CSRC, verbose)
        staged = pathlib.Path(tmp) / lib_path.name
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
                   str(staged)]], CSRC, verbose)
        os.replace(staged, lib_path)  # atomic: concurrent builders agree
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def check(rc: int, name: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device, read once per device:
    the property query costs some 100 us of host time, more than the
    kernels that plan their grids by it. A ``meta`` device has META_SMS."""
    if device.type == "meta":
        return META_SMS
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def device_kind(name: str, t: torch.Tensor) -> str:
    """The device kind a kernel wrapper serves ``t`` on: "cpu" (the plain
    version), "cuda" (the kernel) or "meta" (no launch, the work booked);
    any other device raises."""
    kind = t.device.type
    if kind not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return kind


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def wants_grad(*tensors) -> bool:
    """Whether autograd records a call on ``tensors``: grad mode is on and
    one of them requires a gradient. A CUDA kernel wrapper then goes
    through its ``torch.autograd.Function``, or raises where the kernel
    has no backward; it never returns an output cut off from the graph."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd would record a call of kernel ``name``, which has
    no backward kernel."""
    if wants_grad(*tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and its output would "
            "carry no gradient; call it under torch.no_grad() or "
            "torch.inference_mode(), or on tensors that do not require grad")
