"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes``; no PyTorch
header is included, so a build takes seconds.  Libraries go to
``build/repro_torch_kernels/`` at the repository root, and a library's
file name carries a hash of its source, every ``csrc/*.cuh`` header and
the flags, so a stale build is never loaded.  :func:`build` starts one
``nvcc`` per source, all at once, and raises with the compiler's output
when one fails.

Nothing here runs at import: the CPU tests import every module, and a
kernel is built at its first launch (or by an explicit :func:`build`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "repro_torch_kernels"
KERNELS = ("flash_decode", "flash_combine", "flash_prefill",
           "flash_decode_quant", "flash_prefill_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of the C entry points (csrc/common.cuh): the compute
# dtypes, and the storage dtypes of a quantized KV cache
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
QUANT_CODES = {torch.int8: 2, torch.float8_e4m3fn: 3}

# Kernel launches by kernel name.  A wrapper adds one where it launches
# its kernel and nowhere else (the CPU path launches nothing); it may
# also count the launch, at the same place, under a tuple key that starts
# with the name and tells its instantiations and shapes apart.
LAUNCHES: Counter = Counter()

_LIBS: Dict[str, ctypes.CDLL] = {}


@dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    seconds: float        # 0.0 when the library was already built
    log: str              # nvcc's output (ptxas -v registers, smem, spills)


def nvcc_path() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.exists() else None


def available() -> Tuple[bool, str]:
    """Whether the kernels can build and run here, with the reason when
    they cannot (GPU tests quote it when they skip)."""
    if not torch.cuda.is_available():
        return False, f"no CUDA device (torch {torch.__version__})"
    cap = torch.cuda.get_device_capability(0)
    if cap < (9, 0):
        return False, f"kernels target sm_90a, device capability is {cap}"
    if nvcc_path() is None:
        return False, "nvcc not found on PATH or in /usr/local/cuda/bin"
    return True, "nvcc and a CUDA device of capability >= (9, 0)"


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, BuildResult]:
    """Compile the named kernels that are not built yet, one ``nvcc``
    per source, all started together.  Raises ``RuntimeError`` with the
    compiler's output if one fails."""
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("cannot build CUDA kernels: nvcc not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: Dict[str, BuildResult] = {}
    procs = {}
    for name in names:
        path = _lib_path(name)
        log = path.with_suffix(".log")
        if path.exists():
            results[name] = BuildResult(
                name, path, 0.0, log.read_text() if log.exists() else "")
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       path, tmp, log, time.perf_counter())
    failed = []
    for name, (proc, path, tmp, log, t0) in procs.items():
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n"
                          f"{out}")
            continue
        log.write_text(out)
        os.replace(tmp, path)
        results[name] = BuildResult(name, path, seconds, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build([name])[name].path
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def cuda_args(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is on a CUDA device with a 16-byte
    aligned base, as the kernels' vector loads need."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"expected a CUDA tensor, got {t.device}")
        if t.data_ptr() % 16:
            raise ValueError("kernel inputs need 16-byte aligned storage")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream
