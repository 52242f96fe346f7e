"""Build and load the port's CUDA kernels.

Each kernel source in `ilqgames_tpu_torch/csrc/` is compiled by `nvcc`
into a shared library with a plain C interface, loaded with ctypes, at
first use. Problem dimensions are compile-time constants (`-D` flags),
so every (source, dimensions) pair is its own library. Libraries are
cached in `ilqgames_tpu_torch/_build/` under a hash of the source, the
shared headers (`csrc/*.cuh`) and the flags. Nothing is downloaded: if `nvcc` is missing or the build
fails, this raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# No --use_fast_math, and no FMA contraction: every kernel then rounds
# exactly as its plain PyTorch version's separate multiplies and adds.
# -Xptxas -v: each kernel's registers, stack frame and spills, kept beside
# the library (`ptxas_report`).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOADED = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "CUDA kernels are built from csrc/ at first use on a CUDA machine")
    return path


def _target(name: str, defines: dict):
    """(source, nvcc flags, library path) of csrc/<name>.cu with defines."""
    src = CSRC / f"{name}.cu"
    flags = list(NVCC_FLAGS) + [f"-D{k}={v}"
                                for k, v in sorted(defines.items())]
    digest = hashlib.sha256(" ".join(flags).encode())
    for dep in [src, *sorted(CSRC.glob("*.cuh"))]:
        digest.update(dep.read_bytes())
    return src, flags, BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _compile(targets) -> None:
    """Run one nvcc per library not built yet (a library named twice is
    built once), all at once, and wait."""
    todo = list({t[2]: t for t in targets if not t[2].exists()}.values())
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src, flags, out in todo:
            tmp_out = Path(tmp) / out.name
            procs.append((src, out, tmp_out, subprocess.Popen(
                [nvcc_path(), *flags, "-o", str(tmp_out), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        errors = []
        for src, out, tmp_out, proc in procs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed to build {src.name} "
                              f"(rc {proc.returncode}):\n{stdout}\n{stderr}")
            else:
                os.replace(tmp_out, out)
                _report_path(out).write_text(stdout + stderr)
        if errors:
            raise RuntimeError("\n".join(errors))


def _report_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def ptxas_report(name: str, defines: dict) -> dict:
    """{kernel's mangled name: {"registers", "stack", "spill_stores",
    "spill_loads"}} from the build of csrc/<name>.cu with `defines` (built
    first if it is not yet)."""
    target = _target(name, defines)
    _compile([target])
    out, cur = {}, None
    for line in _report_path(target[2]).read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        m = m or re.search(r"Function properties for (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def load(name: str, defines: dict) -> ctypes.CDLL:
    """Build (if not cached) and load csrc/<name>.cu with `-D` defines."""
    target = _target(name, defines)
    out = target[2]
    if out in _LOADED:
        return _LOADED[out]
    _compile([target])
    lib = ctypes.CDLL(str(out))
    _LOADED[out] = lib
    return lib


def compile_all(libraries) -> None:
    """Build the (name, defines) libraries not cached yet, one concurrent
    nvcc process each."""
    _compile([_target(name, defines) for name, defines in libraries])


def check_operands(named) -> torch.device:
    """Validate a kernel's operands, given as (name, tensor, shape): float32,
    contiguous, of the given shape, all on one CPU or CUDA device, which
    is returned."""
    dev = named[0][1].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}: CPU or CUDA only")
    for name, t, shape in named:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want "
                             f"{tuple(shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, want float32")
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, others on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    return dev


def stream(dev: torch.device) -> int:
    """The raw handle of the current stream on a CUDA device, for a
    kernel's C function: the value of
    `torch.cuda.current_stream(dev).cuda_stream` without building a Stream
    object (0.8 against 6.8-12.0 us on an H100 host, tools/launch_split)."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return torch._C._cuda_getCurrentRawStream(index)


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a kernel's C function."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
