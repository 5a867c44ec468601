"""Build and load the port's CUDA kernels.

Every `*/csrc/*.cu` under this package is compiled at first use by
`nvcc` for Hopper (`sm_90a`) into a shared library with a plain C
interface, and loaded with `ctypes`. The library is named after the
hash of its source and of the headers it includes with quotes (such as
`sm90.cuh`, shared by the tensor-core kernels), and lands in
`build/kernels/` at the repository root, so an edited source or header
is rebuilt and an unchanged one is not.

There is no fallback: a missing `nvcc`, a failed build or a failed
launch raises. `--use_fast_math` is never passed, because the int8
codec must divide and round exactly as IEEE float32 does.

Each C entry returns `cudaGetLastError()` right after its launch, and
`check` turns a non-zero return into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

import torch

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Every kernel source of the package, by file stem."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def cuda_tool(name: str) -> str:
    """A CUDA toolkit program (`nvcc`, `cuobjdump`) on PATH or in
    /usr/local/cuda/bin."""
    found = shutil.which(name)
    if found:
        return found
    default = f"/usr/local/cuda/bin/{name}"
    if os.path.exists(default):
        return default
    raise RuntimeError(f"{name} not found: the port's CUDA kernels are "
                       f"built from source on the machine with the card")


def _headers(src: Path) -> List[Path]:
    """The files `src` includes with quotes, found beside the file that
    includes them, and the files they include in turn, in order."""
    found: List[Path] = []
    todo = [src]
    while todo:
        f = todo.pop(0)
        for name in re.findall(r'^\s*#\s*include\s*"([^"]+)"',
                               f.read_text(), re.M):
            h = (f.parent / name).resolve()
            if h not in found:
                found.append(h)
                todo.append(h)
    return found


def _library_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in _headers(src):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _compile(src: Path) -> Path:
    out = _library_path(src)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [cuda_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True)
    # ptxas -v reports registers, shared memory and spills per kernel
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_all() -> float:
    """Compile every kernel source, one `nvcc` per source, all at once.
    Returns the wall seconds the builds took."""
    t0 = time.perf_counter()
    srcs = list(sources().values())
    with ThreadPoolExecutor(max_workers=max(len(srcs), 1)) as pool:
        for fut in [pool.submit(_compile, s) for s in srcs]:
            fut.result()
    return time.perf_counter() - t0


def library_path(stem: str) -> Path:
    """Where the library built from `<stem>.cu` lies."""
    return _library_path(sources()[stem])


def build_log(stem: str) -> str:
    """What nvcc and ptxas said when they built `stem`."""
    return library_path(stem).with_suffix(".log").read_text()


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from `<stem>.cu`, built on first use."""
    if stem not in _LIBS:
        lib = ctypes.CDLL(str(_compile(sources()[stem])))
        err = getattr(lib, f"{stem}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LIBS[stem] = lib
    return _LIBS[stem]


def check(stem: str, rc: int) -> None:
    """Raise if a C entry of `stem` returned a CUDA error."""
    if rc != 0:
        msg = getattr(library(stem), f"{stem}_error_string")(rc).decode()
        raise RuntimeError(f"{stem} kernel launch failed: {msg} ({rc})")


def stream_ptr(tensor) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on the tensor's device."""
    return ctypes.c_void_p(
        torch.cuda.current_stream(tensor.device).cuda_stream)
