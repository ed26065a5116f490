"""Build and load the port's CUDA kernels.

The kernels live in ``repro_torch/csrc/*.cu`` with a plain C interface.
At first use ``nvcc`` compiles them for Hopper (``sm_90a``), one process
per source, all started together, and links the objects into one shared
library under ``<repo>/build/kernels/``, which ``ctypes`` loads: no PyTorch
headers, so the build takes seconds. The library's file name carries a hash
of the sources, the flags and nvcc's version, so a change to any of them
builds anew. A failed build raises; there is no
fallback. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCES = tuple(_PKG / "csrc" / name for name in (
    "connectivity_rounds.cu", "embedding_bag.cu", "flash_attention.cu",
    "flash_attention_mma.cu", "flash_attention_tf32x3.cu"))
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
#: flags of each source's compile (``-c``); the objects are then linked with
#: ``-shared``
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_SIGNATURES = {
    # src, dst, mask, labels, best, e, n_labels, num_segments, table, stream
    "repro_boruvka_round": [_P, _P, _P, _P, _P, ctypes.c_longlong,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
    # src, dst, mask, labels, best, e, n_labels, num_segments, stream
    "repro_boruvka_round_v1": [_P, _P, _P, _P, _P, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_int, _P],
    # src, dst, mask, frontier, visited, packed, e, n_nodes, num_segments,
    # stream
    "repro_frontier_round": [_P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                             ctypes.c_int, ctypes.c_int, _P],
    # src, dst, mask, frontier, visited, packed, best_p, best_e, e,
    # n_nodes, num_segments, stream
    "repro_frontier_round_v1": [_P, _P, _P, _P, _P, _P, _P, _P,
                                ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_int, _P],
    # keys, ids, out, e, num_segments, fill, stream
    "repro_segment_min": [_P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int, _P],
    # keys, ids, out, e, num_segments, stream
    "repro_segment_min_v1": [_P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                             _P],
    # table, idx, mask, out, n_bags, bag_len, n_rows, dim, mode, dtype,
    # block_items_max, stream
    "repro_embedding_bag": ([_P, _P, _P, _P] + [ctypes.c_int] * 6
                            + [ctypes.c_longlong, _P]),
    # the same without block_items_max
    "repro_embedding_bag_v1": [_P, _P, _P, _P] + [ctypes.c_int] * 6 + [_P],
    # stream
    "repro_noop": [_P],
    # q, k, v, out, batch, sq, skv, hq, hkv, d, scale, causal, dtype, stream
    "repro_flash_attention": ([_P] * 4 + [ctypes.c_int] * 6
                              + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                 _P]),
    # q, k, v, out, batch, sq, skv, hq, hkv, d, scale, causal, stream
    "repro_flash_attention_mma": ([_P] * 4 + [ctypes.c_int] * 6
                                  + [ctypes.c_float, ctypes.c_int, _P]),
    # the same as repro_flash_attention_mma
    "repro_flash_attention_tf32x3": ([_P] * 4 + [ctypes.c_int] * 6
                                     + [ctypes.c_float, ctypes.c_int, _P]),
}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path() -> Path:
    """``build/kernels/librepro_torch_kernels.<hash>.so``, the hash taken
    over the sources, ``NVCC_FLAGS`` and ``nvcc --version``."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    version = subprocess.run([nvcc(), "--version"], capture_output=True,
                             text=True, check=True).stdout
    h.update(version.encode())
    return BUILD_DIR / f"librepro_torch_kernels.{h.hexdigest()[:16]}.so"


def _run_together(cmds: list) -> str:
    """Start every command at once, wait for all; their output, or raise
    naming the first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build(force: bool = False) -> dict:
    """Compile the sources into ``lib_path()`` unless that file is there:
    one nvcc per source, all at once, then one link. Returns ``{"built",
    "path", "seconds", "log"}``; ``log`` holds nvcc's output, with ptxas's
    register and spill figures."""
    path = lib_path()
    if not force and path.is_file():
        return {"built": False, "path": path, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{path.name}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    tmp = BUILD_DIR / f"{tag}.tmp"
    t0 = time.perf_counter()
    try:
        log = _run_together([[nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                              str(src)] for src, obj in zip(SOURCES, objs)])
        log += _run_together([[nvcc(), *NVCC_FLAGS[:2], "-shared", "-o",
                               str(tmp), *map(str, objs)]])
        os.replace(tmp, path)  # atomic: no process loads a half-written file
    finally:
        for leftover in (tmp, *objs):
            leftover.unlink(missing_ok=True)
    return {"built": True, "path": path,
            "seconds": time.perf_counter() - t0, "log": log}


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once."""
    lib = ctypes.CDLL(str(build()["path"]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call entry point ``name`` on ``device``'s current stream; raise on a
    non-zero launch code."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, name)(*args, stream)
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")
