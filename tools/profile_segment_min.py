#!/usr/bin/env python3
"""Where the segment min's time goes on the card, stage by stage.

    python3 tools/profile_segment_min.py

Builds probe kernels that include ``src/repro_torch/csrc/
connectivity_rounds.cu`` and do one stage of the kernel's body (a
persistent grid, ``kPer`` keys per thread by 16- or 8-byte loads, ``out``
filled by the caller) on two inputs at the device final's shape (524,284
keys, 131,072 segments): ``chip_smoke.py``'s random keys and ids (INF32 keys
and out-of-range ids included), and the keys and ids the bridge pipeline
itself hands the op in one ``find_bridges(final="device")`` call on the
paper's Fig. 2 graph. The stages:

  loads        the loads of keys and ids
  reads        + each live key reads out[id] (no atomic)
  serial       + min_into per key, in turn (read, then atomicMin where
                 smaller, then the next key's read: the kernel's body)
  reads_first  the thread's reads all issued before any atomicMin
  blind        atomicMin for every live key, no read

each with four and with two keys per thread; then the op (one cooperative
launch), the same body after a PyTorch fill and the first kernel after that
fill. Every probe fills ``out`` inside its interval. Times are medians of
CUDA-event intervals taken in turns (``chip_smoke.py::time_turns``). Prints
one JSON line per input with the live keys, the segments they reach, the
most keys on one segment and the live keys whose id is the previous key's
(what a warp's run leaders could fold), then the card's name and power
limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from repro_torch import find_bridges  # noqa: E402
from repro_torch.core.api import pad_graph  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.datastructs import INF32, INT  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels.segment_min import ops as segment_min_ops  # noqa: E402
from repro_torch.kernels.segment_min.kernel import (  # noqa: E402
    filled_segment_min,
    previous_segment_min,
)

PROBE = r'''
#include "connectivity_rounds.cu"

namespace {
template <int kStage, int kPer>
__global__ void __launch_bounds__(kThreads) probe_kernel(
    const int* __restrict__ keys, const int* __restrict__ ids, int* out,
    long long n_vec, int num_segments) {
  const long long thread =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  int acc = 0;
  for (long long g = thread; g < n_vec; g += threads) {
    int k[kPer], id[kPer];
    if (kPer == 4) {
      const int4 k4 = __ldcs(reinterpret_cast<const int4*>(keys) + g);
      const int4 i4 = __ldcs(reinterpret_cast<const int4*>(ids) + g);
      k[0] = k4.x; k[1 % kPer] = k4.y; k[2 % kPer] = k4.z; k[3 % kPer] = k4.w;
      id[0] = i4.x; id[1 % kPer] = i4.y; id[2 % kPer] = i4.z;
      id[3 % kPer] = i4.w;
    } else {
      const int2 k2 = __ldcs(reinterpret_cast<const int2*>(keys) + g);
      const int2 i2 = __ldcs(reinterpret_cast<const int2*>(ids) + g);
      k[0] = k2.x; k[1] = k2.y; id[0] = i2.x; id[1] = i2.y;
    }
    bool live[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      live[j] = k[j] != kInf32 &&
                static_cast<unsigned>(id[j]) < static_cast<unsigned>(num_segments);
    if (kStage == 0) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc ^= live[j] ? k[j] : 0;
    } else if (kStage == 1) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc ^= live[j] ? __ldcg(out + id[j]) : 0;
    } else if (kStage == 2) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) if (live[j]) min_into(out + id[j], k[j]);
    } else if (kStage == 3) {
      int seen[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) seen[j] = live[j] ? __ldcg(out + id[j]) : 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (live[j] && seen[j] > k[j]) atomicMin(out + id[j], k[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) if (live[j]) atomicMin(out + id[j], k[j]);
    }
  }
  if (acc == 0x13572468) out[0] = acc;  // keeps the stages' work alive
}

template <int kStage, int kPer>
int launch_stage(const int* keys, const int* ids, int* out, long long e,
                 int num_segments, cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, probe_kernel<kStage, kPer>, kThreads, 0);
  probe_kernel<kStage, kPer><<<sms * per_sm, kThreads, 0, s>>>(
      keys, ids, out, e / kPer, num_segments);
  return static_cast<int>(cudaGetLastError());
}

template <int kPer>
int launch_per(int stage, const int* keys, const int* ids, int* out,
               long long e, int num_segments, cudaStream_t s) {
  switch (stage) {
    case 0: return launch_stage<0, kPer>(keys, ids, out, e, num_segments, s);
    case 1: return launch_stage<1, kPer>(keys, ids, out, e, num_segments, s);
    case 2: return launch_stage<2, kPer>(keys, ids, out, e, num_segments, s);
    case 3: return launch_stage<3, kPer>(keys, ids, out, e, num_segments, s);
    default: return launch_stage<4, kPer>(keys, ids, out, e, num_segments, s);
  }
}
}  // namespace

extern "C" int probe_stage(int stage, int per, const int* keys,
                           const int* ids, int* out, long long e,
                           int num_segments, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return per == 4 ? launch_per<4>(stage, keys, ids, out, e, num_segments, s)
                  : launch_per<2>(stage, keys, ids, out, e, num_segments, s);
}
'''
STAGES = ("loads", "reads", "serial", "reads_first", "blind")


def build_probe() -> ctypes.CDLL:
    out = cuda_lib.BUILD_DIR / "probe_segment_min"
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe.cu").write_text(PROBE)
    so = out / "libprobe.so"
    subprocess.run([cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-shared",
                    "-I", str(cuda_lib.SOURCES[0].parent), "-o", str(so),
                    str(out / "probe.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    lib.probe_stage.argtypes = ([ctypes.c_int, ctypes.c_int]
                                + [ctypes.c_void_p] * 3
                                + [ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_void_p])
    lib.probe_stage.restype = ctypes.c_int
    return lib


def path_inputs() -> tuple:
    """The keys, ids and segment count the op gets in one
    ``find_bridges(final="device")`` call on the Fig. 2 graph."""
    src, dst, _ = gen.planted_bridge_graph(smoke.N_NODES, smoke.N_EDGES,
                                           smoke.N_BRIDGES, seed=smoke.SEED)
    seen = []
    kernel = segment_min_ops.segment_min_cuda

    def recording(keys, ids, n):
        seen.append((keys.clone(), ids.clone(), n))
        return kernel(keys, ids, n)

    segment_min_ops.segment_min_cuda = recording
    try:
        find_bridges(src, dst, smoke.N_NODES, final="device")
    finally:
        segment_min_ops.segment_min_cuda = kernel
    assert len(seen) == 1, len(seen)
    return seen[0]


def random_inputs() -> tuple:
    """``chip_smoke.py::check_segment_min``'s keys and ids."""
    n = pad_graph([0], [1], smoke.N_NODES).n_nodes
    a = 2 * smoke.certificate_capacity(n)
    gen_ = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    keys = torch.randperm(a, generator=gen_, device="cuda").to(INT)
    keys[torch.rand(a, generator=gen_, device="cuda") < 0.1] = INF32
    ids = torch.randint(-1000, n + 1000, (a,), generator=gen_, device="cuda",
                        dtype=INT)
    ids[:4] = torch.tensor([-(2 ** 31), -1, n, INF32], dtype=INT)
    return keys, ids, n


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_segment_min: no CUDA device", file=sys.stderr)
        return 2
    lib = build_probe()
    flush = torch.empty(smoke.L2_FLUSH_BYTES, dtype=torch.uint8,
                        device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for tag, (keys, ids, n) in (("random", random_inputs()),
                                ("path", path_inputs())):
        e = keys.numel()
        assert keys.data_ptr() % 16 == 0 and ids.data_ptr() % 16 == 0
        out = torch.empty(n, dtype=INT, device="cuda")
        fns = {}
        for per in (4, 2):
            for stage, name in enumerate(STAGES):
                def run(stage=stage, per=per):
                    out.fill_(INF32)
                    code = lib.probe_stage(stage, per, keys.data_ptr(),
                                           ids.data_ptr(), out.data_ptr(),
                                           e - e % per, n, stream)
                    assert code == 0, code
                fns[f"{name}_x{per}"] = run
        fns["op"] = lambda: segment_min_ops.segment_min(keys, ids, n)
        fns["filled_first"] = lambda: filled_segment_min(keys, ids, n)
        fns["previous"] = lambda: previous_segment_min(keys, ids, n)
        live = (keys != INF32) & (ids >= 0) & (ids < n)
        hit = torch.where(live, ids, -1)
        rec = {"input": tag, "E": e, "n": n, "live_keys": int(live.sum()),
               "segments_reached": int(torch.unique(ids[live]).numel()),
               "most_keys_on_one_segment": int(
                   torch.bincount(ids[live].long(), minlength=n).max()),
               "keys_after_their_own_id": int(
                   (live & (hit == torch.roll(hit, 1))).sum()),
               **smoke.time_turns(fns, flush)}
        print(json.dumps(rec), flush=True)
    print(smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
