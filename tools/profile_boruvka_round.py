#!/usr/bin/env python3
"""Where the Borůvka round's time goes on the card, stage by stage.

    python3 tools/profile_boruvka_round.py [--bags-only]

Builds probe kernels that include ``src/repro_torch/csrc/
connectivity_rounds.cu`` and stop after one stage of the redesigned
round's work, at the bridge pipeline's shape (the paper's Fig. 2 point,
2^24 slots, n 131,072) with identity and round-2 labels:

  0 loads      the loads of mask, and of src and dst where a mask word
               is not 0 (as the kernel does)
  1 gathers    + both endpoint labels of every live slot
  2 match      + __match_any_sync per side (every lane of a label in one
                 group), in place of the kernel's run leaders
  3 runs       + the kernel's run leaders (one __shfl_up_sync per side)
  4 read       + each run leader reads best[label] (no atomic)
  5 red        + each run leader's atomicMin, without the read
  6 read_ahead as 4, but a warp step's 8 leader reads all issued before
               any is used (is 4 bound by their latency or their rate?)

then the real kernels: the redesign without and with its per-block
table, and the first kernel. Prints one JSON line per label set: the
median CUDA-event time of each (L2 flushed before every launch, as in
``chip_smoke.py``). Then the one-bag ``embedding_bag`` intervals, every
sample (``profile_one_bag``).
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from repro_torch.core.api import pad_graph  # noqa: E402
from repro_torch.core.forest import hook_round  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.datastructs import INF32, INT  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels.boruvka_round.kernel import (  # noqa: E402
    boruvka_round_cuda,
    boruvka_round_without_table,
    previous_boruvka_round,
)

PROBE = r'''
#include "connectivity_rounds.cu"

namespace {
template <int kStage>
__global__ void __launch_bounds__(kThreads) probe_kernel(
    const int* __restrict__ src, const int* __restrict__ dst,
    const unsigned char* __restrict__ mask, const int* __restrict__ labels,
    int* best, long long n_vec, int n_labels, int num_segments) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  const int4* src4 = reinterpret_cast<const int4*>(src);
  const int4* dst4 = reinterpret_cast<const int4*>(dst);
  const unsigned* mask4 = reinterpret_cast<const unsigned*>(mask);
  int acc = 0;
  for (long long g0 = warp * 32; g0 < n_vec; g0 += warps * 32) {
    const long long g = g0 + lane;
    int4 s4 = make_int4(0, 0, 0, 0);
    int4 d4 = s4;
    unsigned m4 = 0;
    if (g < n_vec) m4 = __ldcs(mask4 + g);
    if (m4) {
      s4 = __ldcs(src4 + g);
      d4 = __ldcs(dst4 + g);
    }
    if (kStage == 0) {
      acc ^= s4.x ^ s4.y ^ s4.z ^ s4.w ^ d4.x ^ d4.y ^ d4.z ^ d4.w ^ m4;
      continue;
    }
    const int su[kVec] = {s4.x, s4.y, s4.z, s4.w};
    const int sv[kVec] = {d4.x, d4.y, d4.z, d4.w};
    int lab[2 * kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      cross_labels(((m4 >> (8 * k)) & 0xffu) != 0, su[k], sv[k], labels,
                   n_labels, num_segments, lab[2 * k], lab[2 * k + 1]);
    const int key0 = static_cast<int>(4 * g);
    if (kStage == 6) {
      bool lead[2 * kVec];
#pragma unroll
      for (int j = 0; j < 2 * kVec; ++j) {
        const int prev = __shfl_up_sync(kFullMask, lab[j], 1);
        lead[j] = lab[j] != kNoLabel && (lane == 0 || prev != lab[j]);
      }
      int got[2 * kVec];
#pragma unroll
      for (int j = 0; j < 2 * kVec; ++j)
        got[j] = lead[j] ? __ldcg(best + lab[j]) : 0;
#pragma unroll
      for (int j = 0; j < 2 * kVec; ++j) acc ^= got[j];
      continue;
    }
#pragma unroll
    for (int j = 0; j < 2 * kVec; ++j) {
      const int label = lab[j];
      if (kStage == 1) { acc ^= label; continue; }
      if (kStage == 2) {
        const unsigned group = __match_any_sync(kFullMask, label);
        acc += label != kNoLabel && __ffs(group) - 1 == lane;
        continue;
      }
      const int prev = __shfl_up_sync(kFullMask, label, 1);
      if (label == kNoLabel || (lane > 0 && prev == label)) continue;
      if (kStage == 3) acc += 1;
      if (kStage == 4) acc ^= __ldcg(best + label);
      if (kStage == 5) atomicMin(best + label, key0 + j / 2);
    }
  }
  if (acc == 0x13572468) best[0] = acc;  // keeps the stages' work alive
}

template <int kStage>
int launch_stage(const int* src, const int* dst, const unsigned char* mask,
                 const int* labels, int* best, long long e, int n_labels,
                 int num_segments, cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                probe_kernel<kStage>,
                                                kThreads, 0);
  probe_kernel<kStage><<<sms * per_sm, kThreads, 0, s>>>(
      src, dst, mask, labels, best, e / kVec, n_labels, num_segments);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

extern "C" int probe_stage(int stage, const int* src, const int* dst,
                           const unsigned char* mask, const int* labels,
                           int* best, long long e, int n_labels,
                           int num_segments, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: return launch_stage<0>(src, dst, mask, labels, best, e, n_labels, num_segments, s);
    case 1: return launch_stage<1>(src, dst, mask, labels, best, e, n_labels, num_segments, s);
    case 2: return launch_stage<2>(src, dst, mask, labels, best, e, n_labels, num_segments, s);
    case 3: return launch_stage<3>(src, dst, mask, labels, best, e, n_labels, num_segments, s);
    case 4: return launch_stage<4>(src, dst, mask, labels, best, e, n_labels, num_segments, s);
    case 5: return launch_stage<5>(src, dst, mask, labels, best, e, n_labels, num_segments, s);
    default: return launch_stage<6>(src, dst, mask, labels, best, e, n_labels, num_segments, s);
  }
}
'''
STAGES = ("loads", "gathers", "match", "runs", "read", "red", "read_ahead")


def build_probe() -> ctypes.CDLL:
    out = cuda_lib.BUILD_DIR / "probe_boruvka_round"
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe.cu").write_text(PROBE)
    so = out / "libprobe.so"
    subprocess.run([cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-shared",
                    "-I", str(cuda_lib.SOURCES[0].parent), "-o", str(so),
                    str(out / "probe.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    lib.probe_stage.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                                + [ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p])
    lib.probe_stage.restype = ctypes.c_int
    return lib


def samples_ms(fn, flush, iters=20, warmup=3, wait_cycles=0) -> list:
    """CUDA-event intervals of ``fn()``, each after an L2 flush; with
    ``wait_cycles`` a device-side spin is queued between the flush and the
    start event."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        flush.zero_()
        if wait_cycles:
            torch.cuda._sleep(wait_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def profile_one_bag(flush) -> None:
    """The one-bag op (SASRec's retrieval shape: the smoke's history of 50,
    D 50) against the first kernel, every sample, on SASRec's item table
    placed three ways: allocated first, allocated after 12 GB of other
    tensors were made and freed (as in chip_smoke.py, where the bridge
    phases run first), and a clone of it; each also with a device-side wait
    queued before the start event."""
    import chip_smoke as smoke
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.embedding_bag.kernel import previous_embedding_bag
    from repro_torch.models.recsys import init_sasrec

    def item_table():
        return init_sasrec(smoke.SASREC, torch.Generator(
            device="cuda").manual_seed(smoke.SEED))["item_emb"]

    first = item_table()
    junk = [torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
            for _ in range(12)]
    del junk
    tables = {"allocated_first": first, "after_12_GB": item_table()}
    tables["clone"] = tables["after_12_GB"].clone()
    idx, mask = smoke.bag_histories(first.shape[0], 1, first.device)
    for where, table in tables.items():
        for mode in ("mean", "max"):
            for name, fn in (("op", embedding_bag),
                             ("previous", previous_embedding_bag)):
                for wait in (0, 200_000):
                    got = samples_ms(lambda: fn(table, idx, mask, mode),
                                     flush, wait_cycles=wait)
                    print(json.dumps({
                        "embedding_bag": name, "table": where, "mode": mode,
                        "wait_cycles": wait,
                        "median": statistics.median(got),
                        "samples": sorted(got)}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_boruvka_round: no CUDA device", file=sys.stderr)
        return 2
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    if "--bags-only" in sys.argv:
        profile_one_bag(flush)
        return 0
    lib = build_probe()
    src, dst, _ = gen.planted_bridge_graph(100_000, 10_000_000, 6, seed=0)
    el = pad_graph(src, dst, 100_000)
    n, e = el.n_nodes, el.capacity
    valid = el.mask & (el.src != el.dst)
    ident = torch.arange(n, dtype=INT, device="cuda")
    round2 = hook_round(el.src, el.dst, valid, ident, n)[0]
    stream = torch.cuda.current_stream().cuda_stream
    best = torch.full((n,), INF32, dtype=INT, device="cuda")
    for tag, labels in (("identity", ident), ("round2", round2)):
        args = (el.src, el.dst, valid, labels, n)
        rec = {"labels": tag, "E": e, "n": n}
        for stage, name in enumerate(STAGES):
            def run(stage=stage):
                best.fill_(INF32)
                code = lib.probe_stage(stage, el.src.data_ptr(),
                                       el.dst.data_ptr(), valid.data_ptr(),
                                       labels.data_ptr(), best.data_ptr(), e,
                                       n, n, stream)
                assert code == 0, code
            # the fill of best is inside the interval for every entry alike
            rec[name] = statistics.median(samples_ms(run, flush))
        for name, fn in (("without_table", boruvka_round_without_table),
                         ("table", boruvka_round_cuda),
                         ("previous", previous_boruvka_round)):
            rec[name] = statistics.median(samples_ms(lambda: fn(*args),
                                                     flush))
        print(json.dumps(rec), flush=True)

    del el, valid, ident, round2, best
    profile_one_bag(flush)
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
