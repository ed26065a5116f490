#!/usr/bin/env python3
"""Where the scan-first-search frontier round's time goes on the card,
stage by stage.

    python3 tools/profile_frontier_round.py

Builds probe kernels that include ``src/repro_torch/csrc/
connectivity_rounds.cu`` and stop after one stage of the redesigned
round's work (``frontier_round_warp_kernel``'s layout: a persistent grid,
four slots per thread), at the bridge pipeline's shape (the paper's Fig. 2
point, 2^24 slots, n 131,072) on the ``frontier``/``visited`` sets of real
rounds of one SFS pass (``chip_smoke.py::sfs_rounds_plain``): the first,
the widest frontier, a thin one and the round that reaches the most
vertices. Each stage adds to the one before:

  1 loads      the mask word, and src and dst where it is not 0
  2 frontier   + frontier[gu] and frontier[gw] of every live slot
  3 visited    + visited of the candidate arcs' targets
  4 read_best  + each candidate arc reads best[target] (no atomic)
  5 atomics    + the 64-bit atomicMin where the key is smaller (the
                 kernel's min_into)

and two other forms of stage 1: ``loads_two_groups`` (each thread loads
two groups at once, both mask words first) and ``loads_unmasked`` (src and
dst read whatever the mask word says: no wait on it, but the padding's
bytes read too). They ask whether the loads are held by their bytes or by
the mask word's trip before them.

then the real kernels: the redesign (the ``frontier_round`` op) and the
first kernel with its split (``previous_frontier_round``). Every entry
fills ``best`` inside its interval, as the op does. Times are medians of
CUDA-event intervals taken in turns (``chip_smoke.py::time_turns``: L2
flushed and a device-side wait before each). Prints one JSON line per
round, with the round's candidate arcs, then the card's name and power
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
from repro_torch.core.api import pad_graph  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels.boruvka_round import frontier_round  # noqa: E402
from repro_torch.kernels.boruvka_round.kernel import (  # noqa: E402
    PACKED_INF,
    previous_frontier_round,
)

PROBE = r'''
#include "connectivity_rounds.cu"

namespace {
template <int kStage>
__global__ void __launch_bounds__(kThreads) probe_kernel(
    const int* __restrict__ src, const int* __restrict__ dst,
    const unsigned char* __restrict__ mask,
    const unsigned char* __restrict__ frontier,
    const unsigned char* __restrict__ visited, long long* best,
    long long n_vec, int n_nodes, int num_segments) {
  const long long thread =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  const int4* src4 = reinterpret_cast<const int4*>(src);
  const int4* dst4 = reinterpret_cast<const int4*>(dst);
  const unsigned* mask4 = reinterpret_cast<const unsigned*>(mask);
  long long acc = 0;
  if (kStage == 6) {  // the loads, two groups a thread in flight at once
    for (long long g = thread; g < n_vec; g += 2 * threads) {
      const long long h = g + threads;
      const unsigned ma = __ldcs(mask4 + g);
      const unsigned mb = h < n_vec ? __ldcs(mask4 + h) : 0u;
      int4 sa = make_int4(0, 0, 0, 0), da = sa, sb = sa, db = sa;
      if (ma) { sa = __ldcs(src4 + g); da = __ldcs(dst4 + g); }
      if (mb) { sb = __ldcs(src4 + h); db = __ldcs(dst4 + h); }
      acc ^= sa.x ^ sa.y ^ sa.z ^ sa.w ^ da.x ^ da.y ^ da.z ^ da.w;
      acc ^= sb.x ^ sb.y ^ sb.z ^ sb.w ^ db.x ^ db.y ^ db.z ^ db.w;
    }
  }
  if (kStage == 7) {  // the loads, src and dst read whatever the mask
    for (long long g = thread; g < n_vec; g += threads) {
      const unsigned m4 = __ldcs(mask4 + g);
      const int4 s4 = __ldcs(src4 + g);
      const int4 d4 = __ldcs(dst4 + g);
      acc ^= m4 ? s4.x ^ s4.y ^ s4.z ^ s4.w ^ d4.x ^ d4.y ^ d4.z ^ d4.w : 0;
    }
  }
  for (long long g = thread; kStage <= 5 && g < n_vec; g += threads) {
    const unsigned m4 = __ldcs(mask4 + g);
    if (!m4) continue;
    const int4 s4 = __ldcs(src4 + g);
    const int4 d4 = __ldcs(dst4 + g);
    if (kStage == 1) {
      acc ^= s4.x ^ s4.y ^ s4.z ^ s4.w ^ d4.x ^ d4.y ^ d4.z ^ d4.w;
      continue;
    }
    const int su[kVec] = {s4.x, s4.y, s4.z, s4.w};
    const int sw[kVec] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int u = su[k];
      const int w = sw[k];
      if (!((m4 >> (8 * k)) & 0xffu) || u == w) continue;
      const int gu = gather_index(u, n_nodes);
      const int gw = gather_index(w, n_nodes);
      const bool fu = __ldg(frontier + gu);
      const bool fw = __ldg(frontier + gw);
      if (kStage == 2) { acc += fu + 2 * fw; continue; }
      const bool cw = fu &&
          static_cast<unsigned>(w) < static_cast<unsigned>(num_segments) &&
          !__ldg(visited + gw);
      const bool cu = fw &&
          static_cast<unsigned>(u) < static_cast<unsigned>(num_segments) &&
          !__ldg(visited + gu);
      if (kStage == 3) { acc += cw + 2 * cu; continue; }
      const long long i = kVec * g + k;
      if (kStage == 4) {
        if (cw) acc ^= __ldcg(best + w);
        if (cu) acc ^= __ldcg(best + u);
        continue;
      }
      if (cw) min_into(best + w, arc_key(u, i));
      if (cu) min_into(best + u, arc_key(w, i));
    }
  }
  if (acc == 0x13572468) best[0] = acc;  // keeps the stages' work alive
}

template <int kStage>
int launch_stage(const int* src, const int* dst, const unsigned char* mask,
                 const unsigned char* frontier, const unsigned char* visited,
                 long long* best, long long e, int n_nodes, int num_segments,
                 cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                probe_kernel<kStage>,
                                                kThreads, 0);
  probe_kernel<kStage><<<sms * per_sm, kThreads, 0, s>>>(
      src, dst, mask, frontier, visited, best, e / kVec, n_nodes,
      num_segments);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

extern "C" int probe_stage(int stage, const int* src, const int* dst,
                           const unsigned char* mask,
                           const unsigned char* frontier,
                           const unsigned char* visited, long long* best,
                           long long e, int n_nodes, int num_segments,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 1: return launch_stage<1>(src, dst, mask, frontier, visited, best, e, n_nodes, num_segments, s);
    case 2: return launch_stage<2>(src, dst, mask, frontier, visited, best, e, n_nodes, num_segments, s);
    case 3: return launch_stage<3>(src, dst, mask, frontier, visited, best, e, n_nodes, num_segments, s);
    case 4: return launch_stage<4>(src, dst, mask, frontier, visited, best, e, n_nodes, num_segments, s);
    case 5: return launch_stage<5>(src, dst, mask, frontier, visited, best, e, n_nodes, num_segments, s);
    case 6: return launch_stage<6>(src, dst, mask, frontier, visited, best, e, n_nodes, num_segments, s);
    default: return launch_stage<7>(src, dst, mask, frontier, visited, best, e, n_nodes, num_segments, s);
  }
}
'''
STAGES = ("loads", "frontier", "visited", "read_best", "atomics",
          "loads_two_groups", "loads_unmasked")


def build_probe() -> ctypes.CDLL:
    out = cuda_lib.BUILD_DIR / "probe_frontier_round"
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe.cu").write_text(PROBE)
    so = out / "libprobe.so"
    subprocess.run([cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-shared",
                    "-I", str(cuda_lib.SOURCES[0].parent), "-o", str(so),
                    str(out / "probe.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    lib.probe_stage.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                                + [ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p])
    lib.probe_stage.restype = ctypes.c_int
    return lib


def round_counts(src, dst, valid, frontier, visited, n: int) -> dict:
    """What the round asks on these inputs: live slots with a frontier
    endpoint (each gathers ``visited``), candidate arcs (each reads
    ``best``), the vertices they reach, and the candidate arcs whose target
    equals the one of the slot four before (the previous lane's in the
    kernel's sub-step): the updates run leaders could save."""
    u, w = src.long(), dst.long()
    gu, gw = (torch.where(x < 0, x + n, x).clamp(0, n - 1) for x in (u, w))
    fu, fw = frontier[gu], frontier[gw]
    cw = valid & fu & (w >= 0) & (w < n) & ~visited[gw]
    cu = valid & fw & (u >= 0) & (u < n) & ~visited[gu]
    followers = 0
    for cand, target in ((cw, w), (cu, u)):
        t = torch.where(cand, target, -1)
        followers += int(((t >= 0) & (t == torch.roll(t, 4))).sum())
    return {"frontier": int(frontier.sum()),
            "slots_at_frontier": int((valid & (fu | fw)).sum()),
            "candidate_arcs": int(cw.sum() + cu.sum()),
            "reached": int(torch.unique(torch.cat([w[cw], u[cu]])).numel()),
            "followers": followers}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_frontier_round: no CUDA device", file=sys.stderr)
        return 2
    lib = build_probe()
    src, dst, _ = gen.planted_bridge_graph(smoke.N_NODES, smoke.N_EDGES,
                                           smoke.N_BRIDGES, seed=smoke.SEED)
    el = pad_graph(src, dst, smoke.N_NODES)
    n, e = el.n_nodes, el.capacity
    valid = el.mask & (el.src != el.dst)
    for t in (el.src, el.dst, valid):
        assert t.data_ptr() % 16 == 0 and e % 4 == 0
    rounds = smoke.sfs_rounds_plain(el)
    sizes = [int(f.sum()) for f, _ in rounds]
    later = range(1, len(rounds) - 1) or range(1)
    picks = {"first": 0,
             "widest": max(later, key=sizes.__getitem__),
             "thin": min(later, key=sizes.__getitem__),
             "most_reached": max(range(len(rounds) - 1) or range(1),
                                 key=lambda i: sizes[i + 1])}
    stream = torch.cuda.current_stream().cuda_stream
    best = torch.empty(n, dtype=torch.int64, device="cuda")
    flush = torch.empty(smoke.L2_FLUSH_BYTES, dtype=torch.uint8,
                        device="cuda")
    print(json.dumps({"sfs_rounds": len(rounds), "frontier_sizes": sizes}),
          flush=True)
    for tag, i in picks.items():
        frontier, visited = rounds[i]
        args = (el.src, el.dst, valid, frontier, visited, n)
        fns = {}
        for stage, name in enumerate(STAGES, start=1):
            def run(stage=stage):
                best.fill_(PACKED_INF)
                code = lib.probe_stage(stage, el.src.data_ptr(),
                                       el.dst.data_ptr(), valid.data_ptr(),
                                       frontier.data_ptr(),
                                       visited.data_ptr(), best.data_ptr(),
                                       e, n, n, stream)
                assert code == 0, code
            fns[name] = run
        fns["redesign"] = lambda: frontier_round(*args)
        fns["previous"] = lambda: previous_frontier_round(*args)
        rec = {"round": tag, "index": i, "E": e, "n": n,
               **round_counts(*args[:5], n),
               **smoke.time_turns(fns, flush)}
        print(json.dumps(rec), flush=True)
    print(smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
