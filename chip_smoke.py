#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each:

1. build   — compile the CUDA kernels from ``src/repro_torch/csrc`` with
             nvcc for sm_90a; nvcc's time and ptxas's register/spill lines.
2. kernels — each kernel against its plain PyTorch version on the card, at
             the main path's shapes, bit for bit (tolerance 0: integer
             outputs); kernel, plain and library times with CUDA events
             (warm-up, L2 flushed and a device-side wait queued before
             every timed launch) beside the bound.
             The Borůvka round at both label sets (identity, round 2) also
             through the first kernel (``previous_kernel_ms``) and without
             its per-block table, both held bit for bit too, and the
             updates each design asks of ``best``. The frontier round on
             every round of one SFS pass, through the redesigned kernel
             and the first one, bit for bit, both timed in turns at four
             picked rounds and over the pass. ``segment_min`` through the
             op (one cooperative launch), the same body after a separate
             fill and the first kernel, each split under the profiler into
             fill, gap and body.
3. main    — ``repro_torch.find_bridges`` on the paper's Fig. 2 operating
             point (|V| = 100,000, |E| = 10,000,000, six planted bridges)
             with ``final="device"`` and ``final="host"``, each twice (cold,
             then warm), each run with the launch counts set to 0 just
             before it and read just after; then one warm device-final
             call under torch.profiler for the device's busy share and
             time by kernel.
4. analyze — ``repro_torch.analyze`` at the same point for every kind with
             both finals, and ``cuts``/``bcc`` with ``final="host"`` under
             both vertex certificates (``sfs``, ``hybrid``): cold and warm
             walls, launches per kernel (counts set to 0 just before each
             run), host syncs in round loops, peak device memory, each
             answer held against the planted truth; then each of those
             pipelines stage by stage (wall seconds per stage, rounds per
             certificate pass) and ``cuts`` with either final under
             torch.profiler; then the summed device time of a redesigned
             kernel's launches over one warm call, with the redesigned
             kernel and with the first one in its place: the Borůvka round
             in ``find_bridges(final="device")`` and in
             ``analyze(kind="cuts", final="host")``, the frontier round in
             the latter, ``segment_min`` in the former.
5. check   — small worlds on the card against the host oracles and the
             planted truth, every kind and final; the pipeline of every
             (kind, final, certificate) the registry allows on the card
             against the same pipeline on the CPU, buffer for buffer.
5b. distributed — the paper's merge across machines at the same point:
             the graph partitioned with seed 0 into M = 8 shard rows of
             2^21 slots, stacked [8, 2^21] on the card; the host
             simulator (``certify_shards`` then ``simulate_merge_host``,
             every certificate built on the card) for ``paper``, ``xor``
             and ``hierarchical`` (2 x 4) x ``bridges`` (``2ec``) and
             ``cuts`` (``sfs``), once cold then three times warm with the
             launch counts set to 0 just before each run and read just
             after: the median warm run's wall, local certificates' and
             each ``merge/level{q}`` span's seconds, launches, host syncs
             in round loops, peak device bytes; machine 0's answer (and
             machine 7's under ``xor``/``hierarchical``) with both finals
             against the planted truth. Then one warm ``paper``/
             ``bridges`` merge under torch.profiler; the same split for
             ``paper``/``bridges`` at M = 1, 2, 4, 8; the three
             connectivity kernels bit for bit against their plain
             versions on a shard row (views into the stacked buffers),
             one phase's 399,996-slot union and the answering machine's
             199,998-slot certificate, ``segment_min`` also at the inputs
             the pipeline hands it there; and the process-group program
             in a one-rank NCCL group on a one-dim ``DeviceMesh``:
             ``find_bridges(..., mesh=...)`` with both finals against the
             planted truth and the program's buffers against the
             simulator's at M = 1 (no phase, so no exchange: counted).
5c. engine — the engine (``repro_torch.engine.BridgeEngine``) at the same
             point. The live graph: ``load`` of the Fig. 2 graph (2^24
             full-buffer slots, the 2ec certificate eager), then 8
             ``insert_edges`` of 4,096 random edges (each inside one planted
             blob, so the bridges stay bridges) and 8 ``delete_edges``
             of 1,024 keys, alternating, the deletions alternately from
             edges of no live certificate (the free path) and with one 2ec
             certificate edge and one planted bridge (the rebuild path);
             after each op ``bridges`` (the op's answer) and ``cuts``
             (``current_analysis``: the first materializes sfs), once
             ``cuts`` under ``hybrid``; the whole sequence twice, cold
             (every answer against the one-shot pipeline run from scratch on
             the host's copy of the live edge multiset) then warm (the same
             answers): per op the walls, launches, host syncs, live and
             peak live bytes, peak device bytes and the certificates
             rebuilt, and the engine's ``snapshot()``. The batched point:
             8 planted graphs of 12,500 vertices and 1.25 M edges, each
             padded to 16,384 vertices and 2^21 slots (the union: 131,072
             and 2^24), through ``analyze_batch`` and through 8 sequential
             ``analyze`` calls (``bridges`` with either final, ``cuts``
             host, ``bridges`` with per-row deletions), every row against
             its planted truth. The three connectivity kernels bit for bit
             at the engine's shapes, recorded off the real calls: the warm
             fold's rounds over the 4,096-slot delta, the rescan folds'
             rounds over certificate ∪ delta (266,238 slots), the live
             final's ``segment_min``, the union's first Borůvka round and
             every SFS round of the batched ``cuts`` query. One-shot
             ``analyze(delete=)`` twice (the second a cache hit), and
             ``BridgeEngine(mesh=...)`` on a one-rank NCCL group with
             ``delete=`` twice against ``simulate_churn_host``.
5d. streaming — streaming ingest at the same point, on one engine, cold
             then warm: the one-shot ``load`` and every kind (the one-shot
             live and peak live bytes); ``load_stream`` of the same edges
             with 2^20-slot chunks, fed in steps of 1,500,000 edges (not a
             multiple of the bucket), then every kind and ``cuts`` under
             ``hybrid`` (the lazy certificates replay the ring), each
             against the planted truth; one ``delete_edges`` of 1,024 keys
             with a live 2ec certificate edge among them (a ring
             tombstone, then a replay of each hit certificate) against the
             host oracle; a second loop of 3,000,000 edges inside the
             planted blobs that must build no program; every kind again
             (cold: against the one-shot pipeline on the host's copy of
             the live edges). Per step: seconds, ingest edges per second,
             the ``ingest`` counters, live and peak live bytes, launches,
             round-loop syncs, programs built. The three kernels bit for
             bit at the chunk shapes, off the warm run's recorded calls.
5e. streaming_sharded — ``simulate_stream_merge_host`` at M = 8,
             ``paper``: every shard row streamed through its own 2^20-slot
             chunks, then the merge levels, for ``bridges`` (``2ec``) and
             ``cuts`` (``sfs``), cold then warm; machine 0's answer with
             both finals against the planted truth.
5f. repairs — ids outside ``[0, n)`` through ``analyze`` with the device
             final (every kind) and batches with a row outside the
             batch's bucket through ``analyze_batch`` (every kind x
             final), each answer against the JAX package's, written in the
             script (``REPAIR_*``); a device-side assert fails the run.
5g. scheduler — ``benchmarks/fig10_serving.py``'s fixed submission script
             through ``BridgeScheduler(max_batch=8)`` on a fresh engine and
             registry: 4 tenants x 6 requests, request i a planted graph of
             12,500 - i % 7 vertices and 1,250,000 edges (one admission
             bucket, so a full dispatch is a 2^24-slot union); the
             power-of-two warmup (1, 2, 4, 8), the sequential loop,
             everything submitted then drained, the ragged waves 5, 3, 1,
             7, a churn turn of 4 reads and 4 writes on request 0's live
             graph (4,096-edge inserts inside the blobs, 1,024-key
             deletions of non-bridge edges); then a wave of ``cuts`` reads
             with the host final. Seconds per query sequential and
             scheduled, worst and best tenant p99, the counters (held equal
             to fig10's pinned ``dispatches=12 coalesced=59 padded=5
             writes=4 occupancy_x100=492``), programs built after warmup
             (held at 0), launches, peak bytes; every ticket against its
             planted truth. Then one full dispatch's kernel calls bit for
             bit (``scheduler_kernel_check``).
5h. checkpoint — the live Fig. 2 graph with ``enable_checkpoints(every=2)``
             in a temporary directory: ``load``, 4 inserts of 4,096 edges
             (2 cadence saves), ``checkpoint_now``, one drifting insert,
             ``restore_live`` cold then warm (held: no program run, cache
             keys unchanged, arrays on the card, the snapshot's answer),
             then 3 inserts that build nothing. Bytes per save, save,
             restore and write seconds, the policy's counters.
5i. failover — ``benchmarks/fig11_failover.py``'s drills on the Fig. 2
             graph's M = 8 shard rows: ``simulate_failover_host`` under
             ``paper`` with no kill, and with machine 0 killed at phase
             boundary 1 recovered from per-boundary snapshots in a disk
             ``MachineCheckpoints`` or by re-certifying its shard, for
             ``bridges`` (``2ec``) and ``cuts`` (``sfs``), cold then warm:
             walls, ``merge/*`` and ``recover/*`` span seconds, launches,
             peak bytes, the info dict (held equal to the one the port gives
             on the CPU for a small graph), the answering certificate's
             device-final answer against the planted truth and every
             survivor's certificate equal to it. Then one recovery fold's
             and one re-merge level's kernel calls bit for bit
             (``failover_kernel_check``).
5j. failover_drill — ``launch.failover.serve_failover``: 8 machines, 6
             steps, machine 1 killed at step 2, snapshots every step, n =
             100,000 with 1,000,000 edges (cut from 10 M: the drill checks
             every step by a host Tarjan over every live edge), 4,096-edge
             writes a step. Held: final parity, no post-recovery parity
             failure, recovery from the checkpoint, each counter delta 1.
5k. serve_driver — ``launch/serve_bridges.py::main(argv, device="cuda")``
             in-process with ``--verify``, once per workload: at the CLI's
             own defaults (n 512, 8,192 edges, 64 queries, batch 8):
             ``insert`` and ``churn`` with ``--analysis all``, then
             ``multitenant`` (4 tenants, 16 deltas, all at t = 0); at the
             full serving width (the scheduler phase's 12,500 x 1,250,000,
             6 queries, batch 8: one 2^21-slot bucket that the jitter stays
             inside) ``multitenant`` and ``insert --analysis all``, and
             ``multitenant`` once more without ``--verify``, whose walls,
             speedup and tenant p99 then hold no host Tarjan; and
             ``ingest`` at the Fig. 2 point (``configs/bridges_dense.py::
             CONFIG``) with 2^20-edge chunks. One line per run: the report's
             counters (programs, hits, misses, traces, warm retraces, the
             scheduler rollup, the ingest counters, rebuilds, peak live
             bytes), its walls and rates (per-kind qps, p50/p95/p99,
             speedup, edges per second) and the launches per kernel (counts
             set to 0 just before the run and read just after). The kernel
             calls of three verified runs are recorded and held bit for bit
             against the plain versions (``serve_driver_kernel_check``):
             the defaults' ``multitenant`` run's last (the scheduler
             phase's), and the first calls of every (slots, n) shape of the
             defaults' and the width's ``insert --analysis all``, which
             launch all three connectivity kernels; each kernel a recorded
             run launched must be held. The card's report at ``--smoke
             --analysis all`` equals the port's on the CPU without the
             clock's values (``serve_driver_hold``; the clock-free view is
             ``tests/torch_serve_report.py``'s, shared with the CPU parity
             tests, so this phase needs the checkout's ``tests/``).
5l. baseline — the paper's Fig. 5 point (``benchmarks/fig5_baseline.py``:
             V 128, E 256 / 1,024 / 4,096 / 8,128, ``random_graph(...,
             seed=3)``): the Savage-Ja'Ja' dense-matrix baseline
             (``core/baseline_savage_jaja.py``) against ``find_bridges(...,
             final="device")`` and the host Tarjan, as sets of pairs, and at
             E = 256 mask for mask against the baseline on the CPU; warm
             times (median of 5 after a warmup) of the baseline, of Fig. 5's
             own pipeline (``bridges_device(sparse_certificate(el))``) and
             of ``find_bridges``; the baseline's peak bytes and its
             ``boruvka_round`` launches; at E = 8,128 its ``boruvka_round``
             calls held bit for bit against the plain version
             (``baseline_kernel_check``).
6. model kernels — ``embedding_bag`` on SASRec's full-width item table
             (2^20 x 50 float32) at the retrieval step's shape (one bag of
             50) and at the train batch's (65,536 bags of 50), every mode,
             the first kernel timed beside it (``previous_kernel_ms``) and
             an empty kernel's launch (``launch_floor_ms``); then the sweep
             of the block kernel against the first one over 1 .. 65,536
             bags that sets the threshold between them;
             ``flash_attention`` at Qwen3-0.6B's attention widths, causal:
             in bf16 (the tensor-core kernel ``flash_attention_mma``) a cut
             prefill and a cut decode, in float32 (the 3xTF32 tensor-core
             kernel ``flash_attention_tf32x3``) the same prefill and one
             small case. Each against its plain version (rtol 1e-5 with
             atol 1e-6 in float32 for the bags; attention by a gate that
             scales with the output, ``ops.ATTN_GATES``, shown to reject
             two planted faults; TF32 off), with kernel, plain and library
             times beside the bound; every case also runs the first,
             float32-core kernel (``csrc/flash_attention.cu``) through its
             entry, under the same gate, as a timed yardstick. Then one flash_attention op call per kernel
             (bf16 prefill, float32 prefill) with the launch counts set to
             0 just before and read just after.
7. recsys  — SASRec serving at full width (``configs/sasrec.py::CONFIG``,
             weights from ``init_sasrec`` with a seeded generator):
             ``make_recsys_steps``' serve (B = 512), bulk (B = 32,768,
             k = 100, 64 chunks) and retrieval (one history of 50 against
             10^6 candidates) steps, each cold then warm with the launch
             counts set to 0 just before and read just after; the hidden
             states against the CPU, bulk's top-k against the full scores'
             top-k, retrieval against the CPU; each step under
             torch.profiler.
8. training — SASRec training at full width from the same weights:
             ``make_recsys_steps(CONFIG)["train"]`` (loss, autograd,
             AdamW, the cosine schedule) three steps at B = 1,024 on the
             card and on the CPU, loss, grad_norm, lr, every param and
             state leaf held (``sasrec_train_check``); then train_batch's
             B = 65,536 x S = 50, a cold step and five warm ones (seconds,
             tokens/s, loss, grad_norm, lr, peak bytes, launches: none of
             the five kernels is on this path) and one warm step under
             torch.profiler (``sasrec_train``, ``sasrec_train_summary``).
9. recsys_mesh — SASRec's multi-card branches on a one-rank NCCL
             ``DeviceMesh`` (1, 1) ``("data", "model")``, the weights placed
             by ``reshard_checkpoint``: bulk and retrieval against the
             meshless steps bit for bit (the mesh retrieval's
             ``embedding_bag`` launch counted), ``compressed_psum_tree`` on
             one rank against compress then decompress.
10. language model — the dense decoder (``models/transformer.py``) at
             full width, TF32 off and bf16 products summed in full float32
             (``allow_bf16_reduced_precision_reduction`` off: the
             reference's dots accumulate in float32). ``lm_check``:
             Qwen3-0.6B from one set of weights on the card and on the CPU,
             float32 and its bfloat16 rounding, the prefill step on 4 x 16
             seeded tokens then 8 decode steps fed the card's greedy
             tokens; every step's logits and the cache within
             ``LM_CHECK_TOL``, and the first step whose greedy tokens
             differ (a reading). ``lm_serve``: ``launch/serve.py::main`` at
             its CLI defaults (B 4, prompt 16, 32 greedy tokens) for
             Qwen3-0.6B, Qwen3-14B (40 q heads padded to 48) and
             StableLM-12B (d_head 160, no qk norm) in bf16, one model at a
             time: prefill ms, decode tokens/s, parameter and peak bytes.
             ``lm_prefill``: the prefill step at prefill_32k's S = 32,768,
             batch cut to 1, cold and warm, then one warm call under
             torch.profiler (device events only). ``lm_decode``: 16 greedy
             decode steps at B = 8 (decode_32k's 128 cut) against a
             32,768-row cache of seeded values, each step's seconds beside
             the byte bound (cache and parameters read once), one step
             under torch.profiler. ``lm_phases``: their seconds. Every
             line carries the card's name and power limit and the five
             kernels' launch counts, held at 0: the path reaches none.
11. language-model training and the mixture of experts — as in 10.
             ``lm_train_check``: one ``make_lm_train_step`` step of
             Qwen3-0.6B at full width in float32 (B 2 x S 32) on the card
             and on the CPU from one set of weights and one AdamW state
             (random moments, the counter at the warmup): loss,
             grad_norm, lr and every param, master, m and v leaf within
             ``LM_TRAIN_CHECK_TOL``. ``lm_train``:
             ``launch/train.py::train`` at Qwen3-0.6B's full width in bf16
             on train_4k's S = 4,096 (batch 256 cut to 8): a cold step and
             five warm (seconds, tokens/s, peak bytes, printed lines), one
             warm step under torch.profiler (device events only), one
             timed in halves (``lm_train_optimizer``: the gradient against
             AdamW's update). ``lm_train_restart``: the crash drill of
             ``launch/train.py::main`` at ``--smoke`` (30 steps; killed at
             17 with exit 17, restarted from 10; the same ``final_loss``).
             ``moe_check``: one layer's ``moe_ffn_local`` at Qwen3-MoE's
             and DBRX's full widths in bf16 on 64 tokens, card against CPU
             (tokens routed differently counted; the rest within
             ``MOE_CHECK_TOL``). ``moe_mesh``: ``make_moe_layer`` on a
             one-rank NCCL (1, 1) mesh against the meshless layer, bit for
             bit. ``moe_serve``: ``launch/serve.py::generate`` for both at
             full width with 4 layers (B 4, prompt 16, 32 greedy tokens).
             ``moe_train``: one donated train step of Qwen3-MoE at full
             width with 1 layer (B 2 x S 4,096), cold and warm, with its
             capacity drops. ``lm_train_phases``: their seconds. Every
             line holds the five kernels' launch counts at 0.
12. graph networks and pipeline parallelism — ``gnn_check``: one
             ``make_gnn_train_step`` step of each GNN smoke config (egnn
             also ``batched``, GraphSAGE also ``sampled``) on the card and
             on the CPU from one set of weights and an AdamW state past the
             warmup, every leaf within ``GNN_CHECK_TOL``. ``gnn_sampled``:
             GraphSAGE at minibatch_lg on a synthetic multigraph of its
             232,965 nodes and 114,615,892 edges, ``NeighborSampler``'s CSR
             build, then a host batch and a card step, cold and five times
             warm (seconds, seeds/s, peak bytes); ``gnn_sampled_idle``:
             the batch's copy to the card timed by events and a step on
             the copied batch under torch.profiler, the card's idle share
             over one iteration. ``gnn_full``: GraphSAGE at ogb_products
             (2,449,029 nodes, 61,859,140 edges), PNA and GatedGCN at
             full_graph_sm, EGNN at molecule (128 graphs), cold and three
             warm steps (seconds, edges/s, peak bytes); the cold step of
             the last three held against the CPU, GraphSAGE's config on a
             cut of 600,008 edges over five ``EDGE_CHUNK``s
             (``GNN_CHECK_TOL``). ``pp``:
             Qwen3-0.6B through ``make_pp_loss_fn`` with one stage on a
             one-rank NCCL ``("pipe", "data")`` mesh, 4 x 2 x 4,096
             tokens: the loss against the mean ``lm_loss``, every gradient
             leaf against ``lm_loss``'s over the same tokens as one batch
             (``PP_CHECK_TOL``), then cold and warm ``make_pp_train_step``
             steps (tokens/s, peak bytes). ``gnn_pp_phases``: their
             seconds. Every line holds the five kernels' launch counts at 0.

Then the card's name and power limit (nvidia-smi), the kernels line, and
last ``{"ok": true, "device": {...}}``. Any failure raises: the script then
exits non-zero and prints no result. Without a card it exits 2.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import gc
import io
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
#: the serving report's clock-free view (``torch_serve_report.py``) and the
#: GNN card-against-CPU cases (``torch_gnn_cases.py``), shared with the
#: tests; they import neither torch nor JAX
sys.path.append(str(Path(__file__).resolve().parent / "tests"))

from repro_torch import analyze, find_bridges
from repro_torch.connectivity.common import tour_state
from repro_torch.connectivity.registry import analysis_kinds, get_analysis
from repro_torch.core import merge as merge_mod
from repro_torch.core.api import (
    MIN_BUCKET,
    masked_arrays,
    pad_graph,
    resolve_certificate,
)
from repro_torch.core.baseline_savage_jaja import (
    bridges_savage_jaja,
    chunk_slots,
    closure_squarings,
)
from repro_torch.core.bridges_device import bridges_device
from repro_torch.core.bridges_host import bridges_dfs
from repro_torch.core.certificate import (
    certificate_capacity,
    hybrid_certificate_ex,
    sfs_certificate_ex,
    sparse_certificate,
    sparse_certificate_ex,
)
from repro_torch.core.certs import certificate_builder, certificate_names
from repro_torch.core.forest import _sfs_impl, hook_round, spanning_forest_ex
from repro_torch.checkpoint import MachineCheckpoints
from repro_torch.core.merge import (
    SCHEDULES,
    build_distributed_analysis_fn,
    certify_shards,
    merge_phase_plan,
    simulate_churn_host,
    simulate_failover_host,
    simulate_merge_host,
    simulate_stream_merge_host,
)
from repro_torch.core.partition import partition_edges
from repro_torch.engine import BridgeEngine, BridgeScheduler
from repro_torch.engine.batched import make_analysis_fn
from repro_torch.graph import generators as gen
from repro_torch.graph.datastructs import (
    INF32,
    INT,
    EdgeList,
    admission_capacity,
    compact_edges,
    concat_edges,
)
from repro_torch.kernels import (
    cuda_lib,
    launch_counts,
    reset_launch_counts,
)
from repro_torch.kernels.boruvka_round import (
    boruvka_round,
    boruvka_round_bytes,
    frontier_round,
    frontier_round_bytes,
)
from repro_torch.kernels.boruvka_round import ops as boruvka_ops
from repro_torch.kernels.boruvka_round.kernel import (
    PACKED_INF,
    boruvka_round_without_table,
    previous_boruvka_round,
    previous_frontier_round,
)
from repro_torch.kernels.boruvka_round.ref import (
    boruvka_round_ref,
    frontier_round_ref,
)
from repro_torch.configs import GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES
from repro_torch.configs import get as lm_get
from repro_torch.configs.bridges_dense import CONFIG as BRIDGES_DENSE
from repro_torch.configs.sasrec import CONFIG as SASREC
from repro_torch.data.pipeline import SyntheticTokens, recsys_batches
from repro_torch.data.sampler import NeighborSampler
from repro_torch.kernels.embedding_bag import (
    embedding_bag,
    embedding_bag_bytes,
    embedding_bag_bytes_read,
)
from repro_torch.kernels.embedding_bag.kernel import (
    BLOCK_ITEMS_MAX,
    block_embedding_bag,
    launch_floor,
    previous_embedding_bag,
)
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.flash_attention import (
    ATTN_GATES,
    attention_bytes,
    attention_flops,
    attention_gate,
    flash_attention,
)
from repro_torch.kernels.flash_attention.kernel import (
    KERNEL_OF,
    float32_core_kernel,
)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.segment_min import kernel_path, segment_min
from repro_torch.kernels.segment_min import ops as segment_min_ops
from repro_torch.kernels.segment_min.kernel import (
    filled_segment_min,
    previous_segment_min,
)
from repro_torch.kernels.segment_min.ref import segment_min_ref
from repro_torch.launch import serve_bridges
from repro_torch.launch.failover import serve_failover
from repro_torch.checkpoint import reshard_checkpoint
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.gnn import GNNConfig
from repro_torch.models.pipeline import (
    PipelineConfig,
    make_pp_loss_fn,
    make_pp_train_step,
    stageify_params,
)
from repro_torch.models.recsys import init_sasrec, param_specs, sasrec_hidden
from repro_torch.models.transformer import Parallelism
from repro_torch.models.transformer import init_cache as lm_init_cache
from repro_torch.models.transformer import init_params as lm_init
from repro_torch.models.transformer import lm_loss
from repro_torch.launch import serve as serve_lm
from repro_torch.launch import train as train_lm
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    compress_int8,
    cosine_schedule,
    decompress_int8,
)
from repro_torch.optim.compression import compressed_psum_tree
from repro_torch.optim.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.obs import (
    MetricsRegistry,
    disable_tracing,
    enable_tracing,
    get_tracer,
)
from repro_torch.runtime import FailureInjector
from repro_torch.training.steps import (
    make_gnn_train_step,
    make_lm_decode_step,
    make_lm_prefill_step,
    make_lm_train_step,
    make_recsys_steps,
)
from torch_gnn_cases import GNN_CHECK_CASES, GNN_CHECK_TOL, gnn_batch
from torch_serve_report import clock_free

#: the paper's Fig. 2 operating point (configs/bridges_dense.py::CONFIG)
N_NODES, N_EDGES = BRIDGES_DENSE.n_nodes, BRIDGES_DENSE.n_edges
N_BRIDGES, SEED = 6, 0
#: H100 SXM device-memory rate (NVIDIA data sheet), bytes per second
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet), per second
BF16_FLOPS_PER_S = 989e12
#: H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12
#: H100 SXM dense TF32 tensor-core rate (NVIDIA data sheet), per second:
#: exact float32 work there costs three TF32 products per product (3xTF32)
TF32_FLOPS_PER_S = 494.7e12
L2_FLUSH_BYTES = 256 << 20
#: a device-side spin (about 0.11 ms on an H100) queued between the L2
#: flush and a timed interval's start event: the host has queued the timed
#: launch before the card reaches the start, so the interval holds device
#: time and not the host's dispatch (which made one smoke run time the
#: one-bag embedding_bag op at 0.024 ms against 0.0085 in the others)
WAIT_CYCLES = 200_000
SOURCE = "src/repro_torch/csrc/connectivity_rounds.cu"
#: SASRec serving shapes: serve_p99's batch; serve_bulk's batch cut from
#: 262,144 to 32,768 (smoke time and peak memory; each chunk's scores are
#: 2.1 GB either way); retrieval_cand's one user and 10^6 candidates
SERVE_BATCH = RECSYS_SHAPES["serve_p99"]["batch"]
BULK_BATCH = 32_768
N_CANDIDATES = RECSYS_SHAPES["retrieval_cand"]["n_candidates"]
#: SASRec training: train_batch's batch; the card-against-CPU check's
#: batch and steps; the warm steps timed after the cold one
TRAIN_BATCH = RECSYS_SHAPES["train_batch"]["batch"]
TRAIN_CHECK_BATCH, TRAIN_CHECK_STEPS = 1024, 3
TRAIN_WARM_STEPS = 5
#: the train check's tolerances. Loss, grad_norm and lr: relative. Each
#: element of a leaf: against the leaf's largest magnitude, params and
#: master besides by a share of the lr summed over the steps (AdamW's
#: normalised step on an element whose gradient nearly cancels:
#: tests/test_torch_training.py). The card's and the CPU's float32 sums
#: round differently, and a ReLU pre-activation within rounding of 0 takes
#: the other side of the kink on one device: the users' gradients through
#: that unit then differ by its whole term (both are float32 roundings of a
#: gradient that jumps there; about one user a step at B = 1,024). A user's
#: term is about 1/sqrt(B) of a dense leaf's gradient: one such flip moved
#: dense leaves' moments by up to 1.3e-3 of the leaf's largest magnitude
#: (tools/profile_sasrec_train.py), where rounding alone stays near 1e-6,
#: hence the leaf tolerance of 1e-2; the table rows of that user differ by
#: more, hence the share of a leaf's elements that may lie outside.
TRAIN_SCALAR_RTOL, TRAIN_LEAF_TOL, TRAIN_LR_SHARE = 1e-5, 1e-2, 0.01
TRAIN_OUTSIDE_SHARE = 1e-4
#: attention widths of the JAX package's configs/qwen3_0_6b.py (16 query
#: heads, 8 kv heads, head size 128); lengths cut as each case says
ATTN_HEADS, ATTN_KV_HEADS, ATTN_DIM = 16, 8, 128
#: the (kind, final, certificate) runs of the analyze phase: every kind with
#: both finals under its declared certificate, and the vertex kinds' host
#: final under the other vertex certificate too (their device final runs
#: on the full buffer and builds no certificate)
ANALYZE_RUNS = [(kind, final, None)
                for kind in ("bridges", "cuts", "2ecc", "bridge_tree", "bcc")
                for final in ("device", "host")]
ANALYZE_RUNS += [("cuts", "host", "hybrid"), ("bcc", "host", "hybrid")]
#: the distributed phase: M machines (``hierarchical`` on a rows x cols
#: grid), the kinds it merges with their certificates, the M of the scaling
#: sweep
DIST_MACHINES, DIST_GRID = 8, (2, 4)
DIST_KINDS = {"bridges": "2ec", "cuts": "sfs"}
DIST_SCALING = (1, 2, 4, 8)
#: warm runs of each simulated merge, after one cold run: the line keeps
#: the median's split (host-bound runs vary between runs)
DIST_WARM_RUNS = 3
#: the engine phase: live churn of ENGINE_OPS inserts of ENGINE_INSERT
#: random edges and ENGINE_OPS deletions of ENGINE_KEYS keys at the Fig. 2
#: point; the batched point, ENGINE_BATCH planted graphs of BATCH_N
#: vertices and BATCH_E edges, each padded to 16,384 vertices and 2^21
#: slots, so that their union is the Fig. 2 point's 131,072 and 2^24
ENGINE_OPS, ENGINE_INSERT, ENGINE_KEYS = 8, 4096, 1024
ENGINE_BATCH, BATCH_N, BATCH_E = 8, 12_500, 1_250_000
#: the run whose launches the kernels line reports, per kernel
LAUNCHES_FROM = {"boruvka_round": "find_bridges(final='device')",
                 "segment_min": "find_bridges(final='device')",
                 "frontier_round": "analyze(kind='cuts', final='host')",
                 "embedding_bag": "retrieval",
                 "flash_attention_mma": "flash_attention(prefill)",
                 "flash_attention_tf32x3": "flash_attention(prefill_f32)"}


#: the op module and wrapper of each kernel whose first kernel the path
#: phase swaps in, that first kernel, and the runs whose device time of it
#: the phase sums
PATH_SWAPS = {
    "boruvka_round": (boruvka_ops, "boruvka_round_cuda",
                      previous_boruvka_round,
                      ("find_bridges(final='device')",
                       "analyze(kind='cuts', final='host')")),
    "frontier_round": (boruvka_ops, "frontier_round_cuda",
                       previous_frontier_round,
                       ("analyze(kind='cuts', final='host')",)),
    "segment_min": (segment_min_ops, "segment_min_cuda",
                    previous_segment_min,
                    ("find_bridges(final='device')",)),
}
#: kernels an op launches beside its own, summed with it in the profile:
#: the first frontier kernel's split into best_p and best_e
EVENTS_BESIDE = {"frontier_round": ("unpack_pairs",)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn()`` over ``iters`` launches, each
    after an L2 flush (a write of 256 MB) and a device-side wait
    (``WAIT_CYCLES``), both outside the timed interval."""
    return time_turns({"fn": fn}, flush, iters, warmup)["fn"]


def time_turns(fns: dict, flush, iters: int = 20, warmup: int = 3) -> dict:
    """The median CUDA-event time of each function of ``fns`` (name ->
    function) over ``iters`` launches, each after an L2 flush and a
    device-side wait, both outside the timed interval; taken in turns, each
    round timing every function once, the first of a round rotating, so
    that drift of the card's clocks falls on all alike."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    sync()
    names = list(fns)
    times = {name: [] for name in names}
    for i in range(iters):
        for name in names[i % len(names):] + names[:i % len(names)]:
            flush.zero_()
            torch.cuda._sleep(WAIT_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name]()
            end.record()
            sync()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype differ: {a.shape}/{a.dtype} vs "
                             f"{b.shape}/{b.dtype}")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def require_equal(name: str, a: torch.Tensor, b: torch.Tensor) -> int:
    err = max_abs_err(a, b)
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version, max abs err {err}")
    return err


# ----------------------------------------------------------------- phases
def phase_build() -> dict:
    info = cuda_lib.build(force=True)
    cuda_lib.library()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if re.search(r"registers|spill|Compiling entry", ln)]
    rec = {"phase": "build", "nvcc_s": info["seconds"],
           "flags": " ".join(cuda_lib.NVCC_FLAGS), "ptxas": ptxas}
    emit(rec)
    return rec


def boruvka_updates(src, dst, valid, labels, n: int) -> dict:
    """What one Borůvka round asks of ``best`` on these inputs (endpoints
    in range, as on the path): the cross slots, the (slot, side) updates
    one thread per slot makes (the first kernel), and the updates left to
    the redesign's run leaders. There each warp step takes 128 slots in
    four sub-steps of 32 lanes, lane l on slot 4l + k; a slot's sides are
    the labels of its smaller and larger endpoint; a lane leads where its
    label differs from the previous lane's."""
    lo = labels[torch.minimum(src, dst).long()]
    hi = labels[torch.maximum(src, dst).long()]
    cross = valid & (lo != hi)
    lane = (torch.arange(src.numel(), device=src.device) % 128) // 4
    updates, leaders, hit = 0, 0, []
    for side in (lo, hi):
        side = torch.where(cross & (side >= 0) & (side < n), side, -1)
        prev = torch.roll(side, 4)
        updates += int((side >= 0).sum())
        leaders += int(((side >= 0) & ((lane == 0) | (side != prev))).sum())
        hit.append(side[side >= 0])
    return {"cross_slots": int(cross.sum()), "updates_per_slot": updates,
            "updates_by_run_leaders": leaders,
            "labels_updated": int(torch.unique(torch.cat(hit)).numel())}


def phase_kernels(el, flush) -> dict:
    """Every kernel at the main path's shapes against its plain version."""
    n = el.n_nodes
    e = el.capacity
    valid = el.mask & (el.src != el.dst)  # what the forest passes each round
    ident = torch.arange(n, dtype=INT, device=el.device)
    round2, _, _ = hook_round(el.src, el.dst, valid, ident, n)
    n_valid = int(valid.sum())
    b_bytes = boruvka_round_bytes(e, n, n_valid)
    b_rec = {"name": "boruvka_round", "route": "cuda",
             "path": kernel_path(el.device), "source": SOURCE,
             "replaces": "src/repro/kernels/boruvka_round/kernel.py:144",
             "shape": {"E": e, "n": n, "valid_slots": n_valid},
             "bound_ms": b_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
             "bound_bytes": b_bytes, "library_ms": None,
             "library_note": "no single PyTorch call computes this function"}
    errs = []
    for tag, labels in (("identity", ident), ("round2", round2)):
        args = (el.src, el.dst, valid, labels, n)
        want = boruvka_round_ref(*args)
        errs.append(require_equal(f"boruvka_round[{tag}]",
                                  boruvka_round(*args), want))
        for name, fn in (("previous_kernel", previous_boruvka_round),
                         ("without_table", boruvka_round_without_table)):
            require_equal(f"boruvka_round[{tag}][{name}]", fn(*args), want)
        turns = time_turns(
            {"ms": lambda: boruvka_round(*args),
             "previous_kernel_ms": lambda: previous_boruvka_round(*args),
             "without_table_ms": lambda: boruvka_round_without_table(*args)},
            flush)
        b_rec.update({f"{key}_{tag}": ms for key, ms in turns.items()})
        b_rec[f"plain_ms_{tag}"] = time_ms(lambda: boruvka_round_ref(*args),
                                           flush)
        b_rec[f"updates_{tag}"] = boruvka_updates(*args)
    b_rec.update(max_abs_err=max(errs), ms=b_rec["ms_identity"],
                 plain_ms=b_rec["plain_ms_identity"],
                 previous_kernel_ms=b_rec["previous_kernel_ms_identity"],
                 components_round2=int(torch.unique(round2).numel()))

    s_rec = check_segment_min(el, flush)
    f_rec = check_frontier_round(el, valid, n_valid, flush)
    for rec in (b_rec, s_rec, f_rec):
        emit({"phase": "kernel_check", **rec})
    return {"boruvka_round": b_rec, "segment_min": s_rec,
            "frontier_round": f_rec}


def launch_split(name: str, call, waited: bool, calls: int = 20,
                 captures: int = 3) -> dict:
    """The device timeline of ``calls`` calls of ``call()`` under
    torch.profiler, each call after a device-side wait (``WAIT_CYCLES``)
    when ``waited``, so that the host has queued the whole call before the
    card reaches it: per launch of the kernel whose name holds ``name``,
    the PyTorch fill just before it (0 where the kernel follows the wait),
    the gap between the two and the kernel's own time; medians in ms. A
    capture that lacks a launch's record (CUPTI drops one now and then) is
    taken again, at most ``captures`` times; ``captures`` in the result
    counts those taken, and every median comes from one complete capture."""
    from torch.profiler import ProfilerActivity, profile

    call()
    sync()
    for capture in range(1, captures + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                if waited:
                    torch.cuda._sleep(WAIT_CYCLES)
                call()
            sync()
        spans = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                       for ev in prof.events()
                       if ev.device_type == torch.autograd.DeviceType.CUDA)
        parts = {"fill_ms": [], "gap_ms": [], "body_ms": [], "total_ms": []}
        for (a0, a1, before), (b0, b1, kernel) in zip(
                [(0, 0, "")] + spans, spans):
            if name not in kernel:
                continue
            fill = "fill" in before.lower()
            parts["fill_ms"].append((a1 - a0) / 1e3 if fill else 0.0)
            parts["gap_ms"].append((b0 - a1) / 1e3 if fill else 0.0)
            parts["body_ms"].append((b1 - b0) / 1e3)
            parts["total_ms"].append((b1 - (a0 if fill else b0)) / 1e3)
        if len(parts["body_ms"]) == calls:
            return {"captures": capture,
                    **{key: statistics.median(v) for key, v in parts.items()}}
    raise AssertionError(f"{name}: {len(parts['body_ms'])} of {calls} "
                         f"launches found in the profile, {captures} "
                         f"captures")


def check_segment_min(el, flush) -> dict:
    """``segment_min`` at the device final's shapes: one key per arc of
    the certificate's Euler tour (2 * 2(n-1) arcs), one segment per
    vertex; INF32 keys and out-of-range ids included. The op (one
    cooperative launch), the same body after PyTorch's fill
    (``filled_segment_min``) and the first kernel after that fill
    (``previous_segment_min``), each bit for bit against the plain version
    and timed in turns; then each split under the profiler into the fill,
    the gap and the body, with the host's dispatch queued ahead of the card
    (``waited``) and not."""
    n = el.n_nodes
    a = 2 * certificate_capacity(n)
    gen_ = torch.Generator(device=el.device).manual_seed(SEED)
    keys = torch.randperm(a, generator=gen_, device=el.device).to(INT)
    keys[torch.rand(a, generator=gen_, device=el.device) < 0.1] = INF32
    ids = torch.randint(-1000, n + 1000, (a,), generator=gen_,
                        device=el.device, dtype=INT)
    ids[:4] = torch.tensor([-(2 ** 31), -1, n, INF32], dtype=INT)
    n_live = int((keys != INF32).sum())
    s_bytes = 4 * a + 4 * n_live + 4 * n
    want = segment_min_ref(keys, ids, n)
    err = require_equal("segment_min", segment_min(keys, ids, n), want)
    variants = {"ms": lambda: segment_min(keys, ids, n),
                "filled_first_ms": lambda: filled_segment_min(keys, ids, n),
                "previous_kernel_ms": lambda: previous_segment_min(keys, ids,
                                                                   n)}
    for key in ("filled_first_ms", "previous_kernel_ms"):
        require_equal(f"segment_min[{key}]", variants[key](), want)
    idx64 = torch.where((ids >= 0) & (ids < n), ids, n).long()

    def library():
        out = torch.full((n + 1,), INF32, dtype=INT, device=el.device)
        return out.scatter_reduce_(0, idx64, keys, "amin", include_self=True)

    require_equal("segment_min[library]", want, library()[:n])
    rec = {"name": "segment_min", "route": "cuda",
           "path": kernel_path(el.device), "source": SOURCE,
           "replaces": "src/repro/kernels/segment_min/kernel.py:76",
           "shape": {"E": a, "n": n, "live_keys": n_live},
           "max_abs_err": err, **time_turns(variants, flush),
           "plain_ms": time_ms(lambda: segment_min_ref(keys, ids, n), flush),
           "library_ms": time_ms(library, flush),
           "library_note": "Tensor.scatter_reduce_(amin) on ids already "
                           "mapped to a dump slot (that mapping untimed)",
           "bound_ms": s_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "bound_bytes": s_bytes}
    labels = {"ms": "op", "filled_first_ms": "filled_first",
              "previous_kernel_ms": "previous_kernel"}
    rec["split"] = {f"{labels[key]}{'' if waited else '_unwaited'}":
                    launch_split("segment_min", fn, waited)
                    for key, fn in variants.items()
                    for waited in (True, False)}
    return rec


def sfs_rounds_plain(el) -> list:
    """``(frontier, visited)`` of every round of one scan-first-search pass
    (F1 of the ``sfs`` certificate) run with the plain round function, so
    that no frontier-round kernel made them."""
    rounds = []

    def recording_ref(src, dst, mask, frontier, visited, n):
        rounds.append((frontier.clone(), visited.clone()))
        return frontier_round_ref(src, dst, mask, frontier, visited, n)

    _, labels, _ = spanning_forest_ex(el)
    _sfs_impl(el.src, el.dst, el.mask, el.n_nodes, labels,
              round_fn=recording_ref)
    return rounds


def check_frontier_round(el, valid, n_valid: int, flush) -> dict:
    """``frontier_round`` at the main path's shapes on the frontier and
    visited sets of every round of one SFS pass, bit for bit against its
    plain version, through the redesigned kernel (the op) and through the
    first one (``previous_frontier_round``); the library call held too at
    the picked rounds. The picked rounds: the first (its frontier is every
    root, the isolated padding vertices included), the widest frontier
    after it, the thinnest after it and the round that reaches the most
    vertices (the most atomics). There both kernels are timed in turns
    (``previous_kernel_ms_*``) beside the plain version and the library
    call; over the whole pass each kernel's time per launch too."""
    n, e = el.n_nodes, el.capacity
    rounds = sfs_rounds_plain(el)
    sizes = [int(f.sum()) for f, _ in rounds]
    later = range(1, len(rounds) - 1) or range(1)
    picks = {"first": 0,
             "widest": max(later, key=sizes.__getitem__),
             "thin": min(later, key=sizes.__getitem__),
             "most_reached": max(range(len(rounds) - 1) or range(1),
                                 key=lambda i: sizes[i + 1])}
    f_bytes = frontier_round_bytes(e, n, n_valid)
    rec = {"name": "frontier_round", "route": "cuda",
           "path": kernel_path(el.device), "source": SOURCE,
           "replaces": "src/repro/kernels/boruvka_round/kernel.py:214",
           "shape": {"E": e, "n": n, "valid_slots": n_valid},
           "sfs_rounds": len(rounds), "frontier_sizes": sizes,
           "bound_ms": f_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "bound_bytes": f_bytes,
           "library_note": "Tensor.scatter_reduce_(amin) over the int64 "
                           "keys parent * 2^32 + slot of the candidate arcs, "
                           "ids already mapped to a dump slot; the "
                           "candidate-mask pass that makes them is untimed"}
    errs = []
    for i, (frontier, visited) in enumerate(rounds):
        args = (el.src, el.dst, valid, frontier, visited, n)
        want = frontier_round_ref(*args)
        for name, fn in (("", frontier_round),
                         ("[previous_kernel]", previous_frontier_round)):
            errs += [require_equal(f"frontier_round[{i}]{name}.{part}", a, b)
                     for part, a, b in zip(("best_p", "best_e"), fn(*args),
                                           want)]
    arange = torch.arange(e, dtype=torch.int64, device=el.device)
    us = torch.cat([el.src, el.dst]).long()
    ws = torch.cat([el.dst, el.src])
    slots = torch.cat([arange, arange])
    v2 = torch.cat([valid, valid])
    for tag, i in picks.items():
        frontier, visited = rounds[i]
        args = (el.src, el.dst, valid, frontier, visited, n)
        got = frontier_round(*args)
        cand = v2 & frontier[us] & ~visited[ws.long()]
        keys = us * (1 << 32) + slots
        idx = torch.where(cand, ws, n).long()

        def library():
            out = torch.full((n + 1,), PACKED_INF, dtype=torch.int64,
                             device=el.device)
            return out.scatter_reduce_(0, idx, keys, "amin",
                                       include_self=True)

        packed = library()[:n]
        require_equal(f"frontier_round[{tag}][library].best_p", got[0],
                      (packed >> 32).to(INT))
        require_equal(f"frontier_round[{tag}][library].best_e", got[1],
                      (packed & 0xFFFFFFFF).to(INT))
        rec[f"round_{tag}"] = i
        rec[f"reached_{tag}"] = int((got[0] < INF32).sum())
        turns = time_turns(
            {"ms": lambda: frontier_round(*args),
             "previous_kernel_ms": lambda: previous_frontier_round(*args)},
            flush)
        rec.update({f"{key}_{tag}": ms for key, ms in turns.items()})
        rec[f"plain_ms_{tag}"] = time_ms(lambda: frontier_round_ref(*args),
                                         flush, iters=5)
        rec[f"library_ms_{tag}"] = time_ms(library, flush)
    pass_ms = {"ms_pass": [], "previous_kernel_ms_pass": []}
    for f, v in rounds:
        args = (el.src, el.dst, valid, f, v, n)
        turns = time_turns(
            {"ms_pass": lambda: frontier_round(*args),
             "previous_kernel_ms_pass": lambda: previous_frontier_round(
                 *args)}, flush, iters=5, warmup=1)
        for key, ms in turns.items():
            pass_ms[key].append(ms)
    for key, times in pass_ms.items():
        rec[f"{key}_mean"] = statistics.fmean(times)
        rec[key] = times
    rec.update(max_abs_err=max(errs), ms=rec["ms_widest"],
               previous_kernel_ms=rec["previous_kernel_ms_widest"],
               plain_ms=rec["plain_ms_widest"],
               library_ms=rec["library_ms_widest"])
    return rec


def run_main_path(src, dst, planted, final: str, run: str) -> dict:
    """One ``find_bridges`` call, launch counts zeroed just before it and
    read just after. ``run`` names it: the first call of a final pays the
    card's lazy loading of PyTorch's own kernels ("cold"), the second not
    ("warm")."""
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    got = find_bridges(src, dst, N_NODES, final=final)
    sync()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    if got != planted:
        raise AssertionError(f"find_bridges(final={final!r}) returned "
                             f"{sorted(got)}, planted {sorted(planted)}")
    rec = {"phase": "main_path", "final": final, "run": run,
           "seconds": seconds, "bridges": len(got), "launches": launches,
           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    emit(rec)
    return rec


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def phase_profile(label: str, call, check, cpu_ops: bool = True,
                  extra=None) -> dict:
    """One warm ``call()`` under ``torch.profiler``: device busy time
    (union of kernel intervals) against the call's wall time, and device
    time by kernel. The profiler's own overhead inflates the wall time.
    ``check(result)`` must hold. Without ``cpu_ops`` only device events
    are recorded (a call of hundreds of thousands of launches); ``extra()``
    (read after the call) adds keys to the line."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    activities = [ProfilerActivity.CUDA]
    if cpu_ops:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        got = call()
        sync()
        wall = time.perf_counter() - t0
    if not check(got):
        raise AssertionError(f"profiled {label} gave a wrong answer")
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for name, a, b in spans:
        rec = by_name.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += b - a
    busy_s = _busy_us([(a, b) for _, a, b in spans]) / 1e6 if spans else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]

    def summed(parts) -> dict:
        """Launches of the events whose name holds ``parts[0]``, and the
        time of those whose name holds any of ``parts``."""
        return {"count": sum(c for n, (c, _) in by_name.items()
                             if parts[0] in n),
                "us": sum(t for n, (_, t) in by_name.items()
                          if any(part in n for part in parts))}

    # the port's kernels, each with the kernels its op launches beside it
    ours = {kernel: summed((kernel,) + EVENTS_BESIDE.get(kernel, ()))
            for kernel in launch_counts()}
    rec = {"phase": "profile", "run": label, "wall_s": wall,
           "device_events": len(spans), "device_busy_s": busy_s,
           "idle_share": None if busy_s is None else 1 - busy_s / wall,
           "ours": {k: v for k, v in ours.items() if v["count"]},
           "fills": summed(("Fill",)),
           "by_kernel": [{"name": n[:100], "count": c, "us": t}
                         for n, (c, t) in top]}
    if extra is not None:
        rec.update(extra())
    emit(rec)
    return rec


@contextlib.contextmanager
def first_kernel_on_path(kernel: str):
    """``kernel``'s op with its wrapper swapped for the first kernel's for
    the block's duration: the same-run "before" of the path's device time
    of that kernel."""
    module, attr, first, _ = PATH_SWAPS[kernel]
    saved = getattr(module, attr)
    setattr(module, attr, first)
    try:
        yield
    finally:
        setattr(module, attr, saved)


def phase_kernel_paths(src, dst, planted, truth) -> dict:
    """For each kernel of ``PATH_SWAPS``, the summed device time of its
    launches (and of the kernels its op launches beside it) in one warm
    call of each run it names, from torch.profiler: with the redesigned
    kernel, with the first one in its place, and again with the
    redesigned one; with every PyTorch fill of the call beside it (the
    first ``segment_min`` op fills ``out`` in a launch of its own). One
    line per kernel, ``<kernel>_path``."""
    calls = {"find_bridges(final='device')":
             (lambda: find_bridges(src, dst, N_NODES, final="device"),
              lambda got: got == planted),
             run_label("cuts", "host", None):
             (lambda: analyze(src, dst, N_NODES, kind="cuts", final="host"),
              lambda got: got == truth["cuts"])}
    out = {}
    for kernel, (_, _, _, labels) in PATH_SWAPS.items():
        rec = {"phase": f"{kernel}_path"}
        for label in labels:
            call, check = calls[label]
            runs = []
            for which in ("redesign", "previous", "redesign"):
                with (first_kernel_on_path(kernel) if which == "previous"
                      else contextlib.nullcontext()):
                    prof = phase_profile(f"{label} [{which} {kernel}]",
                                         call, check)
                runs.append({"kernel": which,
                             **prof["ours"].get(kernel,
                                                {"count": 0, "us": 0.0}),
                             "fills": prof["fills"]})
            if len({run["count"] for run in runs}) != 1 or not runs[0][
                    "count"]:
                raise AssertionError(f"{label}: {kernel} launches differ "
                                     f"between kernels: {runs}")
            rec[label] = runs
        emit(rec)
        out[kernel] = rec
    return out


def planted_truth(n: int, n_bridges: int, planted: set) -> dict:
    """Every kind's answer on ``gen.planted_bridge_graph(n, m, n_bridges)``,
    from its layout: ``n_bridges + 1`` blobs of consecutive ids, each
    2-vertex-connected through its Hamiltonian cycle, joined in a chain by
    the planted bridges. The bridges' endpoints are the cut vertices, the
    blocks are the blobs and the bridge pairs, each blob's 2ECC label is
    its first vertex, and the bridge tree joins consecutive blobs."""
    k = n_bridges + 1
    sizes = np.full(k, n // k)
    sizes[: n % k] += 1
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
    blobs = {frozenset(range(a, a + int(z))) for a, z in zip(starts, sizes)}
    return {"bridges": planted,
            "cuts": {v for pair in planted for v in pair},
            "bcc": blobs | {frozenset(pair) for pair in planted},
            "2ecc": np.repeat(starts, sizes),
            "bridge_tree": {(starts[b], starts[b + 1]) for b in range(k - 1)}}


def registry_combos() -> list:
    """Every (kind, certificate) pair the registries allow: the
    certificate preserves what the kind's declared one does."""
    combos = []
    for kind in analysis_kinds():
        for cert in certificate_names():
            try:
                resolve_certificate(kind, cert)
            except ValueError:
                continue
            combos.append((kind, cert))
    return combos


def same_answer(kind: str, got, want) -> bool:
    if kind == "2ecc":
        return bool(np.array_equal(got, want))
    return got == want


def run_label(kind: str, final: str, cert) -> str:
    extra = f", certificate={cert!r}" if cert else ""
    return f"analyze(kind={kind!r}, final={final!r}{extra})"


def run_analyze(src, dst, truth, kind: str, final: str, cert,
                run: str) -> dict:
    """One ``analyze`` call, launch counts zeroed just before it and read
    just after; its answer against the planted truth. Every round of a
    Borůvka or scan-first loop launches its kernel once and syncs the host
    once, so the round-loop syncs are those two launch counts."""
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    got = analyze(src, dst, N_NODES, kind=kind, final=final,
                  certificate=cert)
    sync()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    if not same_answer(kind, got, truth[kind]):
        raise AssertionError(f"{run_label(kind, final, cert)} missed the "
                             f"planted truth")
    rec = {"phase": "analyze", "kind": kind, "final": final,
           "certificate": cert or get_analysis(kind).certificate,
           "run": run, "seconds": seconds, "launches": launches,
           "host_syncs_in_round_loops": (launches["boruvka_round"]
                                         + launches["frontier_round"]),
           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    emit(rec)
    return rec


def certificate_with_rounds(el, cert: str, cap: int):
    """The registry's certificate ``cert`` of ``el`` (built by its ``_ex``
    form) and the rounds of each of its passes."""
    if cert == "hybrid":
        buf, rounds = hybrid_certificate_ex(el, cap)
        return buf, dict(zip(("chain", "F1", "F2"), rounds))
    build_ex = {"2ec": sparse_certificate_ex, "sfs": sfs_certificate_ex}[cert]
    buf, _, _, rounds = build_ex(el, cap)
    return buf, dict(zip(("F1", "F2"), rounds))


def run_analysis_stages(src, dst, truth, kind: str, final: str,
                        cert) -> dict:
    """The pipeline of one analyze run stage by stage, as
    ``make_analysis_fn`` composes it: wall seconds per stage (each ends in
    a synchronize) and rounds per certificate pass."""
    analysis = get_analysis(kind)
    cert = cert or analysis.certificate
    sync()
    t0 = time.perf_counter()
    el = pad_graph(src, dst, N_NODES)
    sync()
    rec = {"phase": "analysis_stages", "kind": kind, "final": final,
           "certificate": cert, "pad_s": time.perf_counter() - t0}
    buf = el
    if final == "host" or analysis.device_input == "certificate":
        cap = certificate_capacity(el.n_nodes)
        t0 = time.perf_counter()
        buf, rec["rounds"] = certificate_with_rounds(el, cert, cap)
        sync()
        rec["certificate_s"] = time.perf_counter() - t0
    if final == "host":
        t0 = time.perf_counter()
        got = analysis.host_fn(*masked_arrays((buf.src, buf.dst, buf.mask)),
                               N_NODES)
        rec["final_host_s"] = time.perf_counter() - t0
    else:
        before = launch_counts()["boruvka_round"]
        t0 = time.perf_counter()
        st = tour_state(buf.src, buf.dst, buf.mask, el.n_nodes)
        sync()
        t1 = time.perf_counter()
        out = analysis.device_fn(buf.src, buf.dst, buf.mask, el.n_nodes, st,
                                 el.n_nodes - 1)
        sync()
        t2 = time.perf_counter()
        got = analysis.to_result(out, N_NODES)
        rec.update(tour_state_s=t1 - t0, final_device_s=t2 - t1,
                   to_result_s=time.perf_counter() - t2,
                   final_boruvka_rounds=(launch_counts()["boruvka_round"]
                                         - before))
    if not same_answer(kind, got, truth[kind]):
        raise AssertionError(f"stage-by-stage {kind}/{final}/{cert} missed "
                             f"the planted truth")
    emit(rec)
    return rec


def phase_analyze(src, dst, truth) -> dict:
    """Every analyze run of ``ANALYZE_RUNS`` cold then warm (launch counts
    equal across the two), then stage by stage."""
    runs = {}
    for kind, final, cert in ANALYZE_RUNS:
        cold = run_analyze(src, dst, truth, kind, final, cert, "cold")
        warm = run_analyze(src, dst, truth, kind, final, cert, "warm")
        if cold["launches"] != warm["launches"]:
            raise AssertionError(f"launch counts differ between runs of "
                                 f"{run_label(kind, final, cert)}")
        runs[run_label(kind, final, cert)] = warm
    for kind, final, cert in ANALYZE_RUNS:
        run_analysis_stages(src, dst, truth, kind, final, cert)
    for cert in ("sfs", "hybrid"):
        label = run_label("cuts", "host", None if cert == "sfs" else cert)
        if runs[label]["launches"]["frontier_round"] <= 0:
            raise AssertionError(f"{label} launched no frontier_round")
    return runs


def phase_check() -> None:
    """Small worlds on the card against the host oracles and the planted
    truth, every kind and final; the pipeline of every (kind, final,
    certificate) the registry allows on the card against the same pipeline
    on the CPU, buffer for buffer."""
    worlds = [(sc["src"], sc["dst"], sc["n"], sc["bridges"])
              for sc in gen.failure_scenarios()]
    s, d, b = gen.planted_bridge_graph(3000, 60_000, 5, seed=1)
    worlds.append((s, d, 3000, b))
    small_truth = planted_truth(3000, 5, b)
    combos = registry_combos()
    answers = 0
    for src, dst, n, truth in worlds:
        for final in ("device", "host"):
            got = find_bridges(src, dst, n, final=final)
            if got != truth or got != bridges_dfs(src, dst, n):
                raise AssertionError(f"small world n={n} final={final}")
            for kind, cert in combos:
                got = analyze(src, dst, n, kind=kind, final=final,
                              certificate=cert)
                oracle = get_analysis(kind).host_fn(src, dst, n)
                if not same_answer(kind, got, oracle) or (
                        n == 3000 and not same_answer(kind, got,
                                                      small_truth[kind])):
                    raise AssertionError(f"small world n={n} {kind}/{final}/"
                                         f"{cert}")
                answers += 1
    cpu_el = pad_graph(s, d, 3000, device="cpu")
    gpu_el = pad_graph(s, d, 3000)
    buffers = 0
    for kind, cert in combos:
        for final in ("host", "device"):
            fn = make_analysis_fn(cpu_el.n_nodes, kind, final,
                                  certificate=cert)
            want = fn(cpu_el.src, cpu_el.dst, cpu_el.mask)
            got = fn(gpu_el.src, gpu_el.dst, gpu_el.mask)
            if isinstance(want, torch.Tensor):
                want, got = (want,), (got,)
            for a, b in zip(want, got):
                if not torch.equal(a, b.cpu()):
                    raise AssertionError(f"card and CPU pipelines differ "
                                         f"({kind}/{final}/{cert})")
                buffers += 1
    emit({"phase": "check", "worlds": len(worlds), "finals": 2,
          "kind_certificate_pairs": combos,
          "answers_equal_to_oracles": answers,
          "buffers_equal_to_cpu": buffers})


# ------------------------------------------------- the merge across machines
def stacked_shards(src, dst, m: int) -> tuple:
    """The partition of the Fig. 2 graph over ``m`` machines (seed
    ``SEED``), each row padded to its power-of-two bucket as the
    distributed entry point pads it: stacked ``[m, cap]`` tensors on the
    card, and ``cap``."""
    psrc, pdst, pmask = partition_edges(src, dst, N_NODES, m, seed=SEED)
    cap = admission_capacity(psrc.shape[1], MIN_BUCKET)
    pad = ((0, 0), (0, cap - psrc.shape[1]))
    return tuple(torch.from_numpy(np.pad(a, pad)).cuda()
                 for a in (psrc, pdst, pmask)), cap


def answer(cert, kind: str, final: str):
    """One machine's answer off its merged certificate: the kind's device
    final (``tour_state`` and ``device_fn`` at the graph's own n) or its
    host reference, as the distributed program and entry point give it."""
    analysis = get_analysis(kind)
    if final == "host":
        return analysis.host_fn(*masked_arrays((cert.src, cert.dst,
                                                cert.mask)), N_NODES)
    st = tour_state(cert.src, cert.dst, cert.mask, N_NODES)
    return analysis.to_result(analysis.device_fn(
        cert.src, cert.dst, cert.mask, N_NODES, st, N_NODES - 1), N_NODES)


def run_simulated(shards, cap: int, schedule: str, kind: str, run: str,
                  line: str) -> tuple:
    """One merge through the host simulator on the card: every machine's
    local certificate (``certify_shards``), then ``simulate_merge_host``,
    under a live tracer, launch counts zeroed just before and read just
    after. Returns the merged certificates and the record: wall seconds,
    the local certificates' seconds and each ``merge/level{q}`` span's,
    launches, host syncs in round loops and peak device bytes."""
    cert = DIST_KINDS[kind]
    certify = certificate_builder(cert)
    m = shards[0].shape[0]
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    tr = enable_tracing()
    try:
        t0 = time.perf_counter()
        local = certify_shards(*shards, N_NODES, certify=certify)
        merged = simulate_merge_host(local, schedule, certify=certify,
                                     grid=DIST_GRID)
        sync()
        seconds = time.perf_counter() - t0
    finally:
        disable_tracing()
    launches = launch_counts()
    roll = tr.rollup()
    rec = {"phase": line, "run": run, "schedule": schedule, "kind": kind,
           "certificate": cert, "machines": m, "shard_slots": cap,
           "phases": len(merge_phase_plan(schedule, m, grid=DIST_GRID)),
           "seconds": seconds,
           "local_certificates_s": roll["merge/certify"]["total_s"],
           "levels_s": {name: row["total_s"] for name, row in roll.items()
                        if name.startswith("merge/level")},
           # in start order: hierarchical runs each row's levels, then
           # each column's (its level0 spans are both kinds of phase)
           "level_spans": [[sp["name"], sp["attrs"]["machines"], sp["dur"]]
                           for sp in tr.spans()
                           if sp["name"].startswith("merge/level")],
           "certificates_built": roll["merge/certify"]["count"] + roll.get(
               "merge/machine", {"count": 0})["count"],
           "launches": launches,
           "host_syncs_in_round_loops": (launches["boruvka_round"]
                                         + launches["frontier_round"]),
           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    return merged, rec


def run_simulated_warm(shards, cap: int, schedule: str, kind: str,
                       line: str) -> tuple:
    """``run_simulated`` once cold, then ``DIST_WARM_RUNS`` times warm
    (launch counts equal across all); the warm run of median wall seconds,
    with every warm run's seconds beside it (``warm_seconds``), and its
    merged certificates."""
    cold = run_simulated(shards, cap, schedule, kind, "cold", line)[1]
    warm = [run_simulated(shards, cap, schedule, kind, "warm", line)
            for _ in range(DIST_WARM_RUNS)]
    if any(rec["launches"] != cold["launches"] for _, rec in warm):
        raise AssertionError(f"{line} {schedule}/{kind}: launch counts "
                             f"differ between runs")
    merged, rec = sorted(warm, key=lambda mr: mr[1]["seconds"])[
        DIST_WARM_RUNS // 2]
    rec.update(cold_seconds=cold["seconds"],
               warm_seconds=[r["seconds"] for _, r in warm])
    return merged, rec


def check_answers(merged, schedule: str, kind: str, truth, rec) -> None:
    """Machine 0's answer with both finals (and machine M - 1's where the
    schedule leaves the global certificate on every machine) against the
    planted truth; the finals' seconds and launches on machine 0 into
    ``rec``."""
    machines = [0] if schedule == "paper" else [0, len(merged) - 1]
    for i in machines:
        for final in ("device", "host"):
            sync()
            reset_launch_counts()
            t0 = time.perf_counter()
            got = answer(merged[i], kind, final)
            sync()
            if i == 0:
                rec[f"final_{final}_s"] = time.perf_counter() - t0
                rec[f"final_{final}_launches"] = launch_counts()
            if not same_answer(kind, got, truth[kind]):
                raise AssertionError(f"distributed {schedule}/{kind}: machine "
                                     f"{i}, final={final!r} missed the "
                                     f"planted truth")
    rec["answered_on"] = machines


def path_kernel_checks(buffers: dict) -> list:
    """The three connectivity kernels at the distributed path's shapes, each
    bit for bit against its plain version: per buffer the Borůvka round at
    identity and round-2 labels, the frontier round at every round of one
    scan-first pass, and ``segment_min`` at the inputs the pipeline hands
    it there (recorded from a run of the stage that reads the buffer)."""
    recs = []
    for label, (el, seg_args) in buffers.items():
        n = el.n_nodes
        valid = el.mask & (el.src != el.dst)
        ident = torch.arange(n, dtype=INT, device=el.device)
        round2, _, _ = hook_round(el.src, el.dst, valid, ident, n)
        errs = [require_equal(f"{label}: boruvka_round[{tag}]",
                              boruvka_round(el.src, el.dst, valid, labels, n),
                              boruvka_round_ref(el.src, el.dst, valid, labels,
                                                n))
                for tag, labels in (("identity", ident), ("round2", round2))]
        recs.append({"name": "boruvka_round", "buffer": label,
                     "shape": {"E": el.capacity, "n": n,
                               "valid_slots": int(valid.sum()),
                               "view": el.src._base is not None},
                     "max_abs_err": max(errs)})
        rounds = sfs_rounds_plain(el)
        errs = []
        for i, (frontier, visited) in enumerate(rounds):
            args = (el.src, el.dst, valid, frontier, visited, n)
            errs += [require_equal(f"{label}: frontier_round[{i}]", a, b)
                     for a, b in zip(frontier_round(*args),
                                     frontier_round_ref(*args))]
        recs.append({"name": "frontier_round", "buffer": label,
                     "shape": {"E": el.capacity, "n": n},
                     "sfs_rounds": len(rounds), "max_abs_err": max(errs)})
        errs = [require_equal(f"{label}: segment_min[{j}]",
                              segment_min(keys, ids, n),
                              segment_min_ref(keys, ids, n))
                for j, (keys, ids, n) in enumerate(seg_args)]
        recs.append({"name": "segment_min", "buffer": label,
                     "shapes": [{"E": k.numel(), "n": n}
                                for k, _, n in seg_args],
                     "max_abs_err": max(errs)})
    for rec in recs:
        emit({"phase": "distributed_kernel_check", **rec})
    return recs


#: where each connectivity kernel's op finds its launch wrapper
KERNEL_WRAPPERS = {"boruvka_round": (boruvka_ops, "boruvka_round_cuda"),
                   "frontier_round": (boruvka_ops, "frontier_round_cuda"),
                   "segment_min": (segment_min_ops, "segment_min_cuda")}


@contextlib.contextmanager
def recording_kernels(calls: dict, names=tuple(KERNEL_WRAPPERS), key=None,
                      per_shape=None):
    """Each named connectivity kernel's arguments, per call, appended to
    ``calls[name]`` (with ``key``, to ``calls[key()][name]``, ``key``
    asked at each call) for the block's duration, the ops still launching
    the kernels. With ``per_shape``, only the first ``per_shape`` calls of
    each kernel at each (slots, n) shape are kept. The tensors are kept,
    not copied: the pipeline writes none of a kernel's inputs in place
    after the call."""
    saved = {name: getattr(*KERNEL_WRAPPERS[name]) for name in names}
    seen = {}

    def recorder(name):
        def record(*args):
            into = calls if key is None else calls.setdefault(key(), {})
            shape = (name, args[0].numel(), args[-1])
            seen[shape] = seen.get(shape, 0) + 1
            if per_shape is None or seen[shape] <= per_shape:
                into.setdefault(name, []).append(args)
            return saved[name](*args)
        return record

    for name in names:
        setattr(*KERNEL_WRAPPERS[name], recorder(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(*KERNEL_WRAPPERS[name], fn)


@contextlib.contextmanager
def one_rank_nccl_mesh(names=("machines",)):
    """A one-rank NCCL group (its own file store) and a ``DeviceMesh`` of
    one rank over it, one dimension per name, destroyed on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=300))
        try:
            yield DeviceMesh("cuda", torch.arange(1).reshape(
                (1,) * len(names)), mesh_dim_names=tuple(names))
        finally:
            dist.destroy_process_group()


def phase_process_group(src, dst, planted, shards1, sim1) -> dict:
    """The process-group program on the card: a one-rank NCCL group and a
    one-dim ``DeviceMesh``. ``find_bridges(..., mesh=...)`` with both
    finals against the planted truth (wall seconds, launches), and the
    program's buffers on the M = 1 partition against the simulator's
    machine 0 at M = 1, bit for bit. With one machine the schedule has no
    phase: no exchange happens (counted)."""
    exchanges = []
    saved = merge_mod._exchange

    def counted(*args):
        exchanges.append(1)
        return saved(*args)

    rec = {"phase": "distributed_process_group", "backend": "nccl",
           "world_size": 1, "phases": len(merge_phase_plan("paper", 1))}
    with one_rank_nccl_mesh() as mesh:
        merge_mod._exchange = counted
        try:
            for final in ("device", "host"):
                for run in ("cold", "warm"):
                    sync()
                    reset_launch_counts()
                    t0 = time.perf_counter()
                    got = find_bridges(src, dst, N_NODES, final=final,
                                       mesh=mesh, seed=SEED)
                    sync()
                    rec[f"{final}_{run}_s"] = time.perf_counter() - t0
                if got != planted:
                    raise AssertionError(f"find_bridges(mesh, final="
                                         f"{final!r}) missed the planted "
                                         f"bridges")
                rec[f"{final}_launches"] = launch_counts()
                fn = build_distributed_analysis_fn(mesh, ("machines",),
                                                   N_NODES, final=final)
                fn(*(t[0] for t in shards1))
                sync()
                t0 = time.perf_counter()
                out = fn(*(t[0] for t in shards1))
                sync()
                rec[f"{final}_program_warm_s"] = time.perf_counter() - t0
                cert = sim1[0]
                if final == "host":
                    want = compact_edges(cert, certificate_capacity(N_NODES))
                    want = (want.src, want.dst, want.mask)
                else:
                    st = tour_state(cert.src, cert.dst, cert.mask, N_NODES)
                    want = get_analysis("bridges").device_fn(
                        cert.src, cert.dst, cert.mask, N_NODES, st,
                        N_NODES - 1)
                rec[f"{final}_max_abs_err_vs_simulator"] = max(
                    require_equal(f"process group vs simulator [{final}]",
                                  a, b) for a, b in zip(out, want))
        finally:
            merge_mod._exchange = saved
    t0 = time.perf_counter()
    partition_edges(src, dst, N_NODES, 1, seed=SEED)
    rec["partition_s"] = time.perf_counter() - t0
    rec["exchanges"] = len(exchanges)
    if rec["exchanges"]:
        raise AssertionError("a one-rank group exchanged certificates")
    emit(rec)
    return rec


def phase_distributed(src, dst, truth) -> dict:
    """The paper's merge across machines on the card (module docstring,
    phase 8). Returns each kernel's launches, per kind, in the M = 8
    ``paper`` run (certificates and merge levels) and machine 0's device
    final, each counted from 0; fails where a connectivity kernel of the
    path was not launched."""
    shards8, cap8 = stacked_shards(src, dst, DIST_MACHINES)
    launches: dict[str, dict] = {}
    merged_of = {}
    for kind in DIST_KINDS:
        for schedule in SCHEDULES:
            merged, rec = run_simulated_warm(shards8, cap8, schedule, kind,
                                             "distributed")
            check_answers(merged, schedule, kind, truth, rec)
            emit(rec)
            merged_of[(schedule, kind)] = merged
            if schedule == "paper":
                for name, count in rec["launches"].items():
                    launches.setdefault(name, {})[kind] = (
                        count + rec["final_device_launches"][name])
    certify = certificate_builder("2ec")
    phase_profile(
        "simulate_merge_host(paper, bridges, M=8)",
        lambda: simulate_merge_host(certify_shards(*shards8, N_NODES,
                                                   certify=certify),
                                    "paper", certify=certify),
        lambda merged: answer(merged[0], "bridges", "device")
        == truth["bridges"])
    for name, kind in (("boruvka_round", "bridges"),
                       ("segment_min", "bridges"),
                       ("frontier_round", "cuts")):
        if launches[name][kind] <= 0:
            raise AssertionError(f"the distributed {kind} path launched no "
                                 f"{name}")
    sims = {}
    for m in DIST_SCALING:
        shards, cap = (shards8, cap8) if m == DIST_MACHINES else \
            stacked_shards(src, dst, m)
        merged, rec = run_simulated_warm(shards, cap, "paper", "bridges",
                                         "distributed_scaling")
        check_answers(merged, "paper", "bridges", truth, rec)
        emit(rec)
        if m == 1:
            sims[1] = (shards, merged)
        del shards
    # the kernels at this path's shapes: a shard row (views into the
    # stacked [8, 2^21] buffers), one phase's union, the answering
    # machine's certificate
    local = certify_shards(*shards8, N_NODES,
                           certify=certificate_builder("2ec"))
    row = EdgeList(shards8[0][DIST_MACHINES - 1],
                   shards8[1][DIST_MACHINES - 1],
                   shards8[2][DIST_MACHINES - 1], N_NODES)
    union = concat_edges(local[0], local[1])
    answering = merged_of[("paper", "bridges")][0]
    buffers = {}
    for label, el in (("shard_row", row), ("phase_union", union),
                      ("answering_certificate", answering)):
        recorded = {}
        with recording_kernels(recorded, ("segment_min",)):
            if label == "answering_certificate":
                tour_state(el.src, el.dst, el.mask, N_NODES)
            else:
                certificate_builder("sfs")(el,
                                           capacity=certificate_capacity(
                                               N_NODES))
        calls = recorded.get("segment_min", [])
        slots = torch.arange(el.capacity, dtype=INT, device="cuda")
        keys = torch.where(el.mask, slots, INF32)
        calls.append((keys, el.src.contiguous(), N_NODES))
        if len(calls) < 2:
            raise AssertionError(f"{label}: no segment_min on the path")
        buffers[label] = (el, calls)
    path_kernel_checks(buffers)
    del local, union, buffers
    phase_process_group(src, dst, truth["bridges"], *sims[1])
    return {name: per_kind for name, per_kind in launches.items()
            if any(per_kind.values())}


# ------------------------------------------------------------- the engine
def pair_keys(src, dst) -> np.ndarray:
    """One int64 per unordered endpoint pair (ids are non-negative)."""
    s, d = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    return (np.minimum(s, d) << 32) | np.maximum(s, d)


class LiveMirror:
    """The live edge multiset tracked on the host, independent of the
    engine: inserts append, a deletion removes every copy of a keyed
    pair. The oracle's input."""

    def __init__(self, src, dst):
        self.src, self.dst = np.array(src, np.int32), np.array(dst, np.int32)

    def insert(self, src, dst) -> None:
        self.src = np.concatenate([self.src, src])
        self.dst = np.concatenate([self.dst, dst])

    def delete(self, ksrc, kdst) -> None:
        table = np.unique(pair_keys(ksrc, kdst))
        keys = pair_keys(self.src, self.dst)
        at = np.searchsorted(table, keys).clip(max=len(table) - 1)
        keep = table[at] != keys
        self.src, self.dst = self.src[keep], self.dst[keep]


def certificate_pairs(engine) -> np.ndarray:
    """The pair keys of every materialized live certificate."""
    keys = []
    for state in engine._live.certs.values():
        if state is not None:
            s, d = masked_arrays(state[:3])
            keys.append(pair_keys(s, d))
    return np.unique(np.concatenate(keys))


def random_blob_edges(rng, blobs: np.ndarray, k: int) -> tuple:
    """``k`` random edges, each between two random vertices of one blob of
    the planted graph (``blobs``: each vertex's blob, its first vertex), so
    that inserts keep the planted bridges bridges."""
    starts, sizes = np.unique(blobs, return_counts=True)
    b = rng.integers(0, len(starts), k)
    ds = starts[b] + rng.integers(0, sizes[b])
    dd = starts[b] + rng.integers(0, sizes[b])
    return ds.astype(np.int32), dd.astype(np.int32)


def churn_inputs(rng, step: int, mirror: LiveMirror, engine, alive: set,
                 blobs: np.ndarray):
    """The live sequence's ``step``-th op: even steps insert
    ``ENGINE_INSERT`` random edges inside the planted blobs; odd steps
    delete ``ENGINE_KEYS`` keys, alternately from edges of no live
    certificate (the free path) and random live edges with one 2ec
    certificate edge and one planted bridge still alive (the rebuild path).
    Returns (op, path, src, dst)."""
    if step % 2 == 0:
        return ("insert", "fold",
                *random_blob_edges(rng, blobs, ENGINE_INSERT))
    live = pair_keys(mirror.src, mirror.dst)
    if step % 4 == 1:
        free = np.flatnonzero(~np.isin(live, certificate_pairs(engine)))
        pick = rng.choice(free, ENGINE_KEYS, replace=False)
        return "delete", "free", mirror.src[pick], mirror.dst[pick]
    pick = rng.choice(len(live), ENGINE_KEYS - 2, replace=False)
    cs, cd = masked_arrays(engine._live.certs["2ec"][:3])
    planted = {pair_keys(*p)[()] for p in alive}
    j = next(i for i in range(len(cs)) if pair_keys(cs[i], cd[i])[()]
             not in planted)
    bridge = sorted(alive)[0]
    return ("delete", "rebuild",
            np.concatenate([mirror.src[pick], [cs[j], bridge[0]]]),
            np.concatenate([mirror.dst[pick], [cd[j], bridge[1]]]))


def run_live(src, dst, planted, truth, run: str, check: bool,
             spans: bool = False) -> dict:
    """The live graph at the Fig. 2 point: ``load`` into a fresh engine
    (2^24 full-buffer slots; the 2ec certificate eager), then
    ``2 * ENGINE_OPS`` ops alternating inserts and deletions
    (``churn_inputs``), each answered for ``bridges`` (the op's own
    return) and ``cuts`` (``current_analysis``: the first materializes
    sfs), and once for ``cuts`` under ``certificate="hybrid"``. Launch
    counts set to 0 just before each op and read just after. With
    ``check``, every answer against the one-shot device pipeline run from
    scratch on the host's copy of the live edge multiset. With ``spans``,
    each op under a live tracer: its ``stage/*`` spans' seconds. Returns
    the answers, the launches summed over the run and the engine."""
    engine = BridgeEngine()
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    engine.load(src, dst, N_NODES)
    sync()
    load = {"phase": "engine_live", "run": run, "op": "load",
            "seconds": time.perf_counter() - t0, "launches": launch_counts(),
            "live_bytes": engine.live_bytes,
            "peak_device_bytes": torch.cuda.max_memory_allocated()}
    emit(load)
    total = dict(load["launches"])
    mirror, alive = LiveMirror(src, dst), set(planted)
    rng = np.random.default_rng(SEED + 1)
    answers = []
    if check:
        for kind in ("bridges", "cuts"):
            if not same_answer(kind, analyze(src, dst, N_NODES, kind=kind),
                               truth[kind]):
                raise AssertionError(f"the oracle missed the planted {kind}")
    for step in range(2 * ENGINE_OPS):
        op, path, s, d = churn_inputs(rng, step, mirror, engine, alive,
                                      truth["2ecc"])
        before = engine.live_rebuilds
        sync()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        tr = enable_tracing() if spans else None
        t0 = time.perf_counter()
        got = {"bridges": (engine.insert_edges(s, d) if op == "insert"
                           else engine.delete_edges(s, d))}
        sync()
        op_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got["cuts"] = engine.current_analysis("cuts")
        sync()
        cuts_s = time.perf_counter() - t0
        rec = {"phase": "engine_live", "run": run, "op": op, "path": path,
               "step": step, "edges": len(s), "seconds": op_s,
               "cuts_s": cuts_s}
        if step == 4:
            t0 = time.perf_counter()
            hybrid = engine.current_analysis("cuts", certificate="hybrid")
            sync()
            rec["cuts_hybrid_s"] = time.perf_counter() - t0
            if hybrid != got["cuts"]:
                raise AssertionError("cuts under hybrid differ from sfs")
        if spans:
            disable_tracing()
            rec["stage_s"] = {name: row["total_s"]
                              for name, row in tr.rollup().items()
                              if name.startswith("stage/")}
        launches = launch_counts()
        after = engine.live_rebuilds
        rec.update(
            launches=launches,
            host_syncs_in_round_loops=(launches["boruvka_round"]
                                       + launches["frontier_round"]),
            delete_readbacks=(1 + len(before)) if op == "delete" else 0,
            rebuilt=sorted(k for k in after if after[k] != before.get(k, 0)),
            live_bytes=engine.live_bytes,
            peak_live_bytes=engine.peak_live_bytes,
            peak_device_bytes=torch.cuda.max_memory_allocated())
        for name, count in launches.items():
            total[name] += count
        if op == "insert":
            mirror.insert(s, d)
        else:
            mirror.delete(s, d)
            alive -= {p for p in alive
                      if np.isin(pair_keys(*p), pair_keys(s, d))}
            if (path == "free") != (not rec["rebuilt"]):
                raise AssertionError(f"step {step}: a {path} deletion "
                                     f"rebuilt {rec['rebuilt']}")
        if check:
            for kind in ("bridges", "cuts"):
                want = analyze(mirror.src, mirror.dst, N_NODES, kind=kind)
                if not same_answer(kind, got[kind], want):
                    raise AssertionError(f"engine {kind} after step {step} "
                                         f"differs from the oracle")
            rec["oracle"] = "held"
        rec["bridges"], rec["cuts"] = len(got["bridges"]), len(got["cuts"])
        answers.append(got)
        emit(rec)
    snap = engine.snapshot()
    emit({"phase": "engine_live_snapshot", "run": run, **snap})
    return {"answers": answers, "launches": total, "engine": engine,
            "mirror": mirror}


def check_recorded(label: str, calls: dict, select,
                   phase: str = "engine_kernel_check") -> list:
    """Each recorded connectivity-kernel call that ``select(name, args)``
    keeps, through the kernel and its plain version, bit for bit; one
    ``phase`` line per kernel."""
    plain = {"boruvka_round": boruvka_round_ref,
             "frontier_round": frontier_round_ref,
             "segment_min": segment_min_ref}
    op = {"boruvka_round": boruvka_round, "frontier_round": frontier_round,
          "segment_min": segment_min}
    recs = []
    for name, args_list in calls.items():
        kept = [args for args in args_list if select(name, args)]
        if not kept:
            continue
        errs, shapes = [], set()
        for i, args in enumerate(kept):
            got, want = op[name](*args), plain[name](*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            errs += [require_equal(f"{label}: {name}[{i}]", a, b)
                     for a, b in zip(got, want)]
            shapes.add((args[0].numel(), args[-1]))
        rec = {"phase": phase, "name": name, "buffer": label,
               "calls": len(kept),
               "shapes": [{"E": e, "n": n} for e, n in sorted(shapes)],
               "slots_mod_4": sorted({e % 4 for e, _ in shapes}),
               "max_abs_err": max(errs)}
        emit(rec)
        recs.append(rec)
    return recs


def batch_graphs() -> list:
    """B = ``ENGINE_BATCH`` planted graphs of ``BATCH_N`` vertices and
    ``BATCH_E`` edges (seeds 0 .. B - 1), with each row's deletion keys: a
    planted bridge and ``ENGINE_KEYS - 1`` random edges of the row."""
    rows = []
    for seed in range(ENGINE_BATCH):
        s, d, planted = gen.planted_bridge_graph(BATCH_N, BATCH_E, N_BRIDGES,
                                                 seed=seed)
        rng = np.random.default_rng(seed)
        pick = rng.choice(len(s), ENGINE_KEYS - 1, replace=False)
        bridge = sorted(planted)[seed % N_BRIDGES]
        keys = (np.concatenate([s[pick], [bridge[1]]]),
                np.concatenate([d[pick], [bridge[0]]]))
        rows.append({"src": s, "dst": d, "planted": planted, "keys": keys,
                     "bridge": bridge})
    return rows


def timed(call, spans: bool = False) -> tuple:
    """``call()``'s answer and wall seconds, the card synchronised, launch
    counts set to 0 just before and read just after, peak bytes reset.
    With ``spans``, under a live tracer: the seconds of each ``stage/*``
    span summed by name (the spans wait for the card at their ends), and
    the seconds outside every outermost stage span (host work that no
    stage times)."""
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    tr = enable_tracing() if spans else None
    try:
        t0 = time.perf_counter()
        got = call()
        sync()
        seconds = time.perf_counter() - t0
    finally:
        if spans:
            disable_tracing()
    rec = {"seconds": seconds, "launches": launch_counts(),
           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    if spans:
        rec["stage_s"] = {name: row["total_s"]
                          for name, row in tr.rollup().items()
                          if name.startswith("stage/")}
        rec["outside_stages_s"] = seconds - sum(
            row["total_s"] for row in tr.stage_rollup().values())
    return got, rec


def run_batched(engine, rows) -> dict:
    """The B rows through ``analyze_batch`` (one disjoint-union pass:
    16,384 vertices and 2^21 slots a row, 131,072 and 2^24 in the union)
    and through B sequential ``engine.analyze`` calls, each cold, warm,
    then once more under the tracer for its stages' seconds; every row
    against its planted truth. Returns the warm batched runs'
    launches per query."""
    graphs = [(r["src"], r["dst"]) for r in rows]
    launches = {}
    for kind, final, delete in (("bridges", "device", False),
                                ("bridges", "host", False),
                                ("cuts", "host", False),
                                ("bridges", "device", True)):
        dels = [r["keys"] for r in rows] if delete else None
        rec = {"phase": "engine_batch", "kind": kind, "final": final,
               "delete": delete, "batch": len(rows), "n": BATCH_N,
               "row_slots": admission_capacity(BATCH_E, MIN_BUCKET)}
        for run in ("cold", "warm", "traced"):
            got, rec[f"batched_{run}"] = timed(lambda: engine.analyze_batch(
                graphs, BATCH_N, kind=kind, final=final, delete=dels),
                spans=run == "traced")
            seq, rec[f"sequential_{run}"] = timed(lambda: [
                engine.analyze(s, d, BATCH_N, kind=kind, final=final,
                               delete=dels[i] if delete else None)
                for i, (s, d) in enumerate(graphs)], spans=run == "traced")
        for i, r in enumerate(rows):
            truth = planted_truth(BATCH_N, N_BRIDGES, r["planted"])[kind]
            if delete:
                truth = truth - {r["bridge"]}
            if not (same_answer(kind, got[i], truth)
                    and same_answer(kind, seq[i], truth)):
                raise AssertionError(f"analyze_batch {kind}/{final} "
                                     f"delete={delete}: row {i} missed its "
                                     f"planted truth")
        launches[f"{kind}/{final}{'/delete' if delete else ''}"] = \
            rec["batched_warm"]["launches"]
        emit(rec)
    return launches


def phase_engine(src, dst, planted, truth, smi: str) -> dict:
    """The engine on the card (module docstring, phase 5c). Returns each
    connectivity kernel's launches in the warm live sequence and in the
    warm batched queries; fails where one of them launched no kernel."""
    cold = run_live(src, dst, planted, truth, "cold", check=True)
    del cold["engine"]
    warm = run_live(src, dst, planted, truth, "warm", check=False)
    traced = run_live(src, dst, planted, truth, "traced", check=False,
                      spans=True)
    del traced["engine"]
    for step, (a, b, c) in enumerate(zip(cold["answers"], warm["answers"],
                                         traced["answers"])):
        if not a == b == c:
            raise AssertionError(f"a later live run differs at step {step}")
    # the fold shapes, recorded off one more insert on the warm live graph
    # (2ec warm fold over the 4,096-slot delta; sfs and hybrid rescans of
    # certificate ∪ delta) and its bridges final
    engine = warm["engine"]
    ds, dd = random_blob_edges(np.random.default_rng(SEED + 2),
                               truth["2ecc"], ENGINE_INSERT)
    calls = {}
    with recording_kernels(calls):
        engine.insert_edges(ds, dd)
    n_bucket = engine._live.n_bucket
    cert_cap = certificate_capacity(n_bucket)
    check_recorded("warm_fold", calls, lambda name, args: (
        name == "boruvka_round" and args[0].numel() == ENGINE_INSERT))
    check_recorded("rescan_fold", calls, lambda name, args: (
        name == "frontier_round"
        and args[0].numel() == cert_cap + ENGINE_INSERT))
    check_recorded("live_insert_and_final", calls, lambda name, args: (
        name == "segment_min"))
    del engine, warm["engine"]

    rows = batch_graphs()
    batch_engine = BridgeEngine()
    batch_launches = run_batched(batch_engine, rows)
    calls = {}
    with recording_kernels(calls, ("boruvka_round", "frontier_round")):
        batch_engine.analyze_batch([(r["src"], r["dst"]) for r in rows],
                                   BATCH_N, kind="cuts", final="host")
    first = calls["boruvka_round"][0]
    check_recorded("batch_union", {"boruvka_round": [first],
                                   "frontier_round": calls["frontier_round"]},
                   lambda name, args: True)
    if first[0].numel() != ENGINE_BATCH * admission_capacity(BATCH_E,
                                                             MIN_BUCKET):
        raise AssertionError("the batched pass did not run on the union")
    del calls, first, batch_engine

    # one-shot deletion, twice: the second call a cache hit
    keys = (np.concatenate([src[:ENGINE_KEYS - 1], [sorted(planted)[0][0]]]),
            np.concatenate([dst[:ENGINE_KEYS - 1], [sorted(planted)[0][1]]]))
    one_shot = BridgeEngine()
    rec = {"phase": "engine_one_shot_delete", "keys": ENGINE_KEYS}
    for run in ("cold", "warm"):
        got, rec[run] = timed(lambda: one_shot.analyze(src, dst, N_NODES,
                                                       delete=keys))
        rec[f"{run}_cache"] = one_shot.cache_info()
    mirror = LiveMirror(src, dst)
    mirror.delete(*keys)
    want = analyze(mirror.src, mirror.dst, N_NODES)
    if got != want or sorted(planted)[0] in got:
        raise AssertionError("analyze(delete=) differs from the oracle")
    if (one_shot.stats.misses, one_shot.stats.hits) != (1, 1):
        raise AssertionError("the second analyze(delete=) was not a hit")
    emit(rec)
    del one_shot

    # the engine's distributed branch on a one-rank NCCL group
    shards1, _ = stacked_shards(src, dst, 1)
    shard = EdgeList(*(t[0] for t in shards1), N_NODES)
    sim = simulate_churn_host([shard], *keys)[0]
    want = answer(sim, "bridges", "device")
    rec = {"phase": "engine_process_group", "backend": "nccl",
           "world_size": 1}
    with one_rank_nccl_mesh() as mesh:
        dist_engine = BridgeEngine(mesh=mesh)
        for run in ("cold", "warm"):
            got, rec[run] = timed(lambda: dist_engine.analyze(
                src, dst, N_NODES, seed=SEED, delete=keys))
            if got != want:
                raise AssertionError("the engine's distributed branch "
                                     "differs from simulate_churn_host")
        rec["cache"] = dist_engine.cache_info()
        if (dist_engine.stats.misses, dist_engine.stats.hits) != (1, 1):
            raise AssertionError("the second distributed analyze was not a "
                                 "hit")
        del dist_engine
    emit(rec)
    del shards1, shard, sim

    launches = {}
    for name in ("boruvka_round", "frontier_round", "segment_min"):
        launches[name] = {"live": warm["launches"][name],
                          "batch": sum(c[name] for c in
                                       batch_launches.values())}
        if not (launches[name]["live"] and launches[name]["batch"]):
            raise AssertionError(f"the engine phase launched no {name}")
    emit({"phase": "engine", "card": smi, "launches": launches})
    return launches


# ------------------------------------------------------- streaming ingest
#: the streaming phase: the chunk bucket; the ingest step, not a multiple
#: of it, so a step splits into a full chunk and a ragged one; the second
#: ingest loop's edges (inside the planted blobs) and its step
STREAM_CHUNK, STREAM_STEP = 1 << 20, 1_500_000
STREAM_SECOND, STREAM_SECOND_STEP = 3_000_000, 1_500_000
#: recorded kernel calls held against the plain versions, per kernel
STREAM_CHECK_CALLS = 48


def stream_step(engine, rec: dict, label: str, call, spans: bool = False):
    """``call()`` through ``timed`` (card synchronised, launch counts set to
    0 just before and read just after); its seconds, launches, round-loop
    syncs, program-cache misses added, live and peak live bytes and peak
    device bytes under ``rec[label]``. With ``spans``, under a live tracer
    (``timed``): each stage's seconds and those outside every stage (host
    work such as the spill ring's tombstone). Returns the answer."""
    misses = engine.stats.misses
    got, step = timed(call, spans=spans)
    step.update(
        host_syncs_in_round_loops=(step["launches"]["boruvka_round"]
                                   + step["launches"]["frontier_round"]),
        misses_added=engine.stats.misses - misses,
        live_bytes=engine.live_bytes, peak_live_bytes=engine.peak_live_bytes)
    rec[label] = step
    return got


def streamed_delete_keys(engine, mirror: LiveMirror, planted: set,
                         rng) -> tuple:
    """``ENGINE_KEYS`` deletion keys: one live 2ec certificate edge (so the
    deletion rebuilds 2ec by ring replay) and random live edges, none of
    them a planted bridge."""
    bridges = pair_keys(*np.array(sorted(planted), np.int32).T)
    cs, cd = masked_arrays(engine._live.certs["2ec"][:3])
    j = int(np.flatnonzero(~np.isin(pair_keys(cs, cd), bridges))[0])
    live = np.flatnonzero(~np.isin(pair_keys(mirror.src, mirror.dst),
                                   bridges))
    pick = rng.choice(live, ENGINE_KEYS - 1, replace=False)
    return (np.concatenate([[cs[j]], mirror.src[pick]]).astype(np.int32),
            np.concatenate([[cd[j]], mirror.dst[pick]]).astype(np.int32))


def run_streaming(engine, src, dst, planted, truth, run: str,
                  check: bool) -> dict:
    """One streaming run at the Fig. 2 point (module docstring, phase 5d)
    on ``engine``: the one-shot ``load`` and every kind, then
    ``load_stream`` of the same edges in ``STREAM_STEP`` steps and every
    kind (plus ``cuts`` under ``hybrid``), one ring-replaying deletion, a
    second ingest loop that must add no program, and every kind again.
    Each answer against the planted truth, the deletion against the host
    oracle, and, with ``check``, the last answers against the one-shot
    pipeline on the host's copy of the live edges; without it, the
    deletion under a live tracer (its stages' seconds). Returns the
    streamed steps' launches summed."""
    rec = {"phase": "streaming", "run": run, "edges": len(src),
           "chunk_edges": STREAM_CHUNK, "step_edges": STREAM_STEP}
    stream_step(engine, rec, "one_shot_load",
                lambda: engine.load(src, dst, N_NODES))
    for kind in analysis_kinds():
        got = stream_step(engine, rec, f"one_shot_{kind}",
                          lambda: engine.current_analysis(kind))
        if not same_answer(kind, got, truth[kind]):
            raise AssertionError(f"one-shot {kind} missed the planted truth")
    rec["one_shot_bytes"] = {"live_bytes": engine.live_bytes,
                             "peak_live_bytes": engine.peak_live_bytes}

    def ingest(s, d, first: bool) -> None:
        lo = 0
        if first:
            engine.load_stream(s[:STREAM_STEP], d[:STREAM_STEP], N_NODES,
                               chunk_edges=STREAM_CHUNK)
            lo = STREAM_STEP
        for lo in range(lo, len(s), STREAM_STEP):
            engine.ingest_chunk(s[lo:lo + STREAM_STEP],
                                d[lo:lo + STREAM_STEP])

    streamed = []
    stream_step(engine, rec, "ingest", lambda: ingest(src, dst, True))
    streamed.append(rec["ingest"])
    rec["ingest"].update(edges_per_s=len(src) / rec["ingest"]["seconds"],
                         counters=engine.snapshot()["ingest"])
    for kind in analysis_kinds():
        got = stream_step(engine, rec, f"stream_{kind}",
                          lambda: engine.current_analysis(kind))
        streamed.append(rec[f"stream_{kind}"])
        if not same_answer(kind, got, truth[kind]):
            raise AssertionError(f"streamed {kind} missed the planted truth")
    got = stream_step(engine, rec, "stream_cuts_hybrid",
                      lambda: engine.current_analysis(
                          "cuts", certificate="hybrid"))
    streamed.append(rec["stream_cuts_hybrid"])
    if got != truth["cuts"]:
        raise AssertionError("streamed cuts under hybrid missed the truth")

    mirror = LiveMirror(src, dst)
    ks, kd = streamed_delete_keys(engine, mirror, planted,
                                  np.random.default_rng(SEED + 3))
    before = engine.live_rebuilds
    got = stream_step(engine, rec, "delete",
                      lambda: engine.delete_edges(ks, kd), spans=not check)
    streamed.append(rec["delete"])
    after = engine.live_rebuilds
    rec["delete"].update(
        keys=ENGINE_KEYS,
        rebuilt=sorted(k for k in after if after[k] != before.get(k, 0)),
        readbacks=len(before), counters=engine.snapshot()["ingest"])
    if "2ec" not in rec["delete"]["rebuilt"]:
        raise AssertionError("the deletion of a 2ec edge rebuilt no 2ec")
    mirror.delete(ks, kd)
    oracle = analyze(mirror.src, mirror.dst, N_NODES, final="host")
    if got != oracle:
        raise AssertionError("the streamed deletion differs from the host "
                             "oracle")

    s2, d2 = random_blob_edges(np.random.default_rng(SEED + 4),
                               truth["2ecc"], STREAM_SECOND)
    stream_step(engine, rec, "second_ingest",
                lambda: ingest(s2, d2, False))
    streamed.append(rec["second_ingest"])
    rec["second_ingest"].update(
        edges_per_s=STREAM_SECOND / rec["second_ingest"]["seconds"],
        counters=engine.snapshot()["ingest"])
    mirror.insert(s2, d2)
    for kind in analysis_kinds():
        got = stream_step(engine, rec, f"after_{kind}",
                          lambda: engine.current_analysis(kind))
        streamed.append(rec[f"after_{kind}"])
        want = (analyze(mirror.src, mirror.dst, N_NODES, kind=kind)
                if check else truth[kind])
        if not same_answer(kind, got, want):
            raise AssertionError(f"{kind} after the second loop differs "
                                 f"from the {'oracle' if check else 'truth'}")
    if rec["second_ingest"]["misses_added"]:
        raise AssertionError("the second ingest loop built a program")
    rec["snapshot"] = engine.snapshot()
    rec["streamed_bytes"] = {"live_bytes": engine.live_bytes,
                             "peak_live_bytes": engine.peak_live_bytes}
    if not (rec["streamed_bytes"]["peak_live_bytes"]
            < rec["one_shot_bytes"]["peak_live_bytes"]):
        raise AssertionError("the streamed peak is not below the one-shot")
    launches = {name: sum(step["launches"][name] for step in streamed)
                for name in KERNEL_WRAPPERS}
    rec["streamed_launches"] = launches
    emit(rec)
    return launches


def phase_streaming(src, dst, planted, truth, smi: str) -> dict:
    """Streaming ingest on the card (module docstring, phase 5d), cold then
    warm on one engine; then the three kernels bit for bit at the chunk
    shapes, off the recorded calls of one more ragged ingest, a
    ring-replaying deletion and a ``bridges`` query on the warm live
    graph. Returns each kernel's launches in the warm run; fails where it
    launched no ``boruvka_round``."""
    engine = BridgeEngine()
    run_streaming(engine, src, dst, planted, truth, "cold", check=True)
    launches = run_streaming(engine, src, dst, planted, truth, "warm",
                             check=False)
    s3, d3 = random_blob_edges(np.random.default_rng(SEED + 5),
                               truth["2ecc"], STREAM_STEP)
    keys = streamed_delete_keys(engine,
                                LiveMirror(*engine._live.stream.to_numpy()),
                                planted, np.random.default_rng(SEED + 6))
    calls = {}
    with recording_kernels(calls):
        engine.ingest_chunk(s3, d3)
        engine.delete_edges(*keys)
        engine.current_analysis("bridges")
    cert_cap = certificate_capacity(engine._live.n_bucket)
    calls = {name: args[:STREAM_CHECK_CALLS] for name, args in calls.items()}
    checked = [check_recorded(label, calls, select, "streaming_kernel_check")
               for label, select in (
        ("chunk_fold", lambda name, args: (
            name == "boruvka_round" and args[0].numel() == STREAM_CHUNK)),
        ("chunk_rescan", lambda name, args: (
            name == "frontier_round"
            and args[0].numel() == cert_cap + STREAM_CHUNK)),
        ("chunk_finals", lambda name, args: name == "segment_min"))]
    if not all(checked):
        raise AssertionError("a chunk shape was not recorded")
    del calls, engine
    if not launches["boruvka_round"]:
        raise AssertionError("the streaming phase launched no boruvka_round")
    emit({"phase": "streaming_launches", "card": smi, "launches": launches})
    return {name: n for name, n in launches.items() if n}


def phase_streaming_sharded(src, dst, truth) -> None:
    """``simulate_stream_merge_host`` at M = ``DIST_MACHINES``, ``paper``:
    every machine streams its shard row (2^21 slots, about 1.25 M edges)
    through its own ``STREAM_CHUNK`` chunks, then the merge levels; cold
    then warm, each with the launch counts set to 0 just before and read
    just after, under a live tracer; machine 0's answer with both finals
    against the planted truth."""
    shards, cap = stacked_shards(src, dst, DIST_MACHINES)
    rows = [EdgeList(shards[0][i], shards[1][i], shards[2][i], N_NODES)
            for i in range(DIST_MACHINES)]
    for kind, cert in DIST_KINDS.items():
        rec = {"phase": "streaming_sharded", "schedule": "paper",
               "kind": kind, "certificate": cert,
               "machines": DIST_MACHINES, "shard_slots": cap}
        for run in ("cold", "warm"):
            tr = enable_tracing()
            try:
                (merged, streams), rec[run] = timed(
                    lambda: simulate_stream_merge_host(
                        rows, STREAM_CHUNK, "paper", certificate=cert))
            finally:
                disable_tracing()
            roll = tr.rollup()
            rec[run].update(
                ingest_s=roll["stage/ingest"]["total_s"],
                levels_s={name: row["total_s"] for name, row in roll.items()
                          if name.startswith("merge/level")},
                host_syncs_in_round_loops=(
                    rec[run]["launches"]["boruvka_round"]
                    + rec[run]["launches"]["frontier_round"]),
                chunks=[st.chunks_in for st in streams],
                folds=[st.folds for st in streams])
        check_answers(merged, "paper", kind, truth, rec)
        emit(rec)
    del shards, rows


# ---------------------------------------------------------------- repairs
#: graphs naming a vertex outside [0, n), and the JAX package's answers to
#: them (``repro.engine.BridgeEngine``, JAX on the CPU): sets as sorted
#: lists (a block as its sorted members), 2ecc labels as a list, and the
#: exception a call raises as its name
REPAIR_SINGLE = [
    (([0], [16], 16, "bridges"), []),
    (([-1], [0], 2, "cuts"), []),
    (([0], [16], 16, "cuts"), []),
    (([0], [16], 16, "2ecc"), list(range(15)) + [0]),
    (([0], [16], 16, "bridge_tree"), []),
    (([0], [16], 16, "bcc"), [[0, 16]]),
]
REPAIR_BATCH = {
    "path_into_n": ([([0, 1, 16], [1, 2, 3]), ([0, 1, 2], [1, 2, 3])], {
        ("bridges", "device"): [[(0, 1), (1, 2)], [(0, 1), (1, 2), (2, 3)]],
        ("bridges", "host"): "IndexError",
        ("cuts", "device"): [[1], [1, 2]],
        ("cuts", "host"): [[1], [1, 2]],
        ("2ecc", "device"): [list(range(15)) + [3], list(range(16))],
        ("2ecc", "host"): "IndexError",
        ("bridge_tree", "device"): [[(0, 1), (1, 2)],
                                    [(0, 1), (1, 2), (2, 3)]],
        ("bridge_tree", "host"): "IndexError",
        ("bcc", "device"): [[[0, 1], [1, 2], [3, 16]],
                            [[0, 1], [1, 2], [2, 3]]],
        ("bcc", "host"): [[[0, 1], [1, 2]], [[0, 1], [1, 2], [2, 3]]]}),
    "edge_at_n": ([([16], [0]), ([0], [1])], {
        ("bridges", "device"): [[], [(0, 1)]],
        ("bridges", "host"): "IndexError"}),
    "negative": ([([-1], [0]), ([0], [1])], {
        ("bridges", "device"): [[], [(0, 1)]],
        ("bridges", "host"): [[(-1, 0)], [(0, 1)]]}),
}


def plain(x):
    """An answer in the form of ``REPAIR_*``."""
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, list):
        return [plain(y) for y in x]
    if isinstance(x, set) and any(isinstance(y, frozenset) for y in x):
        return sorted(sorted(b) for b in x)
    if isinstance(x, set):
        return sorted(x)
    return x


def phase_repairs(device="cuda") -> dict:
    """The inputs of the two repaired faults on ``device``, each answer
    against the JAX package's: ids outside ``[0, n)`` through ``analyze``
    with the device final (every kind), and batches where one row names a
    vertex outside the batch's bucket through ``analyze_batch`` (the
    first, every kind x final). Only the ``IndexError`` the JAX package
    raises too is caught: a device-side assert fails the run."""
    checked = 0
    for (s, d, n, kind), want in REPAIR_SINGLE:
        got = plain(analyze(s, d, n, kind=kind, final="device",
                            device=device))
        if got != want:
            raise AssertionError(f"analyze({s}, {d}, {n}, kind={kind!r}) "
                                 f"gave {got}, the JAX package {want}")
        checked += 1
    engine = BridgeEngine(device=device)
    for name, (graphs, answers) in REPAIR_BATCH.items():
        for (kind, final), want in answers.items():
            try:
                got = plain(engine.analyze_batch(graphs, 16, kind=kind,
                                                 final=final))
            except IndexError:
                got = "IndexError"
            if got != want:
                raise AssertionError(f"analyze_batch {name} {kind}/{final} "
                                     f"gave {got}, the JAX package {want}")
            checked += 1
    sync_if_card(device)
    rec = {"phase": "repairs", "device": str(device), "checked": checked,
           "programs": len(engine._cache)}
    emit(rec)
    return rec


def sync_if_card(device) -> None:
    if torch.device(device).type == "cuda":
        sync()


# ------------------------------------------- the scheduler, checkpoints, failover
#: the scheduler phase: ``benchmarks/fig10_serving.py``'s fixed submission
#: script at the engine phase's batch width: SCHED_TENANTS tenants of
#: SCHED_PER_TENANT requests, request i a planted graph of BATCH_N - i % 7
#: vertices and BATCH_E edges with SCHED_BRIDGES bridges (seed i), all in
#: one admission bucket (16,384 vertices, 2^21 slots); the coalescing window
SCHED_TENANTS, SCHED_PER_TENANT, SCHED_BRIDGES = 4, 6, 3
SCHED_MAX_BATCH = 8
#: the counters ``BENCH_baseline_fig10.json`` pins for that script, which
#: depend on the script only
FIG10_PINNED = {"dispatches": 12, "coalesced": 59, "padded_slots": 5,
                "writes": 4, "occupancy_x100": 492}
#: recorded kernel calls held against the plain versions, per kernel
SCHED_CHECK_CALLS = 48
#: the calls kept per (slots, n) shape of a kernel in a recorded serving
#: run: every shape the run gives a kernel is held, its kept inputs bounded
SERVE_PER_SHAPE = 8
#: the checkpoint phase's cadence (every second write saves)
CKPT_EVERY = 2
#: ``benchmarks/fig11_failover.py``'s drills: no kill, then machine 0 (a
#: ``paper`` block owner) killed at phase boundary 1, recovered from a
#: per-boundary snapshot or by re-certifying its shard
FAILOVER_VICTIM, FAILOVER_BOUNDARY = 0, 1
FAILOVER_DRILLS = ("clean", "checkpoint", "recertify")
#: ``launch.failover.serve_failover``'s arguments; ``edges`` cut from the
#: Fig. 2 point's 10,000,000 to 1,000,000: the drill checks every step by a
#: host Tarjan over every live edge, tens of seconds a step at 10 M
FAILOVER_DRILL = {"machines": 8, "steps": 6, "kill_machine": 1,
                  "kill_at_step": 2, "ckpt_every": 1, "n": 100_000,
                  "edges": 1_000_000, "delta_edges": 4096,
                  "schedule": "paper", "seed": 0}
#: the device of these phases' engines and fleets
DEVICE = "cuda"

# ------------------------------------------ the serving driver and the baseline
#: the full serving width of the serve_driver phase: the scheduler phase's
#: graphs (12,500 x 1,250,000, jittered by ``make_queries`` inside one
#: 16,384-vertex, 2^21-slot bucket), 6 queries a reader, batch 8
SERVE_WIDTH = ["--n", str(BATCH_N), "--edges", str(BATCH_E), "--queries",
               "6", "--batch", "8"]
#: the serve_driver phase's runs, (label, argv): the CLI's own defaults,
#: then the full width, then the ingest drill at the Fig. 2 point with the
#: streaming phase's 2^20-edge chunks, each with ``--verify``; and the
#: width's ``multitenant`` without it, the host Tarjan then out of its walls
SERVE_RUNS = [
    ("defaults/insert", ["--analysis", "all", "--verify"]),
    ("defaults/churn", ["--analysis", "all", "--workload", "churn",
                        "--verify"]),
    ("defaults/multitenant", ["--workload", "multitenant", "--tenants", "4",
                              "--deltas", "16", "--arrival-qps", "0",
                              "--verify"]),
    ("width/multitenant", ["--workload", "multitenant", *SERVE_WIDTH,
                           "--verify"]),
    ("width/multitenant/unverified", ["--workload", "multitenant",
                                      *SERVE_WIDTH]),
    ("width/insert", ["--analysis", "all", *SERVE_WIDTH, "--verify"]),
    ("fig2/ingest", ["--workload", "ingest", "--n", str(N_NODES), "--edges",
                     str(N_EDGES), "--chunk-edges", str(1 << 20),
                     "--verify"]),
]
#: the runs whose recorded kernel calls are held bit for bit, each with the
#: calls it keeps per (slots, n) shape of a kernel (None: every call, of
#: which the last ``SCHED_CHECK_CALLS`` are held)
SERVE_RECORDED = {"defaults/insert": SERVE_PER_SHAPE,
                  "defaults/multitenant": None,
                  "width/insert": SERVE_PER_SHAPE}
#: the argv whose report on the card must equal the port's on the CPU
SERVE_HOLD = ["--smoke", "--analysis", "all"]
#: ``benchmarks/fig5_baseline.py``'s point: V vertices, the edge counts,
#: ``random_graph``'s seed; warm runs timed after a warmup
FIG5_V, FIG5_EDGES, FIG5_SEED = 128, (256, 1024, 4096, 8128), 3
FIG5_RUNS, FIG5_WARMUP = 5, 2


def enclosing_span(prefixes: tuple):
    """(name, index) of the innermost open tracer span whose name starts
    with one of ``prefixes``, or None."""
    for sp in reversed(getattr(get_tracer(), "_stack", ())):
        if sp.name.startswith(prefixes):
            return sp.name, sp.index
    return None


def sched_requests() -> list:
    """fig10's request set at the batch width: (tenant, src, dst, n,
    planted bridges) per request."""
    reqs = []
    for i in range(SCHED_TENANTS * SCHED_PER_TENANT):
        n = BATCH_N - i % 7
        s, d, planted = gen.planted_bridge_graph(n, BATCH_E, SCHED_BRIDGES,
                                                 seed=i)
        reqs.append((f"t{i % SCHED_TENANTS}", s, d, n, planted))
    return reqs


def hold_tickets(tickets, rows, kind: str = "bridges") -> int:
    """Each ticket's answer against its row's planted truth."""
    for t, (_, _, _, n, planted) in zip(tickets, rows, strict=True):
        if not same_answer(kind, t.result(),
                           planted_truth(n, SCHED_BRIDGES, planted)[kind]):
            raise AssertionError(f"scheduler: ticket {t.seq} ({t.tenant}/"
                                 f"{t.op}/{kind}) missed its planted truth")
    return len(tickets)


def plain_edge_keys(rng, src, dst, planted: set, k: int) -> tuple:
    """``k`` distinct edges of the graph that are not planted bridges: a
    deletion that leaves every planted bridge and blob as it was."""
    bridges = np.array([pair_keys(*p)[()] for p in planted])
    pick = rng.choice(np.flatnonzero(~np.isin(pair_keys(src, dst), bridges)),
                      k, replace=False)
    return src[pick], dst[pick]


def phase_scheduler(smi: str) -> dict:
    """fig10's submission script through ``BridgeScheduler(max_batch=8)``
    on the card (module docstring, phase 5g), then one scheduler dispatch's
    kernel calls bit for bit against the plain versions. Returns each
    connectivity kernel's launches over the scheduled runs."""
    reqs = sched_requests()
    total = len(reqs)
    engine = BridgeEngine(device=DEVICE)
    metrics = MetricsRegistry()
    sched = BridgeScheduler(engine, max_batch=SCHED_MAX_BATCH,
                            metrics=metrics)
    rec = {"phase": "scheduler", "card": smi, "tenants": SCHED_TENANTS,
           "per_tenant": SCHED_PER_TENANT, "max_batch": SCHED_MAX_BATCH,
           "n": BATCH_N, "edges": BATCH_E,
           "row_slots": admission_capacity(BATCH_E, MIN_BUCKET)}
    held = 0
    # warmup: the one-graph program, the power-of-two batched programs and
    # the live graph's insert/delete/final programs
    _, s0, d0, n0, p0 = reqs[0]
    sync()
    t0 = time.perf_counter()
    if engine.analyze(s0, d0, n0) != p0:
        raise AssertionError("scheduler warmup: analyze missed the truth")
    b = 1
    while b <= SCHED_MAX_BATCH:
        tickets = [sched.submit("_warm", s0, d0, n0) for _ in range(b)]
        sched.drain_all()
        held += hold_tickets(tickets, [reqs[0]] * b)
        b *= 2
    rng = np.random.default_rng(SEED + 7)
    blobs = planted_truth(n0, SCHED_BRIDGES, p0)["2ecc"]
    inserts = [random_blob_edges(rng, blobs, ENGINE_INSERT) for _ in range(3)]
    deletes = [plain_edge_keys(rng, s0, d0, p0, ENGINE_KEYS)
               for _ in range(3)]
    engine.load(s0, d0, n0)
    if (engine.insert_edges(*inserts[0]) != p0
            or engine.delete_edges(*deletes[0]) != p0):
        raise AssertionError("scheduler warmup: a live write missed the "
                             "truth")
    sync()
    rec["warmup_s"] = time.perf_counter() - t0
    warm_traces = engine.stats.traces
    rec["warm_cache"] = engine.cache_info()

    # the sequential loop: one analyze per request
    sync()
    t0 = time.perf_counter()
    seq = [engine.analyze(s, d, n) for _, s, d, n, _ in reqs]
    sync()
    rec["sequential_s_per_query"] = (time.perf_counter() - t0) / total
    if any(got != r[4] for got, r in zip(seq, reqs)):
        raise AssertionError("scheduler: a sequential answer missed")
    held += total

    # everything submitted, then drained; launches and peak bytes from here
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    tickets = [sched.submit(t, s, d, n) for t, s, d, n, _ in reqs]
    sched.drain_all()
    sync()
    rec["scheduled_s_per_query"] = (time.perf_counter() - t0) / total
    rec["speedup_vs_sequential"] = (rec["sequential_s_per_query"]
                                    / rec["scheduled_s_per_query"])
    held += hold_tickets(tickets, reqs)
    p99 = {t: metrics.histogram(f"sched/tenant/{t}/latency_s").percentile(
        0.99) for t in sched.tenants() if t != "_warm"}
    rec["tenant_p99_s"] = {"worst": max(p99.values()),
                           "best": min(p99.values())}

    # ragged waves: occupancy varies, programs must not
    ragged = iter(reqs)
    for wave in (5, 3, 1, 7):
        rows = [next(ragged) for _ in range(wave)]
        tickets = [sched.submit(t, s, d, n) for t, s, d, n, _ in rows]
        sched.drain()
        held += hold_tickets(tickets, rows)

    # the churn turn: reads coalesce, writes run between read waves
    rows = reqs[:SCHED_TENANTS]
    reads = [sched.submit(t, s, d, n) for t, s, d, n, _ in rows]
    writes = [sched.submit("t0", *inserts[1 + k // 2], op="insert_edges")
              if k % 2 == 0 else
              sched.submit("t0", *deletes[1 + k // 2], op="delete_edges")
              for k in range(4)]
    sync()
    t0 = time.perf_counter()
    sched.drain_all()
    sync()
    rec["churn_turn_s"] = time.perf_counter() - t0
    held += hold_tickets(reads, rows)
    held += hold_tickets(writes, [reqs[0]] * len(writes))
    st = sched.stats
    rec["counters"] = {"dispatches": st.dispatches,
                       "coalesced": st.coalesced,
                       "padded_slots": st.padded_slots, "writes": st.writes,
                       "occupancy_x100": round(100 * st.occupancy)}
    rec["warm_retraces"] = engine.stats.traces - warm_traces
    rec["cache"] = engine.cache_info()
    if rec["counters"] != FIG10_PINNED:
        raise AssertionError(f"scheduler counters {rec['counters']} are not "
                             f"fig10's {FIG10_PINNED}")
    if rec["warm_retraces"]:
        raise AssertionError(f"scheduler: {rec['warm_retraces']} program(s) "
                             f"built after warmup")
    launches = launch_counts()

    # one more wave of cuts with the host final: frontier_round under the
    # scheduler (a new program family, after the pinned counters)
    reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    tickets = [sched.submit(t, s, d, n, kind="cuts", final="host")
               for t, s, d, n, _ in rows]
    sched.drain_all()
    sync()
    rec["cuts_wave_s"] = time.perf_counter() - t0
    cuts_launches = launch_counts()
    held += hold_tickets(tickets, rows, "cuts")
    rec["launches"] = {"scheduled": launches, "cuts_wave": cuts_launches}
    rec["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    rec["answers_held"] = held
    rec["scheduler_snapshot"] = {k: v for k, v in sched.snapshot().items()
                                 if k != "tenants"}
    emit(rec)

    # one full dispatch's kernel calls, bit for bit
    calls = {}
    rows = reqs[:SCHED_MAX_BATCH]
    with recording_kernels(calls):
        tickets = [sched.submit(t, s, d, n) for t, s, d, n, _ in rows]
        sched.drain_all()
    hold_tickets(tickets, rows)
    union = SCHED_MAX_BATCH * admission_capacity(BATCH_E, MIN_BUCKET)
    calls = {name: args[:SCHED_CHECK_CALLS] for name, args in calls.items()}
    checked = check_recorded("scheduler_dispatch", calls, lambda name, args: (
        name != "boruvka_round" or args[0].numel() == union),
        "scheduler_kernel_check")
    if {r["name"] for r in checked} < {"boruvka_round", "segment_min"}:
        raise AssertionError("the scheduler's dispatch ran no union round "
                             "or no segment_min")
    del calls, engine, sched
    out = {name: launches[name] + cuts_launches[name]
           for name in ("boruvka_round", "frontier_round", "segment_min")}
    if not (launches["boruvka_round"] and launches["segment_min"]
            and cuts_launches["frontier_round"]):
        raise AssertionError(f"the scheduler phase launched {out}")
    return out


def dir_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.iterdir())


def phase_checkpoint(src, dst, planted, truth, smi: str) -> None:
    """The live Fig. 2 graph under ``enable_checkpoints(every=2)`` (module
    docstring, phase 5h), in a temporary directory removed at the end."""
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-ckpt-"))
    try:
        engine = BridgeEngine(device=DEVICE)
        policy = engine.enable_checkpoints(tmp, every=CKPT_EVERY)
        rng = np.random.default_rng(SEED + 8)

        def insert():
            got = engine.insert_edges(*random_blob_edges(
                rng, truth["2ecc"], ENGINE_INSERT))
            if got != planted:
                raise AssertionError("checkpoint: an insert missed the "
                                     "planted bridges")

        engine.load(src, dst, N_NODES)
        if engine.current_analysis("bridges") != planted:
            raise AssertionError("checkpoint: load missed the truth")
        tr = enable_tracing()
        try:
            for _ in range(4):
                insert()
            sync()
        finally:
            disable_tracing()
        if policy.saves != 2:
            raise AssertionError(f"checkpoint: {policy.saves} cadence saves "
                                 f"in 4 writes at every={CKPT_EVERY}")
        steps = policy.manager.steps()
        rec = {"phase": "checkpoint", "card": smi, "every": CKPT_EVERY,
               "n": N_NODES, "edges": N_EDGES,
               "full_slots": int(engine._live.full[0].numel()),
               "bytes_per_save": {s: dir_bytes(tmp / f"step-{s:010d}")
                                  for s in steps},
               "write_s": [sp["dur"] for sp in tr.spans()
                           if sp["name"] == "engine/insert_edges"],
               "save_s": [sp["dur"] for sp in tr.spans()
                          if sp["name"] == "engine/checkpoint_maybe"
                          and sp["attrs"]["step"] % CKPT_EVERY == 0]}
        at_snapshot = engine.current_analysis("bridges")
        sync()
        t0 = time.perf_counter()
        engine.checkpoint_now()
        rec["checkpoint_now_s"] = time.perf_counter() - t0
        insert()  # drift past the snapshot
        programs = set(engine._cache.keys())
        rec["before_restore"] = engine.cache_info()
        for run in ("cold", "warm"):
            sync()
            t0 = time.perf_counter()
            step = engine.restore_live()
            sync()
            rec[f"restore_{run}_s"] = time.perf_counter() - t0
            if (engine.stats.traces != rec["before_restore"]["traces"]
                    or set(engine._cache.keys()) != programs):
                raise AssertionError("restore_live ran a program")
        rec["restored_step"] = step
        rec["after_restore"] = engine.cache_info()
        live = engine._live
        devices = {t.device.type for t in live.full} | {
            t.device.type for state in live.certs.values()
            if state is not None for t in state}
        rec["restored_on"] = sorted(devices)
        if devices != {torch.device(DEVICE).type}:
            raise AssertionError(f"restored arrays on {devices}")
        got = engine.current_analysis("bridges")
        if got != at_snapshot or got != planted:
            raise AssertionError("after restore_live the answer differs "
                                 "from the snapshot's")
        traces = engine.stats.traces
        sync()
        t0 = time.perf_counter()
        for _ in range(3):
            insert()
        sync()
        rec["warm_inserts_after_restore_s"] = time.perf_counter() - t0
        if engine.stats.traces != traces:
            raise AssertionError("an insert after restore_live built a "
                                 "program")
        rec["snapshot"] = engine.snapshot()["checkpoint"]
        rec["final_cache"] = engine.cache_info()
        emit(rec)
        del engine, live
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def failover_injector(drill: str) -> FailureInjector:
    return FailureInjector(kill_schedule=None if drill == "clean" else
                           {FAILOVER_VICTIM: FAILOVER_BOUNDARY})


def failover_infos_cpu(kind: str) -> dict:
    """Each drill's info dict on the CPU, for the same machines, schedule,
    kill and cadence on a small graph (96 vertices, 2,000 edges): the dict
    depends only on those."""
    s, d, _ = gen.planted_bridge_graph(96, 2000, 3, seed=7)
    ps, pd, pm = partition_edges(s, d, 96, DIST_MACHINES, seed=1)
    rows = [EdgeList(torch.from_numpy(ps[i]), torch.from_numpy(pd[i]),
                     torch.from_numpy(pm[i]), 96)
            for i in range(DIST_MACHINES)]
    certify = certificate_builder(DIST_KINDS[kind])
    return {drill: simulate_failover_host(
        rows, "paper", failover_injector(drill), certify=certify,
        checkpoint_every=1 if drill == "checkpoint" else None)[2]
        for drill in FAILOVER_DRILLS}


def phase_failover(src, dst, truth, smi: str) -> dict:
    """``fig11``'s three drills of ``simulate_failover_host`` on the Fig. 2
    shards (module docstring, phase 5i), then one recovery fold's and one
    re-merge level's kernel calls bit for bit. Returns each connectivity
    kernel's launches over the warm drills."""
    shards, cap = stacked_shards(src, dst, DIST_MACHINES)
    rows = [EdgeList(shards[0][i], shards[1][i], shards[2][i], N_NODES)
            for i in range(DIST_MACHINES)]
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-fleet-"))
    launches = {}
    try:
        for kind, cert in DIST_KINDS.items():
            certify = certificate_builder(cert)
            expected = failover_infos_cpu(kind)
            for drill in FAILOVER_DRILLS:
                rec = {"phase": "failover", "card": smi, "schedule": "paper",
                       "kind": kind, "certificate": cert, "drill": drill,
                       "machines": DIST_MACHINES, "shard_slots": cap,
                       "kill": (None if drill == "clean" else
                                {"machine": FAILOVER_VICTIM,
                                 "boundary": FAILOVER_BOUNDARY})}
                for run in ("cold", "warm"):
                    store = (MachineCheckpoints(tmp / f"{kind}-{run}")
                             if drill == "checkpoint" else None)

                    def call():
                        t0 = time.perf_counter()
                        out = simulate_failover_host(
                            rows, "paper", failover_injector(drill),
                            certify=certify,
                            checkpoint_every=1 if store else None,
                            checkpoints=store)
                        sync()
                        seconds = time.perf_counter() - t0
                        alive, certs, info = out
                        got = answer(certs[alive.index(info["answering"])],
                                     kind, "device")
                        return out, got, seconds

                    tr = enable_tracing()
                    try:
                        ((alive, certs, info), got, drill_s), rec[run] = \
                            timed(call)
                    finally:
                        disable_tracing()
                    roll = tr.rollup()
                    rec[run].update(
                        drill_s=drill_s,
                        spans_s={name: row["total_s"]
                                 for name, row in roll.items()
                                 if name.startswith(("recover/",
                                                     "merge/"))})
                    if not same_answer(kind, got, truth[kind]):
                        raise AssertionError(f"failover {drill}/{kind}: the "
                                             f"answer missed the truth")
                    if info != expected[drill]:
                        raise AssertionError(
                            f"failover {drill}/{kind}: info {info} differs "
                            f"from the CPU's {expected[drill]}")
                    if drill == "clean":
                        if info["restarts"]:
                            raise AssertionError("the clean drill restarted")
                    else:
                        if info["recoveries"][0]["source"] != drill:
                            raise AssertionError(
                                f"failover {drill}: recovered by "
                                f"{info['recoveries'][0]['source']}")
                        ans = certs[alive.index(info["answering"])]
                        for c in certs:
                            if not all(torch.equal(getattr(c, f),
                                                   getattr(ans, f))
                                       for f in ("src", "dst", "mask")):
                                raise AssertionError(
                                    "a survivor's certificate differs from "
                                    "the answering one")
                    if run == "warm":
                        for name, n in rec[run]["launches"].items():
                            launches[name] = launches.get(name, 0) + n
                rec["info"] = info
                del certs
                emit(rec)

        # one recovery fold's and one re-merge level's kernel calls
        calls = {}
        tr = enable_tracing()
        try:
            with recording_kernels(calls, key=lambda: enclosing_span(
                    ("recover/fold", "merge/level"))):
                simulate_failover_host(rows, "paper",
                                       failover_injector("recertify"))
        finally:
            disable_tracing()
        fold = min(k for k in calls if k and k[0] == "recover/fold")
        level = min((k for k in calls
                     if k and k[0].startswith("merge/level") and k[1] > fold[1]),
                    key=lambda k: k[1])
        for label, key in (("recover_fold", fold), ("remerge_" + level[0][6:],
                                                    level)):
            got = {name: args[:SCHED_CHECK_CALLS]
                   for name, args in calls[key].items()}
            if not check_recorded(label, got, lambda name, args: True,
                                  "failover_kernel_check"):
                raise AssertionError(f"{label}: no kernel call recorded")
        del calls
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del rows, shards
    if not launches.get("boruvka_round") or not launches.get("segment_min"):
        raise AssertionError(f"the failover phase launched {launches}")
    return {name: n for name, n in launches.items() if n}


def phase_failover_drill(smi: str) -> None:
    """``serve_failover`` with ``FAILOVER_DRILL`` on the card (module
    docstring, phase 5j)."""
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-serve-"))
    counters = ("failures/injected", "failures/recovered",
                "fleet/dead_machines")
    try:
        args = types.SimpleNamespace(**FAILOVER_DRILL, ckpt_dir=str(tmp))
        tr = enable_tracing()
        try:
            report, rec = timed(lambda: serve_failover(args, device=DEVICE))
        finally:
            disable_tracing()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report.pop("ckpt_dir")
    rec.update(phase="failover_drill", card=smi, args=FAILOVER_DRILL,
               step_s_mean=rec["seconds"] / FAILOVER_DRILL["steps"],
               spans_s={name: row["total_s"]
                        for name, row in tr.rollup().items()
                        if name.startswith(("merge/", "recover/"))},
               report=report)
    emit(rec)
    if not report["final_parity"] or report["parity_failures_post_recovery"]:
        raise AssertionError("failover_drill: parity failed")
    if report["recovery"]["source"] != "checkpoint":
        raise AssertionError(f"failover_drill: recovered by "
                             f"{report['recovery']['source']}")
    if report["counters"] != {name: 1 for name in counters}:
        raise AssertionError(f"failover_drill counters {report['counters']}")


def phase_serve_driver(smi: str) -> dict:
    """``launch/serve_bridges.py::main`` on the card, once per workload of
    ``SERVE_RUNS`` (module docstring, phase 5k), the recorded runs' kernel
    calls bit for bit, and the report hold against the CPU. Returns each
    connectivity kernel's launches summed over the runs."""
    total = {}
    for label, argv in SERVE_RUNS:
        calls = {}
        record = (recording_kernels(calls, per_shape=SERVE_RECORDED[label])
                  if label in SERVE_RECORDED else contextlib.nullcontext())
        with record:
            report, rec = timed(lambda: serve_bridges.main(argv,
                                                           device=DEVICE))
        launches = rec["launches"]
        emit({"phase": "serve_driver", "run": label, "argv": argv,
              "card": smi, "seconds": rec["seconds"], "launches": launches,
              "peak_device_bytes": rec["peak_device_bytes"],
              **{k: v for k, v in report.items() if k != "metrics"}})
        if not launches["boruvka_round"] or not launches["segment_min"]:
            raise AssertionError(f"serve_driver {label}: launched {launches}")
        if "--analysis" in argv and not launches["frontier_round"]:
            raise AssertionError(f"serve_driver {label}: no frontier_round "
                                 f"launch under --analysis all")
        for name in ("boruvka_round", "frontier_round", "segment_min"):
            total[name] = total.get(name, 0) + launches[name]
        if label in SERVE_RECORDED:
            if SERVE_RECORDED[label] is None:
                # the scheduler phase's calls: the last ones of the run
                calls = {name: args[-SCHED_CHECK_CALLS:]
                         for name, args in calls.items()}
            held = {r["name"] for r in check_recorded(
                f"serve_driver {label}", calls, lambda name, args: True,
                "serve_driver_kernel_check")}
            missed = {name for name in KERNEL_WRAPPERS
                      if launches[name]} - held
            if missed:
                raise AssertionError(f"serve_driver {label}: launched "
                                     f"{sorted(missed)} but held no call")
        del calls, report

    card = serve_bridges.main(SERVE_HOLD, device=DEVICE)
    cpu = serve_bridges.main(SERVE_HOLD, device="cpu")
    held = clock_free(card, kernel_path="path") == clock_free(
        cpu, kernel_path="path")
    emit({"phase": "serve_driver_hold", "argv": SERVE_HOLD, "held": held,
          "engine": {k: card["engine"][k] for k in ("programs", "hits",
                                                     "misses", "traces")}})
    if not held:
        raise AssertionError("serve_driver_hold: the card's report differs "
                             "from the CPU's")
    return total


def mask_pairs(src, dst, mask: np.ndarray) -> set:
    return {(min(int(a), int(b)), max(int(a), int(b)))
            for a, b in zip(src[mask], dst[mask])}


def wall_ms(fn, runs: int = FIG5_RUNS, warmup: int = FIG5_WARMUP) -> float:
    """Median host-clock milliseconds of ``fn()`` over ``runs`` calls after
    ``warmup`` calls, each call ending in a synchronize."""
    for _ in range(warmup):
        fn()
    sync_if_card(DEVICE)
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        sync_if_card(DEVICE)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_baseline(smi: str) -> int:
    """The Savage-Ja'Ja' baseline at Fig. 5's point (module docstring,
    phase 5l). Returns its ``boruvka_round`` launches over the points."""
    launches = 0
    for e in FIG5_EDGES:
        src, dst = gen.random_graph(FIG5_V, e, seed=FIG5_SEED)
        el = EdgeList.from_arrays(src, dst, FIG5_V, device=DEVICE)
        truth = bridges_dfs(src, dst, FIG5_V)
        calls = {}
        record = (recording_kernels(calls, ("boruvka_round",))
                  if e == FIG5_EDGES[-1] else contextlib.nullcontext())
        with record:
            mask, rec = timed(lambda: bridges_savage_jaja(el))
        got = mask_pairs(src, dst, mask.cpu().numpy())
        ours = find_bridges(src, dst, FIG5_V, final="device", device=DEVICE)
        if got != truth or ours != truth:
            raise AssertionError(f"baseline E={e}: {sorted(got)} / "
                                 f"find_bridges {sorted(ours)} / host "
                                 f"Tarjan {sorted(truth)}")
        line = {"phase": "baseline", "card": smi, "V": FIG5_V,
                "E": len(src), "bridges": len(truth),
                "launches": rec["launches"],
                "peak_device_bytes": rec["peak_device_bytes"],
                "chunk": chunk_slots(FIG5_V),
                "squarings": closure_squarings(FIG5_V),
                # the matrix products alone: E slots x squarings x 2 n^3
                "matmul_flop": len(src) * closure_squarings(FIG5_V)
                * 2 * FIG5_V ** 3}
        if e == FIG5_EDGES[0]:
            cpu = bridges_savage_jaja(EdgeList.from_arrays(src, dst, FIG5_V,
                                                           device="cpu"))
            line["max_abs_err_vs_cpu"] = require_equal(
                f"baseline E={e} card vs CPU", mask.cpu(), cpu)
        times = {
            "baseline_ms": lambda: bridges_savage_jaja(el),
            "fig5_ours_ms": lambda: bridges_device(sparse_certificate(el)),
            "find_bridges_ms": lambda: find_bridges(
                src, dst, FIG5_V, final="device", device=DEVICE)}
        line.update({name: wall_ms(fn) for name, fn in times.items()})
        line["baseline_over_ours"] = line["baseline_ms"] / line["fig5_ours_ms"]
        emit(line)
        if not rec["launches"]["boruvka_round"]:
            raise AssertionError(f"baseline E={e}: no boruvka_round launch")
        if calls and not check_recorded(f"baseline E={e}", calls,
                                        lambda name, args: True,
                                        "baseline_kernel_check"):
            raise AssertionError(f"baseline E={e}: no boruvka_round call "
                                 f"recorded")
        launches += rec["launches"]["boruvka_round"]
    return launches


def right_aligned(seq: np.ndarray) -> np.ndarray:
    """Each history of ``recsys_batches`` moved to end at the last position
    (padding first), as a served user's history is: the user state is the
    last position's, and a padded last position gives a zero state whose
    scores all tie."""
    order = np.argsort(seq != 0, axis=1, kind="stable")
    return np.take_along_axis(seq, order, axis=1)


def bag_library(table, idx, mask, mode: str):
    """``torch.nn.functional.embedding_bag`` on the same bags, masked
    entries dropped through ``offsets``; the conversion is done here, so
    the returned call times the library alone."""
    counts = mask.sum(1)
    offsets = torch.zeros_like(counts)
    offsets[1:] = counts.cumsum(0)[:-1]
    flat = idx[mask].long()
    offsets = offsets.long()
    return lambda: torch.nn.functional.embedding_bag(flat, table, offsets,
                                                     mode=mode)


def bag_histories(n_rows: int, batch: int, dev) -> tuple:
    """``batch`` SASRec histories of ``recsys_batches`` (seeded), right
    aligned, on the card, and their mask (padding id 0 masked)."""
    seq = right_aligned(recsys_batches(n_rows, batch, SASREC.seq_len,
                                       seed=SEED)(0)["seq"])
    idx = torch.as_tensor(seq, device=dev)
    return idx, idx != 0


def check_embedding_bag(table, flush) -> dict:
    """``embedding_bag`` on SASRec's item table against its plain version
    and the library call, every mode, at the retrieval step's shape (one
    bag of 50) and at the train batch's (65,536 bags of 50), on histories
    of ``recsys_batches`` with the padding masked; the first kernel
    (``previous_embedding_bag``) held to the same tolerance and timed
    beside it. Tolerance: rtol 1e-5, atol 1e-6 in float32 (the sums run in
    another order). The bound counts the sectors of the distinct rows each
    mode reads (``embedding_bag_bytes_read``); ``lookup_bytes`` counts a row
    once per lookup, which is more than the call must move.
    ``launch_floor_ms`` is the interval of an empty kernel's launch."""
    n_rows, dim = table.shape
    rec = {"name": "embedding_bag", "route": "cuda",
           "path": kernel_path(table.device),
           "source": "src/repro_torch/csrc/embedding_bag.cu",
           "replaces": "src/repro/kernels/embedding_bag/kernel.py:60",
           "bound_by": "bytes", "tolerance": {"rtol": 1e-5, "atol": 1e-6},
           "block_items_max": BLOCK_ITEMS_MAX,
           "library_note": "torch.nn.functional.embedding_bag on the same "
                           "bags, masked entries dropped through offsets "
                           "(that conversion untimed)"}
    errs = []
    for tag, batch in (("retrieval", 1),
                       ("train_batch",
                        RECSYS_SHAPES["train_batch"]["batch"])):
        idx, mask = bag_histories(n_rows, batch, table.device)
        shape = {"B": batch, "L": SASREC.seq_len, "V": n_rows, "D": dim,
                 "valid_entries": int(mask.sum()),
                 "lookup_bytes": embedding_bag_bytes(batch, SASREC.seq_len,
                                                     dim)}
        for mode in ("sum", "mean", "max"):
            nbytes = embedding_bag_bytes_read(table, idx, mask, mode)
            got = embedding_bag(table, idx, mask, mode)
            want = embedding_bag_ref(table, idx, mask, mode)
            library = bag_library(table, idx, mask, mode)
            for name, a, b in (
                    ("plain", got, want), ("library", got, library()),
                    ("previous kernel vs plain",
                     previous_embedding_bag(table, idx, mask, mode), want)):
                if not torch.allclose(a, b, rtol=1e-5, atol=1e-6):
                    raise AssertionError(
                        f"embedding_bag[{tag}, {mode}] differs from the "
                        f"{name} version: max abs err "
                        f"{float((a - b).abs().max())}")
            err = float((got - want).abs().max())
            errs.append(err)
            shape[mode] = {
                "max_abs_err": err, "bound_bytes": nbytes,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                **time_turns(
                    {"ms": lambda: embedding_bag(table, idx, mask, mode),
                     "previous_kernel_ms": lambda: previous_embedding_bag(
                         table, idx, mask, mode)}, flush),
                "plain_ms": time_ms(
                    lambda: embedding_bag_ref(table, idx, mask, mode), flush,
                    iters=5),
                "library_ms": time_ms(library, flush)}
        rec[tag] = shape
    path_shape = rec["retrieval"]
    rec.update(shape={"B": 1, "L": SASREC.seq_len, "V": n_rows, "D": dim,
                      "mode": "mean"},
               max_abs_err=max(errs), ms=path_shape["mean"]["ms"],
               previous_kernel_ms=path_shape["mean"]["previous_kernel_ms"],
               plain_ms=path_shape["mean"]["plain_ms"],
               library_ms=path_shape["mean"]["library_ms"],
               bound_ms=path_shape["mean"]["bound_ms"],
               bound_bytes=path_shape["mean"]["bound_bytes"],
               launch_floor_ms=time_ms(lambda: launch_floor(table.device),
                                       flush))
    return rec


#: bag counts of the threshold sweep: 1, 2, 4, ..., 65,536
SWEEP_BAGS = [2 ** k for k in range(17)]


def sweep_embedding_bag(table, flush) -> dict:
    """The block kernel against the first kernel at every bag count of
    ``SWEEP_BAGS`` (histories of 50, D 50, mean; at D <= 64 a bag is one
    work item), each held against the plain version; the block kernel
    wins up to ``block_wins_up_to`` bags, which ``BLOCK_ITEMS_MAX`` follows."""
    idx_all, mask_all = bag_histories(table.shape[0], SWEEP_BAGS[-1],
                                      table.device)
    points = []
    for batch in SWEEP_BAGS:
        idx, mask = idx_all[:batch], mask_all[:batch]
        want = embedding_bag_ref(table, idx, mask, "mean")
        for name, fn in (("block", block_embedding_bag),
                         ("previous", previous_embedding_bag)):
            got = fn(table, idx, mask, "mean")
            if not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
                raise AssertionError(f"embedding_bag sweep B={batch}: the "
                                     f"{name} kernel differs from the plain "
                                     f"version")
        points.append({"B": batch, **time_turns(
            {"block_ms": lambda: block_embedding_bag(table, idx, mask,
                                                     "mean"),
             "previous_kernel_ms": lambda: previous_embedding_bag(
                 table, idx, mask, "mean")}, flush)})
    wins = 0
    for point in points:
        if point["block_ms"] > point["previous_kernel_ms"]:
            break
        wins = point["B"]
    rec = {"phase": "embedding_bag_sweep", "L": SASREC.seq_len,
           "D": table.shape[1], "mode": "mean", "points": points,
           "block_wins_up_to": wins, "block_items_max": BLOCK_ITEMS_MAX}
    emit(rec)
    return rec


#: flash_attention's cases: (batch, Sq, Skv, dtype, what was cut); bf16
#: goes to flash_attention_mma, float32 to flash_attention_tf32x3
ATTN_CHECKS = {
    "prefill": (1, 8192, 8192, torch.bfloat16,
                "prefill_32k's length cut to 8,192 so that the plain "
                "version's 4.3 GB score tensor fits"),
    "decode": (32, 1, 32768, torch.bfloat16,
               "decode_32k's cache length; batch cut from 128 to 32"),
    "prefill_f32": (1, 8192, 8192, torch.float32,
                    "prefill_32k's length cut to 8,192 so that the plain "
                    "version's 4.3 GB score tensor fits"),
    "small_f32": (1, 512, 512, torch.float32, "a small float32 case"),
}
#: the case whose op call each kernel's main-path run makes, by kernel
ATTN_RUN_CASE = {"flash_attention_mma": "prefill",
                 "flash_attention_tf32x3": "prefill_f32"}
#: keys the planted "dropped tile" fault skips: the first kv tile
ATTN_DROPPED_KEYS = 64


def planted_faults(got, want, q, k, v) -> dict:
    """Two wrong outputs the gate must reject: the kernel's output halved,
    and the plain version with the first ``ATTN_DROPPED_KEYS`` keys skipped
    by every query row that sees past them (rows that see only those keys
    keep their value)."""
    sq, skv, cut = q.shape[1], k.shape[1], ATTN_DROPPED_KEYS
    r0 = max(0, cut - (skv - sq))  # causal: the first row that sees past
    dropped = torch.cat([want[:, :r0], attention_ref(
        q[:, r0:], k[:, cut:], v[:, cut:], causal=True)], dim=1)
    return {"halved": got * 0.5, "first_kv_tile_dropped": dropped}


def previous_kernel(q, k, v) -> torch.Tensor:
    """The first, float32-core kernel (csrc/flash_attention.cu), causal,
    through its entry and outside the op: a yardstick for the tensor-core
    kernels, never a path (its launches are not counted)."""
    return float32_core_kernel(q, k, v, True, q.shape[-1] ** -0.5)


def attention_bound(flops: int, nbytes: int, dtype) -> dict:
    """The least time of one call: the larger of its bytes over the memory
    rate and its operations over the fastest exact route for the dtype (bf16
    on the tensor cores; float32 on the float32 cores or as 3xTF32 on the
    tensor cores, the lesser)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if dtype == torch.bfloat16:
        routes = {"bf16 tensor cores": flops / BF16_FLOPS_PER_S * 1e3}
    else:
        routes = {"float32 cores": flops / F32_FLOPS_PER_S * 1e3,
                  "3xTF32 tensor cores": 3 * flops / TF32_FLOPS_PER_S * 1e3}
    route = min(routes, key=routes.get)
    by_ops = routes[route]
    return {"bound_ms": max(by_ops, by_bytes),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "bound_ops_route": route, "bound_ms_by_route": routes,
            "bound_ms_by_bytes": by_bytes}


def check_flash_attention(flush, dev) -> tuple:
    """``flash_attention`` at Qwen3-0.6B's attention widths, causal, against
    its plain version (float32 products, TF32 off) and, as the library
    yardstick, ``scaled_dot_product_attention`` with the kv heads repeated
    outside the timed window; the first, float32-core kernel is held under
    the gate and timed too (``previous_kernel_ms``). Each case records the
    kernel its op call launched. Then, per kernel, one op call on its
    case's inputs with the launch counts set to 0 just before and read just
    after. Returns the records by kernel and those calls' runs."""
    gen_ = torch.Generator(device=dev).manual_seed(SEED)
    hq, hkv, d = ATTN_HEADS, ATTN_KV_HEADS, ATTN_DIM
    recs = {name: {"name": name, "route": "cuda", "path": kernel_path(dev),
                   "source": f"src/repro_torch/csrc/{name}.cu",
                   "replaces": "src/repro/kernels/flash_attention/"
                               "kernel.py:78",
                   "heads": {"Hq": hq, "Hkv": hkv, "D": d},
                   "library_note": "torch.nn.functional."
                                   "scaled_dot_product_attention on "
                                   "[B, H, S, D] copies with the kv heads "
                                   "repeated (untimed); is_causal where "
                                   "Sq == Skv (a single query row sees "
                                   "every key)"}
            for name in ATTN_RUN_CASE}
    errs = {name: [] for name in ATTN_RUN_CASE}
    inputs = {}
    for tag, (b, sq, skv, dtype, cut) in ATTN_CHECKS.items():
        q, k, v = (torch.randn(shape, generator=gen_, device=dev).to(dtype)
                   for shape in ((b, sq, hq, d), (b, skv, hkv, d),
                                 (b, skv, hkv, d)))
        reset_launch_counts()
        got = flash_attention(q, k, v, causal=True)
        sync()
        ran = [name for name, n in launch_counts().items() if n]
        name = KERNEL_OF[dtype]
        if ran != [name]:
            raise AssertionError(f"flash_attention[{tag}] launched {ran}, "
                                 f"not {name}")
        want = attention_ref(q, k, v, causal=True)
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=sq == skv)

        vs_plain = attention_gate(got, want)
        if not vs_plain["pass"]:
            raise AssertionError(f"flash_attention[{tag}] differs from the "
                                 f"plain version: {vs_plain}")
        # the library rounds its probabilities to the input dtype: held by
        # the relative L2 error only
        vs_library = attention_gate(got, library().transpose(1, 2))
        if not vs_library["rel_l2"] < ATTN_GATES[dtype]["rel_l2"]:
            raise AssertionError(f"flash_attention[{tag}] differs from the "
                                 f"library call: {vs_library}")
        faults = {fault: attention_gate(bad, want) for fault, bad
                  in planted_faults(got, want, q, k, v).items()}
        if any(fault["pass"] for fault in faults.values()):
            raise AssertionError(f"flash_attention[{tag}]: the gate passes "
                                 f"a planted fault: {faults}")
        err = vs_plain["max_abs_err"]
        errs[name].append(err)
        flops = attention_flops(b, sq, skv, hq, d, causal=True)
        nbytes = attention_bytes(b, sq, skv, hq, hkv, d, q.element_size())
        previous = attention_gate(previous_kernel(q, k, v), want)
        if not previous["pass"]:
            raise AssertionError(f"flash_attention[{tag}]: the float32-"
                                 f"core kernel differs from the plain "
                                 f"version: {previous}")
        case = {
            "B": b, "Sq": sq, "Skv": skv, "dtype": str(dtype).split(".")[-1],
            "kernel": name, "cut": cut, "gate": ATTN_GATES[dtype],
            "max_abs_err": err, "vs_plain": vs_plain,
            "vs_library_rel_l2": vs_library["rel_l2"],
            "planted_faults": faults,
            "flops": flops, "bytes": nbytes,
            **attention_bound(flops, nbytes, dtype),
            "ms": time_ms(lambda: flash_attention(q, k, v), flush),
            "plain_ms": time_ms(lambda: attention_ref(q, k, v), flush,
                                iters=5, warmup=1),
            "library_ms": time_ms(library, flush),
            "previous_kernel_ms": time_ms(lambda: previous_kernel(q, k, v),
                                          flush),
            "previous_kernel_vs_plain": previous}
        recs[name][tag] = case
        inputs[tag] = (q, k, v)
        del got, want, qt, kt, vt
    runs = {}
    for name, tag in ATTN_RUN_CASE.items():
        sync()
        reset_launch_counts()
        flash_attention(*inputs[tag], causal=True)
        sync()
        runs[f"flash_attention({tag})"] = {"launches": launch_counts()}
        main_case = recs[name][tag]
        recs[name].update(
            max_abs_err=max(errs[name]), ms=main_case["ms"],
            plain_ms=main_case["plain_ms"],
            library_ms=main_case["library_ms"],
            bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"])
    return recs, runs


def params_to(params: dict, device) -> dict:
    """A copy of SASRec's parameters on ``device``."""
    out = {key: val.to(device) for key, val in params.items()
           if key != "blocks"}
    out["blocks"] = [{key: val.to(device) for key, val in blk.items()}
                     for blk in params["blocks"]]
    return out


def run_step(step: str, fn, args) -> tuple:
    """One recsys step, launch counts zeroed just before it and read just
    after; its output and record. The peak counts every live tensor: the
    weights (210 MB at full width) and this run's output among them."""
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn(*args)
    sync()
    seconds = time.perf_counter() - t0
    return out, {"phase": "recsys", "step": step, "seconds": seconds,
                 "launches": launch_counts(),
                 "peak_device_bytes": torch.cuda.max_memory_allocated()}


def phase_recsys(params) -> dict:
    """SASRec's three serving steps at full width, cold then warm, and
    their checks; then each under torch.profiler."""
    steps = make_recsys_steps(SASREC)
    bulk_seq = right_aligned(recsys_batches(
        SASREC.n_items, BULK_BATCH, SASREC.seq_len, seed=SEED)(0)["seq"])
    serve_seq = bulk_seq[:SERVE_BATCH]
    history = serve_seq[:1]
    hist_mask = history != 0
    candidates = np.random.default_rng(SEED).integers(
        1, SASREC.n_items, N_CANDIDATES).astype(np.int32)
    args = {"serve": (params, serve_seq), "bulk": (params, bulk_seq),
            "retrieval": (params, history, hist_mask, candidates)}
    shapes = {"serve": {"B": SERVE_BATCH, "S": SASREC.seq_len},
              "bulk": {"B": BULK_BATCH, "S": SASREC.seq_len, "k": 100,
                       "n_chunks": 64,
                       "cut": "serve_bulk's batch 262,144 cut to 32,768"},
              "retrieval": {"B": 1, "L": SASREC.seq_len,
                            "C": N_CANDIDATES}}
    runs, outs = {}, {}
    for step in ("serve", "bulk", "retrieval"):
        recs = []
        for run in ("cold", "warm"):
            outs.pop(step, None)  # the peak holds one output: this run's
            outs[step], rec = run_step(step, steps[step], args[step])
            rec.update(run=run, shape=shapes[step])
            emit(rec)
            recs.append(rec)
        if recs[0]["launches"] != recs[1]["launches"]:
            raise AssertionError(f"launch counts differ between runs of "
                                 f"{step}")
        runs[step] = recs[1]
        if step == "serve":  # keep the full scores' top-k, not the scores
            outs[step] = torch.topk(outs[step], 100, dim=-1).values
    if runs["retrieval"]["launches"]["embedding_bag"] != 1:
        raise AssertionError("retrieval did not launch embedding_bag once")

    cpu = params_to(params, "cpu")
    hidden = sasrec_hidden(params, serve_seq, SASREC).cpu()
    hidden_cpu = sasrec_hidden(cpu, serve_seq, SASREC)
    top_full = outs["serve"]
    top_bulk = outs["bulk"][0][:SERVE_BATCH]
    ret_cpu = steps["retrieval"](cpu, history, hist_mask, candidates)
    errs = {"hidden_vs_cpu": float((hidden - hidden_cpu).abs().max()),
            "bulk_topk_vs_serve_topk": float((top_bulk - top_full).abs().max()),
            "retrieval_vs_cpu": float((outs["retrieval"].cpu() - ret_cpu)
                                      .abs().max())}
    for name, got, want, tol in (
            ("hidden_vs_cpu", hidden, hidden_cpu, 1e-4),
            ("bulk_topk_vs_serve_topk", top_bulk, top_full, 1e-5),
            ("retrieval_vs_cpu", outs["retrieval"].cpu(), ret_cpu, 1e-5)):
        if not (torch.isfinite(got).all()
                and torch.allclose(got, want, rtol=tol, atol=tol)):
            raise AssertionError(f"recsys check {name} failed: max abs err "
                                 f"{errs[name]} (tolerance {tol})")
    emit({"phase": "recsys_check", "max_abs_err": errs,
          "tolerance": {"hidden_vs_cpu": 1e-4,
                        "bulk_topk_vs_serve_topk": 1e-5,
                        "retrieval_vs_cpu": 1e-5},
          "zero_user_states": int((hidden[:, -1].abs().sum(-1) == 0).sum())})
    del outs
    phase_profile("serve", lambda: steps["serve"](*args["serve"]),
                  lambda got: got.shape == (SERVE_BATCH, SASREC.n_items))
    phase_profile("bulk", lambda: steps["bulk"](*args["bulk"]),
                  lambda got: got[0].shape == (BULK_BATCH, 100))
    phase_profile("retrieval", lambda: steps["retrieval"](*args["retrieval"]),
                  lambda got: got.shape == (1, N_CANDIDATES))
    return runs


def train_step_record(train, p, opt, batch) -> tuple:
    """One train step, launch counts zeroed just before it and read just
    after, the peak reset before it; the new (params, state) and the
    step's record."""
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    p, opt, metrics = train(p, opt, batch)
    sync()
    seconds = time.perf_counter() - t0
    tokens = batch["seq"].size
    rec = {"seconds": seconds, "tokens_per_s": tokens / seconds,
           **{key: metrics[key].item() for key in ("loss", "grad_norm",
                                                   "lr")},
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "launches": launch_counts()}
    if not math.isfinite(rec["loss"]) or any(rec["launches"].values()):
        raise AssertionError(f"train step: loss {rec['loss']}, launches "
                             f"{rec['launches']}")
    return p, opt, rec


def phase_sasrec_train_check(params) -> None:
    """``make_recsys_steps(CONFIG)["train"]`` at full width for
    ``TRAIN_CHECK_STEPS`` steps of B = ``TRAIN_CHECK_BATCH`` on the card
    and on the CPU from the same weights and batches: loss, grad_norm and
    lr each step, then every param and state leaf, within the
    ``TRAIN_*`` tolerances (at most ``TRAIN_OUTSIDE_SHARE`` of a leaf's
    elements outside them: ReLU kinks); the step counter equal."""
    train = make_recsys_steps(SASREC)["train"]
    batches = recsys_batches(SASREC.n_items, TRAIN_CHECK_BATCH,
                             SASREC.seq_len, seed=SEED)
    card, cpu = params, params_to(params, "cpu")
    opt_card, opt_cpu = adamw_init(card), adamw_init(cpu)
    steps, lr_sum = [], 0.0
    for i in range(TRAIN_CHECK_STEPS):
        batch = batches(i)
        card, opt_card, rec = train_step_record(train, card, opt_card, batch)
        t0 = time.perf_counter()
        cpu, opt_cpu, want = train(cpu, opt_cpu, batch)
        rec["cpu_seconds"] = time.perf_counter() - t0
        for key in ("loss", "grad_norm", "lr"):
            rec[f"cpu_{key}"] = w = want[key].item()
            if abs(rec[key] - w) > TRAIN_SCALAR_RTOL * abs(w):
                raise AssertionError(f"train check step {i}: {key} "
                                     f"{rec[key]} on the card, {w} on the "
                                     f"CPU")
        lr_sum += rec["cpu_lr"]
        steps.append(rec)
    if opt_card["step"].dtype != torch.int32 or not torch.equal(
            opt_card["step"].cpu(), opt_cpu["step"]):
        raise AssertionError("train check: the step counters differ")
    worst, outside = {}, {}
    for label, got, want, atol in (
            ("params", card, cpu, TRAIN_LR_SHARE * lr_sum),
            ("master", opt_card["master"], opt_cpu["master"],
             TRAIN_LR_SHARE * lr_sum),
            ("m", opt_card["m"], opt_cpu["m"], 0.0),
            ("v", opt_card["v"], opt_cpu["v"], 0.0)):
        worst[label], outside[label] = 0.0, 0
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            if a.device.type != torch.device(DEVICE).type:
                raise AssertionError(f"train check: a {label} leaf left the "
                                     f"card")
            err = (a.cpu() - b).abs()
            scale = max(float(b.abs().max()), 1e-30)
            n_out = int((err > TRAIN_LEAF_TOL * scale + atol).sum())
            if n_out > TRAIN_OUTSIDE_SHARE * b.numel():
                raise AssertionError(
                    f"train check: {n_out} elements of a {label} leaf of "
                    f"shape {tuple(b.shape)} lie outside the tolerance "
                    f"(largest error {float(err.max())}, largest magnitude "
                    f"{scale})")
            outside[label] += n_out
            worst[label] = max(worst[label], float(err.max()) / scale)
    emit({"phase": "sasrec_train_check", "batch": TRAIN_CHECK_BATCH,
          "S": SASREC.seq_len, "steps": steps,
          "max_err_over_leaf_scale": worst, "elements_outside": outside,
          "lr_sum": lr_sum,
          "tolerance": {"scalars_rtol": TRAIN_SCALAR_RTOL,
                        "leaf": TRAIN_LEAF_TOL,
                        "params_lr_share": TRAIN_LR_SHARE,
                        "outside_share": TRAIN_OUTSIDE_SHARE}})


def phase_sasrec_train(params, smi: str) -> None:
    """SASRec's train step at train_batch's shape (B = 65,536, S = 50) on
    the full-width table: a cold step, then ``TRAIN_WARM_STEPS`` warm ones
    (``sasrec_train`` lines: seconds, tokens/s over the B x S positions,
    loss, grad_norm, lr, peak device bytes, launches; the batch is made on
    the host before the clock starts and copied inside the step); their
    median (``sasrec_train_summary``); one more warm step under
    torch.profiler. If the cold step runs out of device memory the batch
    halves until it fits, and the lines say so."""
    train = make_recsys_steps(SASREC)["train"]
    batch_size, cut = TRAIN_BATCH, None
    p, opt = params, adamw_init(params)
    while True:
        batches = recsys_batches(SASREC.n_items, batch_size, SASREC.seq_len,
                                 seed=SEED)
        try:
            p, opt, rec = train_step_record(train, p, opt, batches(0))
            break
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            batch_size //= 2
            cut = (f"train_batch's batch {TRAIN_BATCH:,} cut to "
                   f"{batch_size:,}: out of device memory")
    shape = {"B": batch_size, "S": SASREC.seq_len, "d": SASREC.d,
             "n_items": SASREC.n_items, "cut": cut}
    emit({"phase": "sasrec_train", "run": "cold", "step": 0, "shape": shape,
          "nvidia_smi": smi, **rec})
    warm = []
    for i in range(1, 1 + TRAIN_WARM_STEPS):
        batch = batches(i)
        p, opt, rec = train_step_record(train, p, opt, batch)
        emit({"phase": "sasrec_train", "run": "warm", "step": i,
              "shape": shape, **rec})
        warm.append(rec)
    median = statistics.median(r["seconds"] for r in warm)
    emit({"phase": "sasrec_train_summary", "shape": shape,
          "nvidia_smi": smi, "warm_steps": len(warm),
          "warm_median_s": median,
          "tokens_per_s": batch_size * SASREC.seq_len / median,
          "peak_device_bytes": max(r["peak_device_bytes"] for r in warm),
          "final_loss": warm[-1]["loss"], "step_counter": int(opt["step"])})
    batch = batches(1 + TRAIN_WARM_STEPS)
    phase_profile("sasrec_train", lambda: train(p, opt, batch),
                  lambda got: math.isfinite(got[2]["loss"].item()))
    del p, opt
    torch.cuda.empty_cache()


def phase_recsys_mesh(params) -> int:
    """SASRec's multi-card branches on a one-rank NCCL ``DeviceMesh`` of
    shape (1, 1) ``("data", "model")`` at full width, the weights placed by
    ``reshard_checkpoint`` with ``param_specs``: ``bulk`` (B = 32,768) and
    ``retrieval`` (10^6 candidates) through the mesh branches against the
    meshless steps, bit for bit, seconds of each, cold then warm; ``compressed_psum_tree``
    over the table and the position table against ``compress_int8`` then
    ``decompress_int8``, bit for bit. Returns the mesh retrieval's
    ``embedding_bag`` launches (launch counts set to 0 just before its warm
    run)."""
    bulk_seq = right_aligned(recsys_batches(
        SASREC.n_items, BULK_BATCH, SASREC.seq_len, seed=SEED)(0)["seq"])
    history = bulk_seq[:1]
    candidates = np.random.default_rng(SEED).integers(
        1, SASREC.n_items, N_CANDIDATES).astype(np.int32)
    rec = {"phase": "recsys_mesh", "mesh": {"data": 1, "model": 1}}
    with one_rank_nccl_mesh(("data", "model")) as mesh:
        par = Parallelism(mesh=mesh, dp_axes=("data",), tp_axis="model")
        placed = reshard_checkpoint(params, mesh, param_specs(SASREC, par))
        mesh_steps, steps = (make_recsys_steps(SASREC, par),
                             make_recsys_steps(SASREC))
        outs = {}
        for label, fn, args in (
                ("bulk_mesh", mesh_steps["bulk"], (placed, bulk_seq)),
                ("bulk", steps["bulk"], (params, bulk_seq)),
                ("retrieval_mesh", mesh_steps["retrieval"],
                 (placed, history, history != 0, candidates)),
                ("retrieval", steps["retrieval"],
                 (params, history, history != 0, candidates))):
            for when in ("cold", "warm"):
                outs.pop(label, None)
                outs[label], run = run_step(label, fn, args)
                rec[f"{label}_{when}_s"] = run["seconds"]
            rec[f"{label}_launches"] = run["launches"]
        for got, want in zip(outs["bulk_mesh"], outs["bulk"]):
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError("recsys_mesh: the mesh bulk top-k "
                                     "differs from the meshless one")
        rec["retrieval_max_abs_err"] = float(
            (outs["retrieval_mesh"] - outs["retrieval"]).abs().max())
        if not torch.equal(outs["retrieval_mesh"], outs["retrieval"]):
            raise AssertionError(f"recsys_mesh: the mesh retrieval differs "
                                 f"by {rec['retrieval_max_abs_err']}")
        grads = {"item_emb": params["item_emb"], "pos_emb": params["pos_emb"]}
        errs = {key: torch.full_like(g, 1e-4) for key, g in grads.items()}
        sync()
        t0 = time.perf_counter()
        new_g, new_e = compressed_psum_tree(grads, errs)
        sync()
        rec["compressed_psum_tree_s"] = time.perf_counter() - t0
        for key, g in grads.items():
            q, scale, err = compress_int8(g, errs[key])
            if not (torch.equal(new_g[key], decompress_int8(q, scale))
                    and torch.equal(new_e[key], err)):
                raise AssertionError(f"recsys_mesh: compressed_psum_tree of "
                                     f"{key} on one rank is not compress "
                                     f"then decompress")
    launches = rec["retrieval_mesh_launches"]["embedding_bag"]
    if launches != 1:
        raise AssertionError("the mesh retrieval did not launch "
                             "embedding_bag once")
    rec.update(bulk_equal=True, retrieval_equal=True,
               compressed_psum_tree_equal=True,
               shape={"bulk_B": BULK_BATCH, "C": N_CANDIDATES})
    emit(rec)
    return launches


# ------------------------------------------------- the language-model phases
#: Qwen3-0.6B at full width (configs/qwen3_0_6b.py::CONFIG); the three dense
#: archs lm_serve drives at full width, with launch/serve.py's CLI defaults
#: (B 4, prompt 16, gen 32, greedy) and no further flags
LM_CHECK_ARCH = "qwen3_0_6b"
LM_SERVE_ARCHS = ("qwen3_0_6b", "qwen3_14b", "stablelm_12b")
LM_SERVE_ARGV = []
#: lm_check: B x prompt tokens, then teacher-forced decode steps; its
#: tolerances, max |card - CPU| over the CPU tensor's largest magnitude for
#: the logits and the cache. Float32: the card's and the CPU's sums in
#: other orders over 28 layers (the CPU tests see 4e-7 after 2). Bfloat16:
#: 5e-2, about twelve units of bfloat16's 2^-8 at the largest magnitude:
#: every op rounds its result to bfloat16, and one rounding that goes the
#: other way on one device moves what follows by a unit
LM_CHECK_BATCH, LM_CHECK_PROMPT, LM_CHECK_STEPS = 4, 16, 8
LM_CHECK_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
#: lm_prefill: prefill_32k's S = 32,768, its batch cut from 32 to 1 (the
#: bf16 cache alone is 3.76 GB a sequence, 120 GB at 32, and the chunked
#: triangle is 528 block updates a layer)
LM_PREFILL_S = LM_SHAPES["prefill_32k"]["seq_len"]
LM_PREFILL_BATCH = 1
#: lm_decode: decode_32k's context of 32,768, its batch cut from 128 to 8
#: (the bf16 cache is 481 GB at 128, 30.1 GB at 8); greedy steps at
#: valid_len up to the context
LM_DECODE_S = LM_SHAPES["decode_32k"]["seq_len"]
LM_DECODE_BATCH, LM_DECODE_STEPS = 8, 16


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def no_launches(label: str) -> dict:
    """The five kernels' launch counts, which must all be 0: the language
    model reaches none of them (``chunked_causal_attention`` and
    ``decode_attention`` are plain PyTorch, as in the JAX package)."""
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"{label}: kernels launched: {counts}")
    return counts


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over want's largest magnitude, in float32 on the
    CPU."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def phase_lm_check(smi: str) -> None:
    """Qwen3-0.6B at full width on the card and on the CPU from one set of
    weights (drawn on the card in float32, its bfloat16 copy rounded from
    them): the prefill step on B x prompt seeded tokens, then
    ``LM_CHECK_STEPS`` decode steps fed the card's greedy tokens on both;
    every step's logits and the whole cache within ``LM_CHECK_TOL``; the
    first step whose greedy tokens differ (a reading)."""
    base = lm_get(LM_CHECK_ARCH).config
    p32 = lm_init(dataclasses.replace(base, param_dtype="float32"),
                  torch.Generator(device=DEVICE).manual_seed(SEED),
                  device=DEVICE)
    prompts = torch.randint(
        0, base.vocab, (LM_CHECK_BATCH, LM_CHECK_PROMPT),
        generator=torch.Generator().manual_seed(SEED + 1), dtype=torch.int32)
    s_max = LM_CHECK_PROMPT + LM_CHECK_STEPS
    par = Parallelism.none()
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, param_dtype=dtype)
        card = tree_map(lambda t: t.to(cfg.dtype), p32)
        cpu = tree_map(lambda t: t.cpu(), card)
        prefill = make_lm_prefill_step(cfg, par, s_max=s_max)
        decode = make_lm_decode_step(cfg, par)
        sync()
        reset_launch_counts()
        t0 = time.perf_counter()
        got, got_cache = prefill(card, prompts.to(DEVICE))
        sync()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want, want_cache = prefill(cpu, prompts)
        cpu_s = time.perf_counter() - t0
        logits_err, cache_err, first_diff = [], [], None
        for step in range(LM_CHECK_STEPS + 1):
            logits_err.append(rel_err(got, want))
            cache_err.append(max(rel_err(a, b) for a, b in
                                 zip(got_cache, want_cache)))
            tok = got.argmax(-1)[:, None].to(torch.int32)
            if first_diff is None and not torch.equal(
                    tok.cpu(), want.argmax(-1)[:, None].to(torch.int32)):
                first_diff = step
            if step == LM_CHECK_STEPS:
                break
            valid = LM_CHECK_PROMPT + step + 1
            sync()
            t0 = time.perf_counter()
            got, got_cache = decode(card, got_cache, tok, valid)
            sync()
            card_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            want, want_cache = decode(cpu, want_cache, tok.cpu(), valid)
            cpu_s += time.perf_counter() - t0
        rec = {"phase": "lm_check", "arch": LM_CHECK_ARCH, "dtype": dtype,
               "batch": LM_CHECK_BATCH, "prompt": LM_CHECK_PROMPT,
               "decode_steps": LM_CHECK_STEPS, "s_max": s_max,
               "logits_rel_err": logits_err, "cache_rel_err": cache_err,
               "tolerance": LM_CHECK_TOL[dtype],
               "first_greedy_difference_step": first_diff,
               "card_s": card_s, "cpu_s": cpu_s,
               "param_bytes": tree_bytes(card),
               "launches": no_launches("lm_check"), "nvidia_smi": smi}
        emit(rec)
        worst = max(logits_err + cache_err)
        if not worst <= LM_CHECK_TOL[dtype]:
            raise AssertionError(f"lm_check {dtype}: card against CPU "
                                 f"{worst} > {LM_CHECK_TOL[dtype]}")
        del card, cpu, got_cache, want_cache
    del p32
    torch.cuda.empty_cache()


def phase_lm_serve(smi: str) -> None:
    """``launch/serve.py::main`` at its CLI defaults (B 4, prompt 16, gen
    32, greedy) for each arch of ``LM_SERVE_ARCHS`` at full width in
    bfloat16, one model at a time (freed before the next): its ``generate``
    wrapped to read the prefill's and the decode loop's seconds and the
    parameter bytes; the peak device bytes; its two printed lines; tokens
    inside the vocabulary."""
    real = serve_lm.generate
    for arch in LM_SERVE_ARCHS:
        cfg = lm_get(arch).config
        seen = {}

        def recorded(cfg_, params, *args):
            seen["param_bytes"] = tree_bytes(params)
            tokens, secs = real(cfg_, params, *args)
            seen.update(secs)
            return tokens, secs

        out = io.StringIO()
        serve_lm.generate = recorded
        try:
            sync()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                gen = serve_lm.main(["--arch", arch, *LM_SERVE_ARGV],
                                    device=DEVICE)
            sync()
            wall = time.perf_counter() - t0
        finally:
            serve_lm.generate = real
        batch, steps = gen.shape
        if not ((gen >= 0) & (gen < cfg.vocab)).all():
            raise AssertionError(f"lm_serve {arch}: tokens outside the "
                                 f"vocabulary")
        emit({"phase": "lm_serve", "arch": arch, "dtype": cfg.param_dtype,
              "argv": ["--arch", arch, *LM_SERVE_ARGV], "batch": batch,
              "gen": steps,
              "n_layers": cfg.n_layers, "d_model": cfg.d_model,
              "n_heads": cfg.n_heads, "h_padded": cfg.h_padded,
              "d_head": cfg.d_head, "qk_norm": cfg.qk_norm,
              "prefill_ms": seen["prefill_s"] * 1e3,
              "decode_s": seen["decode_s"],
              "decode_tokens_per_s": batch * steps / seen["decode_s"],
              "wall_s": wall, "param_bytes": seen["param_bytes"],
              "peak_device_bytes": torch.cuda.max_memory_allocated(),
              "printed": out.getvalue().splitlines(),
              "launches": no_launches(f"lm_serve {arch}"),
              "nvidia_smi": smi})
        del gen
        gc.collect()
        torch.cuda.empty_cache()


def phase_lm_prefill(params, smi: str) -> None:
    """Qwen3-0.6B's prefill step at prefill_32k's S = 32,768 (batch cut to
    ``LM_PREFILL_BATCH``), seeded tokens: a cold call and a warm one
    (seconds, tokens/s, peak bytes, launches), then one warm call under
    torch.profiler (device events only: the call launches hundreds of
    thousands of kernels) for the idle share."""
    cfg = lm_get(LM_CHECK_ARCH).config
    tokens = torch.randint(
        0, cfg.vocab, (LM_PREFILL_BATCH, LM_PREFILL_S),
        generator=torch.Generator(device=DEVICE).manual_seed(SEED + 1),
        device=DEVICE, dtype=torch.int32)
    prefill = make_lm_prefill_step(cfg, Parallelism.none(),
                                   s_max=LM_PREFILL_S)

    def ok(out) -> bool:
        logits, (ck, cv) = out
        return (tuple(logits.shape) == (LM_PREFILL_BATCH, cfg.vocab)
                and bool(torch.isfinite(logits).all())
                and bool(torch.isfinite(ck[-1, :, -1]).all()))

    seq_bytes = (2 * cfg.n_layers * LM_PREFILL_S * cfg.n_kv_heads
                 * cfg.d_head * cfg.dtype.itemsize)
    shape = {"B": LM_PREFILL_BATCH, "S": LM_PREFILL_S,
             "cut": f"prefill_32k's batch "
                    f"{LM_SHAPES['prefill_32k']['global_batch']} cut to "
                    f"{LM_PREFILL_BATCH}: the {cfg.param_dtype} cache is "
                    f"{seq_bytes / 1e9:.2f} GB a sequence"}
    for run in ("cold", "warm"):
        out, rec = timed(lambda: prefill(params, tokens))
        if not ok(out):
            raise AssertionError(f"lm_prefill {run}: bad output")
        emit({"phase": "lm_prefill", "run": run, "arch": LM_CHECK_ARCH,
              "shape": shape, **rec,
              "tokens_per_s": LM_PREFILL_BATCH * LM_PREFILL_S
              / rec["seconds"], "cache_bytes": tree_bytes(list(out[1])),
              "launches": no_launches("lm_prefill"), "nvidia_smi": smi})
        del out
    reset_launch_counts()
    phase_profile("lm_prefill", lambda: prefill(params, tokens), ok,
                  cpu_ops=False, extra=lambda: {
                      "nvidia_smi": smi,
                      "launches": no_launches("profiled lm_prefill")})
    torch.cuda.empty_cache()


def phase_lm_decode(params, smi: str) -> None:
    """Qwen3-0.6B's decode step against decode_32k's context of 32,768
    (batch cut to ``LM_DECODE_BATCH``): the cache filled with seeded
    normal values, then ``LM_DECODE_STEPS`` greedy steps at ``valid_len``
    up to the context (seconds a step, tokens/s, peak bytes, launches; the
    byte bound: cache and parameters read once), then one step under
    torch.profiler for the idle share."""
    cfg = lm_get(LM_CHECK_ARCH).config
    par = Parallelism.none()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    cache = lm_init_cache(cfg, LM_DECODE_BATCH, LM_DECODE_S, device=DEVICE)
    for c in cache:
        c.normal_(generator=gen)
    tok = torch.randint(0, cfg.vocab, (LM_DECODE_BATCH, 1), generator=gen,
                        device=DEVICE, dtype=torch.int32)
    decode = make_lm_decode_step(cfg, par)
    cache_bytes = tree_bytes(list(cache))
    nbytes = tree_bytes(params) + cache_bytes
    full = LM_SHAPES["decode_32k"]["global_batch"]
    shape = {"B": LM_DECODE_BATCH, "context": LM_DECODE_S,
             "cut": f"decode_32k's batch {full} cut to {LM_DECODE_BATCH}: "
                    f"the {cfg.param_dtype} cache is "
                    f"{cache_bytes / LM_DECODE_BATCH * full / 1e9:.0f} GB "
                    f"at {full}, {cache_bytes / 1e9:.1f} GB at "
                    f"{LM_DECODE_BATCH}"}
    steps = []
    for i in range(LM_DECODE_STEPS):
        valid = LM_DECODE_S - LM_DECODE_STEPS + 1 + i
        (logits, cache), rec = timed(
            lambda: decode(params, cache, tok, valid))
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"lm_decode step {i}: non-finite logits")
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        steps.append({"valid_len": valid, **rec,
                      "launches": no_launches("lm_decode")})
    warm = statistics.median(r["seconds"] for r in steps[1:])
    emit({"phase": "lm_decode", "arch": LM_CHECK_ARCH, "shape": shape,
          "steps": steps, "warm_median_s": warm,
          "tokens_per_s": LM_DECODE_BATCH / warm,
          "cache_bytes": cache_bytes, "param_bytes": tree_bytes(params),
          "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
          "peak_device_bytes": max(r["peak_device_bytes"] for r in steps),
          "launches": no_launches("lm_decode"), "nvidia_smi": smi})
    reset_launch_counts()
    phase_profile("lm_decode", lambda: decode(params, cache, tok,
                                              LM_DECODE_S),
                  lambda out: bool(torch.isfinite(out[0]).all()),
                  extra=lambda: {"nvidia_smi": smi,
                                 "launches": no_launches("profiled "
                                                         "lm_decode")})
    del cache
    torch.cuda.empty_cache()


def phase_lm(smi: str) -> None:
    """The language-model phases, bf16 products with full float32 sums
    (the reference's XLA dots accumulate in float32), TF32 off."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    phase_lm_check(smi)
    phase_lm_serve(smi)
    params = lm_init(lm_get(LM_CHECK_ARCH).config,
                     torch.Generator(device=DEVICE).manual_seed(SEED),
                     device=DEVICE)
    phase_lm_prefill(params, smi)
    phase_lm_decode(params, smi)
    del params
    torch.cuda.empty_cache()
    emit({"phase": "lm_phases", "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi, "launches": no_launches("lm_phases")})


# ------------------------- language-model training and the MoE layers
#: lm_train_check: one make_lm_train_step step of Qwen3-0.6B at full width
#: in float32 on B x S seeded tokens, on the card and on the CPU from one
#: set of weights and one AdamW state: its moments drawn at random (m
#: normal at 1e-3, v = m^2 + 1e-6) and its counter at the schedule's
#: warmup, so that the step runs at the full lr and AdamW's normalised
#: step is smooth in the gradient (from zero moments it is about ±lr
#: wherever a gradient element is within rounding of 0). The model has no
#: kink (SiLU, no ReLU), so the tolerance is set by float32 sums in other
#: orders over 28 layers: loss and grad_norm within 1e-4 relative, every
#: param, master, m and v leaf within 1e-4 of its largest magnitude
LM_TRAIN_CHECK_BATCH, LM_TRAIN_CHECK_S = 2, 32
LM_TRAIN_CHECK_TOL = {"scalars_rtol": 1e-4, "leaf": 1e-4}
#: lm_train: launch/train.py::train at train_4k's S = 4,096, its batch cut
#: from 256 to 8 (AdamW's float32 state is 7.2 GB, and each layer's
#: recomputed attention holds ten 512 MB float32 score tiles at B 8); a
#: cold step and LM_TRAIN_WARM_STEPS warm ones
LM_TRAIN_S = LM_SHAPES["train_4k"]["seq_len"]
LM_TRAIN_BATCH, LM_TRAIN_WARM_STEPS = 8, 5
#: lm_train_restart: the crash drill of launch/train.py::main at --smoke
LM_DRILL_ARGV = ["--smoke", "--steps", "30", "--batch", "2", "--seq", "32",
                 "--ckpt-every", "10"]
LM_DRILL_FAIL_AT = 17
#: the mixture-of-experts configs at full width
MOE_ARCHS = ("qwen3_moe_235b_a22b", "dbrx_132b")
#: moe_check: one layer's moe_ffn_local on T seeded bf16 tokens, card
#: against CPU: the tokens whose routing (ids or kept slots) differs are
#: counted (a reading); the others' outputs within 3e-2 of the output's
#: largest magnitude (bf16 products round on each device, a few units of
#: 2^-8), aux within 1e-4 relative (float32 router logits summed in other
#: orders)
MOE_CHECK_T = 64
MOE_CHECK_TOL = {"out": 3e-2, "aux_rtol": 1e-4}
#: moe_serve: launch/serve.py::generate at full width with n_layers cut to
#: 4 (the full models are at least 470 and 264 GB of bf16 weights), B x
#: prompt, greedy
MOE_SERVE_LAYERS, MOE_SERVE_BATCH = 4, 4
MOE_SERVE_PROMPT, MOE_SERVE_GEN = 16, 32
#: moe_train: one donated make_lm_train_step step of Qwen3-MoE at full
#: width, n_layers cut to 1 (3.1 G parameters: 6.2 GB of bf16 weights and
#: 37 GB of float32 AdamW state), B x train_4k's S; a cold step and a warm
#: one. DBRX's one layer is 3.8 G parameters (61 GB with its state) and
#: stays off the card
MOE_TRAIN_BATCH = 2
MOE_TRAIN_S = LM_SHAPES["train_4k"]["seq_len"]


def moments_state(params, seed: int, step: int) -> dict:
    """lm_train_check's AdamW state of ``params`` (on their device): master
    the params in float32, m seeded normal at 1e-3, v = m^2 + 1e-6, the
    counter at ``step``."""
    dev = tree_leaves(params)[0].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = tree_map(lambda p: torch.randn(p.shape, generator=gen, device=dev)
                 .mul_(1e-3), params)
    return {"step": torch.tensor(step, dtype=torch.int32, device=dev),
            "master": tree_map(lambda p: p.float().clone(), params),
            "m": m, "v": tree_map(lambda a: a * a + 1e-6, m)}


def phase_lm_train_check(smi: str) -> None:
    """One ``make_lm_train_step`` step of Qwen3-0.6B at full width in
    float32 on the card and on the CPU from one set of weights and one
    AdamW state (``moments_state``): loss, grad_norm and lr, then every
    param, master, m and v leaf, within ``LM_TRAIN_CHECK_TOL``."""
    base = lm_get(LM_CHECK_ARCH).config
    cfg = dataclasses.replace(base, param_dtype="float32")
    card = lm_init(cfg, torch.Generator(device=DEVICE).manual_seed(SEED),
                   device=DEVICE)
    warmup = 200  # make_lm_train_step's default
    opt_card = moments_state(card, SEED + 3, warmup)
    cpu = tree_map(lambda t: t.cpu(), card)
    opt_cpu = tree_map(lambda t: t.cpu(), opt_card)
    batch = SyntheticTokens(cfg.vocab, LM_TRAIN_CHECK_BATCH,
                            LM_TRAIN_CHECK_S, seed=SEED).batch_at(0)
    step = make_lm_train_step(cfg, Parallelism.none())
    (card, opt_card, got), rec = timed(lambda: step(card, opt_card, batch))
    t0 = time.perf_counter()
    cpu, opt_cpu, want = step(cpu, opt_cpu, batch)
    cpu_s = time.perf_counter() - t0
    tol = LM_TRAIN_CHECK_TOL
    scalars = {}
    for key in ("loss", "grad_norm", "lr"):
        g, w = got[key].item(), want[key].item()
        scalars[key] = {"card": g, "cpu": w}
        if not abs(g - w) <= tol["scalars_rtol"] * abs(w):
            raise AssertionError(f"lm_train_check: {key} {g} on the card, "
                                 f"{w} on the CPU")
    if not int(opt_card["step"]) == int(opt_cpu["step"]) == warmup + 1:
        raise AssertionError("lm_train_check: the step counters differ")
    worst = {}
    for label, a_tree, b_tree in (("params", card, cpu),
                                  ("master", opt_card["master"],
                                   opt_cpu["master"]),
                                  ("m", opt_card["m"], opt_cpu["m"]),
                                  ("v", opt_card["v"], opt_cpu["v"])):
        worst[label] = 0.0
        for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)):
            if a.device.type != torch.device(DEVICE).type:
                raise AssertionError(f"lm_train_check: a {label} leaf left "
                                     f"the card")
            worst[label] = max(worst[label], rel_err(a, b))
        if not worst[label] <= tol["leaf"]:
            raise AssertionError(f"lm_train_check: a {label} leaf differs by "
                                 f"{worst[label]} of its scale")
    emit({"phase": "lm_train_check", "arch": LM_CHECK_ARCH,
          "dtype": "float32", "batch": LM_TRAIN_CHECK_BATCH,
          "S": LM_TRAIN_CHECK_S, "state_step": warmup,
          "scalars": scalars, "max_err_over_leaf_scale": worst,
          "tolerance": tol, "card_s": rec["seconds"], "cpu_s": cpu_s,
          "peak_device_bytes": rec["peak_device_bytes"],
          "param_bytes": tree_bytes(card),
          "launches": no_launches("lm_train_check"), "nvidia_smi": smi})
    del card, opt_card, cpu, opt_cpu
    gc.collect()
    torch.cuda.empty_cache()


def optimizer_share(cfg, params, opt, batch) -> dict:
    """One train step's two halves timed apart, each to a synchronised end:
    ``lm_loss`` and its gradient, then ``adamw_update`` (the schedule's lr
    included), as ``_train_step`` runs them."""
    par = Parallelism.none()
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    sync()
    t0 = time.perf_counter()
    with torch.enable_grad():
        loss = lm_loss(tree_unflatten(params, leaves), batch, cfg, par)
        grads = torch.autograd.grad(loss, leaves)
    sync()
    grad_s = time.perf_counter() - t0
    del loss, leaves
    t0 = time.perf_counter()
    with torch.no_grad():
        lr_scale = cosine_schedule(opt["step"], warmup=1,
                                   total=1 + LM_TRAIN_WARM_STEPS)
        out = adamw_update(tree_unflatten(params, list(grads)), opt, params,
                           AdamWConfig(lr=1e-3), lr_scale)
    sync()
    update_s = time.perf_counter() - t0
    if not math.isfinite(out[2]["grad_norm"].item()):
        raise AssertionError("optimizer_share: non-finite grad norm")
    return {"grad_s": grad_s, "adamw_update_s": update_s,
            "adamw_share": update_s / (grad_s + update_s)}


def phase_lm_train(smi: str) -> None:
    """``launch/train.py::train`` at Qwen3-0.6B's full width in bf16 on
    train_4k's S (batch cut to ``LM_TRAIN_BATCH``), batches from
    ``SyntheticTokens``: a cold step and ``LM_TRAIN_WARM_STEPS`` warm ones
    (seconds, tokens/s over B x S, the run's peak bytes), its printed
    lines; then one warm step under torch.profiler (device events only)
    and one timed in its two halves (the optimizer's share)."""
    cfg = lm_get(LM_CHECK_ARCH).config
    params = lm_init(cfg, torch.Generator(device=DEVICE).manual_seed(SEED),
                     device=DEVICE)
    opt = adamw_init(params)
    steps = 1 + LM_TRAIN_WARM_STEPS
    data = SyntheticTokens(cfg.vocab, LM_TRAIN_BATCH, LM_TRAIN_S, seed=SEED)
    out = io.StringIO()
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with contextlib.redirect_stdout(out):
        params, opt, recs = train_lm.train(cfg, params, opt, data, steps,
                                           log_every=1)
    peak = torch.cuda.max_memory_allocated()
    launches = no_launches("lm_train")
    tokens = LM_TRAIN_BATCH * LM_TRAIN_S
    if not all(math.isfinite(r["loss"]) for r in recs):
        raise AssertionError("lm_train: a non-finite loss")
    full = LM_SHAPES["train_4k"]["global_batch"]
    shape = {"B": LM_TRAIN_BATCH, "S": LM_TRAIN_S,
             "cut": f"train_4k's batch {full} cut to {LM_TRAIN_BATCH}"}
    warm = statistics.median(r["seconds"] for r in recs[1:])
    emit({"phase": "lm_train", "arch": LM_CHECK_ARCH,
          "dtype": cfg.param_dtype, "shape": shape,
          "cold_s": recs[0]["seconds"],
          "cold_tokens_per_s": tokens / recs[0]["seconds"],
          "warm_steps": [r["seconds"] for r in recs[1:]],
          "warm_median_s": warm, "tokens_per_s": tokens / warm,
          "losses": [r["loss"] for r in recs],
          "grad_norms": [r["grad_norm"] for r in recs],
          "peak_device_bytes": peak, "param_bytes": tree_bytes(params),
          "state_bytes": tree_bytes(opt),
          "printed": out.getvalue().splitlines(), "launches": launches,
          "nvidia_smi": smi})
    step = make_lm_train_step(cfg, Parallelism.none(), AdamWConfig(lr=1e-3),
                              total_steps=steps, warmup=1)
    batch = data.batch_at(steps)
    reset_launch_counts()
    phase_profile("lm_train", lambda: step(params, opt, batch),
                  lambda got: math.isfinite(got[2]["loss"].item()),
                  cpu_ops=False, extra=lambda: {
                      "nvidia_smi": smi,
                      "launches": no_launches("profiled lm_train")})
    split = optimizer_share(cfg, params, opt, data.batch_at(steps + 1))
    emit({"phase": "lm_train_optimizer", "arch": LM_CHECK_ARCH,
          "shape": shape, **split,
          "launches": no_launches("lm_train_optimizer"),
          "nvidia_smi": smi})
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()


def phase_lm_train_restart(smi: str) -> None:
    """The crash drill through ``launch/train.py::main(..., device=DEVICE)``
    at ``--smoke``: 30 steps straight; a run killed at step 17 (exit 17),
    then the same command again: it must print ``[resume] restored step
    10`` and the straight run's ``final_loss``."""
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-train-") as tmp:
        reset_launch_counts()
        t0 = time.perf_counter()
        for name, extra in (("straight", []),
                            ("killed", ["--fail-at", str(LM_DRILL_FAIL_AT)]),
                            ("restarted", [])):
            ckpt = Path(tmp) / ("a" if name == "straight" else "b")
            out, code = io.StringIO(), 0
            with contextlib.redirect_stdout(out):
                try:
                    train_lm.main([*LM_DRILL_ARGV, "--ckpt-dir", str(ckpt),
                                   *extra], device=DEVICE)
                except SystemExit as exc:
                    code = exc.code
            runs[name] = {"exit": code, "printed": out.getvalue()
                          .splitlines()}
        seconds = time.perf_counter() - t0

    def final(name):
        lines = [x for x in runs[name]["printed"]
                 if x.startswith("final_loss ")]
        return lines[-1].split()[1] if lines else None

    ok = (runs["killed"]["exit"] == 17 and runs["straight"]["exit"] == 0
          and runs["restarted"]["exit"] == 0
          and "[resume] restored step 10" in runs["restarted"]["printed"]
          and final("killed") is None
          and final("restarted") == final("straight") is not None)
    emit({"phase": "lm_train_restart", "argv": LM_DRILL_ARGV,
          "fail_at": LM_DRILL_FAIL_AT, "seconds": seconds,
          "exits": {k: v["exit"] for k, v in runs.items()},
          "final_loss": {k: final(k) for k in runs},
          "restarted_printed": runs["restarted"]["printed"][:2],
          "launches": no_launches("lm_train_restart"), "nvidia_smi": smi})
    if not ok:
        raise AssertionError(f"lm_train_restart: the drill failed: {runs}")


def moe_layer_weights(cfg, seed: int) -> tuple:
    """One layer's router [d, E] and experts at the reference's scales
    (0.02; ``we_out`` 0.02 / sqrt(2 L)), bf16, drawn on the card."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    d, e, f = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert
    out_sig = 0.02 / math.sqrt(2 * cfg.n_layers)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=DEVICE,
                           dtype=torch.bfloat16).mul_(scale)

    return (normal((d, e), 0.02), normal((e, d, f), 0.02),
            normal((e, d, f), 0.02), normal((e, f, d), out_sig))


def phase_moe_check(smi: str) -> dict:
    """``moe_ffn_local`` at each MoE config's full width in bf16 on
    ``MOE_CHECK_T`` seeded tokens, on the card and on the CPU from the same
    weights: the routing compared token by token, the tokens routed alike
    held within ``MOE_CHECK_TOL``, aux too. Returns the first config's
    (x, weights) on the card, for ``moe_mesh``."""
    kept_for_mesh = None
    for i, arch in enumerate(MOE_ARCHS):
        cfg = lm_get(arch).config
        weights = moe_layer_weights(cfg, SEED + 10 + i)
        x = torch.randn((MOE_CHECK_T, cfg.d_model), device=DEVICE,
                        dtype=torch.bfloat16,
                        generator=torch.Generator(device=DEVICE)
                        .manual_seed(SEED + 20 + i))
        e = cfg.moe.n_experts
        kw = {"cfg": cfg.moe, "e_start": 0, "n_local": e}
        (got, aux), rec = timed(lambda: moe_mod.moe_ffn_local(x, *weights,
                                                              **kw))
        launches = no_launches(f"moe_check {arch}")
        cpu = [t.cpu() for t in (x, *weights)]
        t0 = time.perf_counter()
        want, aux_cpu = moe_mod.moe_ffn_local(*cpu, **kw)
        cpu_s = time.perf_counter() - t0
        r_card = moe_mod.route(x, weights[0], cfg.moe, 0, e)
        r_cpu = moe_mod.route(cpu[0], cpu[1], cfg.moe, 0, e)
        k = cfg.moe.top_k
        same = ((r_card["ids"].cpu() == r_cpu["ids"]).all(-1)
                & (r_card["kept"].cpu() == r_cpu["kept"]).reshape(-1, k)
                .all(-1))
        scale = float(want.float().abs().max())
        err = float((got.float().cpu() - want.float())[same].abs().max()
                    ) / scale if bool(same.any()) else float("nan")
        aux_err = abs(aux.item() - aux_cpu.item()) / abs(aux_cpu.item())
        emit({"phase": "moe_check", "arch": arch, "dtype": "bfloat16",
              "T": MOE_CHECK_T, "d_model": cfg.d_model, "n_experts": e,
              "top_k": k, "d_ff_expert": cfg.moe.d_ff_expert,
              "capacity": r_card["cap"],
              "dropped_pairs": int((~r_card["kept"]).sum()),
              "tokens_routed_differently": int((~same).sum()),
              "out_rel_err": err, "aux": aux.item(), "aux_cpu": aux_cpu.item(),
              "aux_rel_err": aux_err, "tolerance": MOE_CHECK_TOL,
              "card_s": rec["seconds"], "cpu_s": cpu_s,
              "weight_bytes": tree_bytes(list(weights)),
              "launches": launches, "nvidia_smi": smi})
        if not (err <= MOE_CHECK_TOL["out"]
                and aux_err <= MOE_CHECK_TOL["aux_rtol"]
                and bool(torch.isfinite(got).all())):
            raise AssertionError(f"moe_check {arch}: output {err}, aux "
                                 f"{aux_err} against the CPU")
        if kept_for_mesh is None:
            kept_for_mesh = (cfg, x, weights)
        del got, cpu, want
    return kept_for_mesh


def phase_moe_mesh(cfg, x, weights, smi: str) -> None:
    """``make_moe_layer`` on a one-rank NCCL (1, 1) ``("data", "model")``
    mesh against the meshless layer, bit for bit (every expert is the one
    rank's, the all-reduces sum one term), cold then warm."""
    rec = {"phase": "moe_mesh", "mesh": {"data": 1, "model": 1},
           "T": x.shape[0], "n_experts": cfg.moe.n_experts}
    xb = x[None]
    with one_rank_nccl_mesh(("data", "model")) as mesh, torch.no_grad():
        layers = {"mesh": moe_mod.make_moe_layer(mesh, ("data",), "model",
                                                 cfg.moe),
                  "single": moe_mod.make_moe_layer(None, (), None, cfg.moe)}
        outs = {}
        for label, layer in layers.items():
            for when in ("cold", "warm"):
                outs[label], run = timed(lambda: layer(xb, *weights))
                rec[f"{label}_{when}_s"] = run["seconds"]
            rec[f"{label}_launches"] = no_launches(f"moe_mesh {label}")
    (y, aux), (y1, aux1) = outs["mesh"], outs["single"]
    if not (torch.equal(y, y1) and torch.equal(aux, aux1)):
        raise AssertionError("moe_mesh: the mesh layer differs from the "
                             "meshless one")
    rec.update(out_equal=True, aux_equal=True, nvidia_smi=smi)
    emit(rec)


def phase_moe_serve(smi: str) -> None:
    """``launch/serve.py::generate`` for each MoE config at full width with
    ``n_layers`` cut to ``MOE_SERVE_LAYERS``, bf16, seeded weights and
    prompts, greedy: prefill ms, decode tokens/s, parameter and peak bytes,
    tokens inside the vocabulary."""
    for arch in MOE_ARCHS:
        full = lm_get(arch).config
        cfg = dataclasses.replace(full, n_layers=MOE_SERVE_LAYERS)
        params = lm_init(cfg, torch.Generator(device=DEVICE).manual_seed(
            SEED), device=DEVICE)
        prompts = torch.randint(
            0, cfg.vocab, (MOE_SERVE_BATCH, MOE_SERVE_PROMPT),
            generator=torch.Generator(device=DEVICE).manual_seed(SEED + 1),
            device=DEVICE, dtype=torch.int32)
        sync()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        tokens, secs = serve_lm.generate(cfg, params, prompts, MOE_SERVE_GEN,
                                         0.0, None)
        if not ((tokens >= 0) & (tokens < cfg.vocab)).all():
            raise AssertionError(f"moe_serve {arch}: tokens outside the "
                                 f"vocabulary")
        emit({"phase": "moe_serve", "arch": arch, "dtype": cfg.param_dtype,
              "n_layers": cfg.n_layers,
              "cut": f"n_layers {full.n_layers} cut to {cfg.n_layers}: "
                     f"{full.n_params() * 2 / 1e9:.0f} GB of bf16 weights "
                     f"in full",
              "batch": MOE_SERVE_BATCH, "prompt": MOE_SERVE_PROMPT,
              "gen": MOE_SERVE_GEN, "prefill_ms": secs["prefill_s"] * 1e3,
              "decode_s": secs["decode_s"],
              "decode_tokens_per_s": MOE_SERVE_BATCH * MOE_SERVE_GEN
              / secs["decode_s"],
              "param_bytes": tree_bytes(params),
              "peak_device_bytes": torch.cuda.max_memory_allocated(),
              "tokens_in_vocab": True, "sample_row0": tokens[0][:8].tolist(),
              "launches": no_launches(f"moe_serve {arch}"),
              "nvidia_smi": smi})
        del params
        gc.collect()
        torch.cuda.empty_cache()


@contextlib.contextmanager
def counting_drops(drops: list):
    """``moe.route`` wrapped for the block's duration: each call appends
    the (token, choice) pairs its capacity dropped (the forward's and the
    recomputed forward's)."""
    real = moe_mod.route

    def counted(*args, **kw):
        r = real(*args, **kw)
        drops.append(int((~r["kept"]).sum()))
        return r

    moe_mod.route = counted
    try:
        yield
    finally:
        moe_mod.route = real


def phase_moe_train(smi: str) -> None:
    """One donated ``make_lm_train_step`` step of Qwen3-MoE at full width
    with ``n_layers`` cut to 1, bf16, B x S of ``SyntheticTokens``: a cold
    step and a warm one (seconds, tokens/s, peak bytes, loss, grad_norm,
    the capacity drops of the forward)."""
    arch = MOE_ARCHS[0]
    full = lm_get(arch).config
    cfg = dataclasses.replace(full, n_layers=1)
    params = lm_init(cfg, torch.Generator(device=DEVICE).manual_seed(SEED),
                     device=DEVICE)
    opt = adamw_init(params)
    step = make_lm_train_step(cfg, Parallelism.none(), donate=True)
    data = SyntheticTokens(cfg.vocab, MOE_TRAIN_BATCH, MOE_TRAIN_S,
                           seed=SEED)
    tokens = MOE_TRAIN_BATCH * MOE_TRAIN_S
    dbrx = dataclasses.replace(lm_get("dbrx_132b").config, n_layers=1)
    shape = {"B": MOE_TRAIN_BATCH, "S": MOE_TRAIN_S, "n_layers": 1,
             "cut": f"n_layers {full.n_layers} cut to 1 and train_4k's "
                    f"batch {LM_SHAPES['train_4k']['global_batch']} to "
                    f"{MOE_TRAIN_BATCH}: the one-layer model's bf16 params "
                    f"and float32 AdamW state are "
                    f"{cfg.n_params() * 14 / 1e9:.1f} GB; DBRX's one-layer "
                    f"model's {dbrx.n_params() * 14 / 1e9:.1f} GB, before "
                    f"its gradients and activations, stays off the card",
             "capacity": moe_mod.capacity(tokens, cfg.moe)}
    param_bytes = tree_bytes(params)
    for i, run in enumerate(("cold", "warm")):
        drops = []
        with counting_drops(drops):
            (params, opt, metrics), rec = timed(
                lambda: step(params, opt, data.batch_at(i)))
        loss = metrics["loss"].item()
        if not math.isfinite(loss):
            raise AssertionError(f"moe_train {run}: loss {loss}")
        emit({"phase": "moe_train", "run": run, "arch": arch,
              "dtype": cfg.param_dtype, "shape": shape,
              "seconds": rec["seconds"],
              "tokens_per_s": tokens / rec["seconds"], "loss": loss,
              "grad_norm": metrics["grad_norm"].item(),
              "dropped_pairs": drops[0], "pairs": tokens * cfg.moe.top_k,
              "route_calls": len(drops),
              "peak_device_bytes": rec["peak_device_bytes"],
              "param_bytes": param_bytes, "state_bytes": tree_bytes(opt),
              "launches": no_launches(f"moe_train {run}"),
              "nvidia_smi": smi})
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()


def phase_lm_train_moe(smi: str) -> None:
    """The language-model training and mixture-of-experts phases, as
    ``phase_lm`` sets the card (TF32 off, bf16 products summed in float32),
    then their seconds (``lm_train_phases``)."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    seconds = {}
    for name, fn in (("lm_train_check", phase_lm_train_check),
                     ("lm_train", phase_lm_train),
                     ("lm_train_restart", phase_lm_train_restart)):
        t1 = time.perf_counter()
        fn(smi)
        seconds[name] = time.perf_counter() - t1
    t1 = time.perf_counter()
    mesh_args = phase_moe_check(smi)
    seconds["moe_check"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    phase_moe_mesh(*mesh_args, smi)
    seconds["moe_mesh"] = time.perf_counter() - t1
    del mesh_args
    gc.collect()
    torch.cuda.empty_cache()
    for name, fn in (("moe_serve", phase_moe_serve),
                     ("moe_train", phase_moe_train)):
        t1 = time.perf_counter()
        fn(smi)
        seconds[name] = time.perf_counter() - t1
    emit({"phase": "lm_train_phases", "seconds": time.perf_counter() - t0,
          "by_phase": seconds, "nvidia_smi": smi,
          "launches": no_launches("lm_train_phases")})


# ------------------------------------ graph networks, pipeline parallelism
#: gnn_check: one make_gnn_train_step step of each of GNN_CHECK_CASES
#: (tests/torch_gnn_cases.py, shared with the card tests) at its smoke
#: config on the card and on a CPU copy, from one set of weights and an
#: AdamW state past the warmup (moments_state), within GNN_CHECK_TOL (the
#: reasons stand beside the numbers there)
#: make_gnn_train_step's default warmup: the checked step runs at full lr
GNN_WARMUP = 20
#: gnn_sampled: GraphSAGE at minibatch_lg (src/repro/launch/workloads.py's
#: sampled branch: d_feat 602, 41 classes, fan-out (15, 10), 1,024 seeds)
#: on a synthetic multigraph of the shape's 232,965 nodes and 114,615,892
#: edges (random_graph(..., simple=False)); GNN_SAMPLED_STEPS batches and
#: steps after a cold one
GNN_SAMPLED_SHAPE = "minibatch_lg"
GNN_SAMPLED_EDGES = GNN_SHAPES[GNN_SAMPLED_SHAPE]["n_edges"]
GNN_SAMPLED_STEPS = 5
#: gnn_full: (arch, shape) at the configs' widths, built as workloads.py's
#: full and batched branches build them; a cold step and GNN_FULL_WARM
#: warm ones each
GNN_FULL_RUNS = (("graphsage_reddit", "ogb_products"),
                 ("pna", "full_graph_sm"), ("gatedgcn", "full_graph_sm"),
                 ("egnn", "molecule"))
GNN_FULL_WARM = 3
#: gnn_full's cold step of pna, gatedgcn and egnn is held against the same
#: step on a CPU copy (GNN_CHECK_TOL); GraphSAGE at ogb_products is too
#: large for the CPU, so its config (width 128) is held on a cut of
#: GNN_SAGE_CHECK = (nodes, edges, 8 masked slots after them,
#: gnn.EDGE_CHUNK for the check): the edges span five chunks, the last
#: part-full, in both passes of _WeightedGatherSum
GNN_SAGE_CHECK = (50_000, 600_000, 1 << 17)
#: pp: Qwen3-0.6B (bf16, full width) through make_pp_loss_fn with one
#: stage on a one-rank NCCL ("pipe", "data") mesh: n_micro x mb x S tokens,
#: the tokens of lm_train's step (8 x 4,096). Tolerances: the loss within
#: 1e-6 relative of the mean lm_loss over the same microbatches (the same
#: shapes, the same sums); each gradient leaf within 5e-2 of its largest
#: magnitude of make_lm_train_step's gradient (lm_loss over the 32,768
#: tokens as one batch of 8): bf16 products of 8 rows against 2 take other
#: kernels, each rounding to 2^-8, and the bf16 gradients add 16 layers'
#: worth of such roundings
PP_MICRO, PP_MB, PP_WARM_STEPS = 4, 2, 3
PP_S = LM_SHAPES["train_4k"]["seq_len"]
PP_CHECK_TOL = {"loss_rtol": 1e-6, "leaf": 5e-2}


def gnn_step_against_cpu(label: str, step, params, opt, batch,
                         tol: float) -> tuple:
    """One ``step`` on the card and the same step on a CPU copy of
    ``params``, ``opt`` and ``batch``: loss, grad_norm and lr within
    ``tol`` relative, every param, master, m and v leaf within ``tol`` of
    the CPU leaf's largest magnitude, every leaf still on the card.
    Returns (params, opt and metrics from the card, the check's record,
    the card step's seconds)."""
    cpu, opt_cpu, batch_cpu = tree_map(
        lambda t: t.cpu() if isinstance(t, torch.Tensor) else t,
        (params, opt, batch))
    sync()
    t0 = time.perf_counter()
    params, opt, got = step(params, opt, batch)
    sync()
    seconds = time.perf_counter() - t0
    cpu, opt_cpu, want = step(cpu, opt_cpu, batch_cpu)
    scalars = {k: {"card": got[k].item(), "cpu": want[k].item()}
               for k in ("loss", "grad_norm", "lr")}
    for key, pair in scalars.items():
        if not (math.isfinite(pair["cpu"]) and abs(pair["card"]
                - pair["cpu"]) <= tol * abs(pair["cpu"])):
            raise AssertionError(f"{label}: {key} {pair}")
    worst = 0.0
    for a_tree, b_tree in ((params, cpu), (opt, opt_cpu)):
        for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)):
            if a.device.type != torch.device(DEVICE).type:
                raise AssertionError(f"{label}: a leaf left the card")
            if a.dtype.is_floating_point:
                worst = max(worst, rel_err(a, b))
    if not worst <= tol:
        raise AssertionError(f"{label}: a leaf differs by {worst} of its "
                             f"scale")
    return params, opt, got, {"scalars": scalars,
                              "max_err_over_leaf_scale": worst,
                              "tolerance": tol}, seconds


def phase_gnn_check(smi: str) -> None:
    """``GNN_CHECK_CASES`` on the card against the CPU (``GNN_CHECK_TOL``):
    loss, grad_norm, lr and every param, master, m and v leaf."""
    cases = []
    for arch, mode in GNN_CHECK_CASES:
        cfg = lm_get(arch).smoke_config
        card = gnn_mod.init_gnn(cfg, torch.Generator(device=DEVICE)
                                .manual_seed(SEED), device=DEVICE)
        opt = moments_state(card, SEED + 5, GNN_WARMUP)
        reset_launch_counts()
        *_, check, seconds = gnn_step_against_cpu(
            f"gnn_check {arch}/{mode}", make_gnn_train_step(cfg, None, mode),
            card, opt, gnn_batch(cfg, mode, SEED), GNN_CHECK_TOL[cfg.arch])
        cases.append({"arch": arch, "mode": mode, **check,
                      "card_s": seconds,
                      "launches": no_launches(f"gnn_check {arch}")})
    emit({"phase": "gnn_check", "cases": cases, "state_step": GNN_WARMUP,
          "nvidia_smi": smi})


def gnn_shape_config(arch: str, shape: dict):
    """``arch``'s config at ``shape``, as workloads.py builds it: the
    config's depth and width, the shape's features and classes (1 for a
    batched shape), its fan-out for a sampled one."""
    base = lm_get(arch).config
    extra = ({"sample_sizes": tuple(shape["fanout"])}
             if shape["kind"] == "sampled" else {})
    return GNNConfig(name=base.name, arch=base.arch, n_layers=base.n_layers,
                     d_hidden=base.d_hidden, d_feat=shape["d_feat"],
                     n_classes=(1 if shape["kind"] == "batched"
                                else shape["n_classes"]),
                     pna_delta=base.pna_delta, **extra)


def phase_gnn_sampled(smi: str) -> None:
    """GraphSAGE at minibatch_lg: the synthetic graph, its CSR (the
    sampler's constructor), then ``NeighborSampler.batch_at`` on the host
    and a ``make_gnn_train_step(mode="sampled")`` step on the card, once
    cold and ``GNN_SAMPLED_STEPS`` times warm (host seconds per batch,
    card seconds per step, seeds/s end to end, peak bytes); the batch's
    copy to the card timed by events and one warm step on the copied batch
    under torch.profiler, for the card's idle share over an iteration
    (``gnn_sampled_idle``)."""
    shape = GNN_SHAPES[GNN_SAMPLED_SHAPE]
    cfg = gnn_shape_config("graphsage_reddit", shape)
    n, seeds = shape["n_nodes"], shape["batch_nodes"]
    t0 = time.perf_counter()
    src, dst = gen.random_graph(n, GNN_SAMPLED_EDGES, seed=SEED,
                                simple=False)
    rng = np.random.default_rng(SEED)
    feats = rng.standard_normal((n, cfg.d_feat), np.float32)
    labels = rng.integers(0, cfg.n_classes, n)
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sampler = NeighborSampler(src, dst, n, feats, seed=SEED)
    csr_s = time.perf_counter() - t0
    del src, dst
    params = gnn_mod.init_gnn(cfg, torch.Generator(device=DEVICE)
                              .manual_seed(SEED), device=DEVICE)
    opt = adamw_init(params)
    step = make_gnn_train_step(cfg, None, "sampled")
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    host_s, card_s, losses = [], [], []
    for i in range(1 + GNN_SAMPLED_STEPS):
        t0 = time.perf_counter()
        batch = sampler.batch_at(i, seeds, cfg.sample_sizes, labels)
        host_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        losses.append(metrics["loss"].item())
        card_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    launches = no_launches("gnn_sampled")
    if not (all(math.isfinite(x) for x in losses)
            and abs(losses[0] - math.log(cfg.n_classes)) < 0.5):
        raise AssertionError(f"gnn_sampled: losses {losses}, ln C = "
                             f"{math.log(cfg.n_classes)}")
    warm_host, warm_card = host_s[1:], card_s[1:]
    x_bytes = sum(batch[k].nbytes for k in ("x0", "x1", "x2"))
    emit({"phase": "gnn_sampled", "arch": "graphsage_reddit",
          "shape": GNN_SAMPLED_SHAPE, "n_nodes": n,
          "n_edges": GNN_SAMPLED_EDGES, "seeds": seeds,
          "fanout": list(cfg.sample_sizes), "d_feat": cfg.d_feat,
          "reduced": ([] if GNN_SAMPLED_EDGES == shape["n_edges"] else
                      [f"edges {shape['n_edges']} cut to "
                       f"{GNN_SAMPLED_EDGES}: the host's CSR build"]),
          "graph_host_s": graph_s, "csr_build_s": csr_s,
          "batch_host_s": warm_host, "step_card_s": warm_card,
          "cold_batch_host_s": host_s[0], "cold_step_s": card_s[0],
          "batch_host_median_s": statistics.median(warm_host),
          "step_median_s": statistics.median(warm_card),
          "seeds_per_s": seeds * len(warm_host)
          / (sum(warm_host) + sum(warm_card)),
          "batch_feature_bytes": x_bytes, "losses": losses,
          "peak_device_bytes": peak, "launches": launches,
          "nvidia_smi": smi})
    # a warm step's wall is mostly its pageable copy of the numpy batch to
    # the card, which the profiler's device events do not show: time the
    # copy on the card's clock (events around it: the staging and the DMA),
    # then profile a step on the batch already on the card
    sync()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    on_card = {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}
    end.record()
    sync()
    copy_wall = time.perf_counter() - t0
    copy_s = start.elapsed_time(end) / 1e3
    reset_launch_counts()
    prof = phase_profile(
        "gnn_sampled step, batch on the card",
        lambda: step(params, opt, on_card),
        lambda got: math.isfinite(got[2]["loss"].item()), cpu_ops=False,
        extra=lambda: {"nvidia_smi": smi,
                       "launches": no_launches("profiled gnn_sampled")})
    iteration = statistics.median(warm_host) + statistics.median(warm_card)
    busy = prof["device_busy_s"] or 0.0
    emit({"phase": "gnn_sampled_idle",
          "note": "one warm iteration: the host's sampled batch "
                  "(batch_host_median_s) then the step on the numpy batch "
                  "(step_median_s, its copy to the card included); the "
                  "card's kernel time from the profiled step on the batch "
                  "already on the card, the copy's from events",
          "batch_bytes": sum(v.nbytes for v in batch.values()),
          "copy_wall_s": copy_wall, "copy_card_s": copy_s,
          "step_kernels_s": busy, "iteration_s": iteration,
          "kernel_share": busy / iteration,
          "copy_share": copy_s / iteration,
          "idle_share": 1 - (busy + copy_s) / iteration,
          "nvidia_smi": smi})


def gnn_full_batch(cfg, shape: dict, seed: int) -> tuple:
    """(a batch of ``shape`` for ``cfg`` with its tensors on the card,
    the edges one step runs over): ``random_graph(..., simple=False)``
    edges, seeded node features, labels and a label mask on the card."""
    gen_card = torch.Generator(device=DEVICE).manual_seed(seed)
    n, e = shape["n_nodes"], shape["n_edges"]
    if shape["kind"] == "batched":
        g = shape["batch"]
        rng = np.random.default_rng(seed)
        graphs = {"src": torch.from_numpy(rng.integers(0, n, (g, e)))
                  .to(DEVICE, torch.int32),
                  "dst": torch.from_numpy(rng.integers(0, n, (g, e)))
                  .to(DEVICE, torch.int32),
                  "mask": torch.ones((g, e), dtype=torch.bool, device=DEVICE),
                  "h": torch.randn((g, n, cfg.d_feat), generator=gen_card,
                                   device=DEVICE),
                  "x": torch.randn((g, n, 3), generator=gen_card,
                                   device=DEVICE)}
        return {"graphs": graphs,
                "targets": torch.randn(g, generator=gen_card,
                                       device=DEVICE)}, g * e
    src, dst = gen.random_graph(n, e, seed=seed, simple=False)
    batch = {"src": torch.from_numpy(src).to(DEVICE),
             "dst": torch.from_numpy(dst).to(DEVICE),
             "mask": torch.ones(e, dtype=torch.bool, device=DEVICE),
             "feats": torch.randn((n, cfg.d_feat), generator=gen_card,
                                  device=DEVICE),
             "labels": torch.randint(0, cfg.n_classes, (n,),
                                     generator=gen_card, device=DEVICE,
                                     dtype=torch.int32),
             "label_mask": torch.rand(n, generator=gen_card,
                                      device=DEVICE) < 0.5}
    return batch, e


def gnn_sage_chunk_check(cfg) -> dict:
    """GraphSAGE's ``cfg`` (ogb_products' widths) on the card against the
    CPU on the cut ``GNN_SAGE_CHECK``, with ``gnn.EDGE_CHUNK`` set there so
    that the edges span several chunks: one full-graph step from an AdamW
    state past the warmup, within ``GNN_CHECK_TOL``."""
    n, e, chunk = GNN_SAGE_CHECK
    batch, _ = gnn_full_batch(cfg, {"kind": "full", "n_nodes": n,
                                    "n_edges": e}, SEED + 1)
    pad = torch.arange(8, device=DEVICE)
    batch["src"] = torch.cat([batch["src"], pad.neg() - 1]).int()
    batch["dst"] = torch.cat([batch["dst"], pad + n]).int()
    batch["mask"] = torch.cat([batch["mask"], torch.zeros_like(pad,
                                                               dtype=bool)])
    params = gnn_mod.init_gnn(cfg, torch.Generator(device=DEVICE)
                              .manual_seed(SEED + 1), device=DEVICE)
    opt = moments_state(params, SEED + 6, GNN_WARMUP)
    saved, gnn_mod.EDGE_CHUNK = gnn_mod.EDGE_CHUNK, chunk
    try:
        *_, check, seconds = gnn_step_against_cpu(
            "gnn_full graphsage chunked", make_gnn_train_step(cfg, None),
            params, opt, batch, GNN_CHECK_TOL[cfg.arch])
    finally:
        gnn_mod.EDGE_CHUNK = saved
    return {"n_nodes": n, "n_edges": e + 8, "edge_chunk": chunk,
            "chunks": -(-(e + 8) // chunk), "state_step": GNN_WARMUP,
            **check, "card_s": seconds}


def phase_gnn_full(smi: str) -> None:
    """``GNN_FULL_RUNS``: each config at its shape, a cold step and
    ``GNN_FULL_WARM`` warm ones (seconds, edges/s over the edges a step
    runs, peak bytes, the five kernels' launches: 0). The cold step of
    the small shapes is held against the CPU (``gnn_step_against_cpu``);
    GraphSAGE's config against the CPU on a cut of the graph
    (``gnn_sage_chunk_check``)."""
    for arch, shape_name in GNN_FULL_RUNS:
        shape = GNN_SHAPES[shape_name]
        cfg = gnn_shape_config(arch, shape)
        mode = "batched" if shape["kind"] == "batched" else "full"
        reset_launch_counts()
        big = arch == "graphsage_reddit"
        check = gnn_sage_chunk_check(cfg) if big else None
        batch, edges = gnn_full_batch(cfg, shape, SEED)
        params = gnn_mod.init_gnn(cfg, torch.Generator(device=DEVICE)
                                  .manual_seed(SEED), device=DEVICE)
        opt = (adamw_init(params) if big
               else moments_state(params, SEED + 5, GNN_WARMUP))
        step = make_gnn_train_step(cfg, None, mode)
        sync()
        torch.cuda.reset_peak_memory_stats()
        seconds, losses = [], []
        for i in range(1 + GNN_FULL_WARM):
            if i == 0 and not big:
                params, opt, metrics, check, cold = gnn_step_against_cpu(
                    f"gnn_full {arch}", step, params, opt, batch,
                    GNN_CHECK_TOL[cfg.arch])
                losses.append(metrics["loss"].item())
                seconds.append(cold)
                continue
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch)
            losses.append(metrics["loss"].item())
            sync()
            seconds.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"gnn_full {arch}: losses {losses}")
        warm = statistics.median(seconds[1:])
        rec = {"phase": "gnn_full", "arch": arch, "shape": shape_name,
               "mode": mode, "n_nodes": shape["n_nodes"],
               "edges_per_step": edges, "d_feat": cfg.d_feat,
               "d_hidden": cfg.d_hidden, "n_layers": cfg.n_layers,
               "cold_s": seconds[0], "warm_s": seconds[1:],
               "warm_median_s": warm, "edges_per_s": edges / warm,
               "losses": losses, "peak_device_bytes": peak,
               "param_bytes": tree_bytes(params),
               "check_against_cpu": check,
               "launches": no_launches(f"gnn_full {arch}"),
               "nvidia_smi": smi}
        if big:
            # a plain port's layer-2 aggregation: h[src] and h[src] * w,
            # E x d_hidden float32 each, held at once (gnn.py's
            # _WeightedGatherSum adds EDGE_CHUNK edges at a time instead)
            rec["reckoned_unchunked_bytes"] = 2 * edges * cfg.d_hidden * 4
            rec["edge_chunk"] = gnn_mod.EDGE_CHUNK
        emit(rec)
        del batch, params, opt
        gc.collect()
        torch.cuda.empty_cache()


def phase_pp(smi: str) -> None:
    """Qwen3-0.6B (bf16) through the pipeline with one stage on a one-rank
    NCCL ``("pipe", "data")`` mesh: the loss against the mean ``lm_loss``
    over the same microbatches, every gradient leaf against
    make_lm_train_step's gradient (``lm_loss`` over the same tokens as one
    batch), within ``PP_CHECK_TOL``; then a cold ``make_pp_train_step``
    step and ``PP_WARM_STEPS`` warm ones (seconds, tokens/s, peak
    bytes)."""
    cfg = lm_get(LM_CHECK_ARCH).config
    tokens = SyntheticTokens(cfg.vocab, PP_MICRO * PP_MB, PP_S,
                             seed=SEED).batch_at(0)["tokens"]
    micro = {"tokens": tokens.reshape(PP_MICRO, PP_MB, -1)}
    n_tokens = PP_MICRO * PP_MB * PP_S
    with one_rank_nccl_mesh(("pipe", "data")) as mesh:
        par = Parallelism(mesh=mesh, dp_axes=("data",), tp_axis="model")
        pp = PipelineConfig(n_stages=1, n_micro=PP_MICRO)
        params = lm_init(cfg, torch.Generator(device=DEVICE)
                         .manual_seed(SEED), device=DEVICE)
        staged = stageify_params(params, 1)  # a view: one stage is [1, L]
        loss_fn = make_pp_loss_fn(cfg, par, pp)

        def value_and_grad(fn, tree):
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(tree)]
            with torch.enable_grad():
                loss = fn(tree_unflatten(tree, leaves))
                grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), grads

        (pp_loss, pp_grads), rec = timed(lambda: value_and_grad(
            lambda p: loss_fn(p, micro), staged))
        with torch.no_grad():
            mean_mb = sum(lm_loss(params, {"tokens": micro["tokens"][i]},
                                  cfg, Parallelism.none())
                          for i in range(PP_MICRO)) / PP_MICRO
        lm_value, lm_grads = value_and_grad(
            lambda p: lm_loss(p, {"tokens": tokens}, cfg,
                              Parallelism.none()), params)
        tol = PP_CHECK_TOL
        got, want = pp_loss.item(), mean_mb.item()
        if not abs(got - want) <= tol["loss_rtol"] * abs(want):
            raise AssertionError(f"pp: loss {got}, mean lm_loss {want}")
        worst = 0.0
        for a, b in zip(pp_grads, lm_grads):
            worst = max(worst, rel_err(a.reshape(b.shape), b))
        if not worst <= tol["leaf"]:
            raise AssertionError(f"pp: a gradient leaf differs by {worst} "
                                 f"of its scale")
        check = {"loss": got, "mean_lm_loss": want,
                 "lm_loss_one_batch": lm_value.item(),
                 "max_grad_err_over_leaf_scale": worst, "tolerance": tol,
                 "value_and_grad_s": rec["seconds"],
                 "launches": no_launches("pp check")}
        del pp_grads, lm_grads
        gc.collect()
        torch.cuda.empty_cache()
        opt = adamw_init(staged)
        step = make_pp_train_step(cfg, par, pp, AdamWConfig(lr=1e-3),
                                  total_steps=1 + PP_WARM_STEPS, warmup=1)
        sync()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        seconds, losses = [], []
        for i in range(1 + PP_WARM_STEPS):
            batch = SyntheticTokens(cfg.vocab, PP_MICRO * PP_MB, PP_S,
                                    seed=SEED).batch_at(i)["tokens"]
            t0 = time.perf_counter()
            staged, opt, metrics = step(
                staged, opt, {"tokens": batch.reshape(PP_MICRO, PP_MB, -1)})
            losses.append(metrics["loss"].item())
            sync()
            seconds.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"pp: losses {losses}")
        warm = statistics.median(seconds[1:])
        emit({"phase": "pp", "arch": LM_CHECK_ARCH, "dtype": cfg.param_dtype,
              "n_stages": 1, "n_micro": PP_MICRO, "mb": PP_MB, "S": PP_S,
              "tokens_per_step": n_tokens, "check": check,
              "cold_s": seconds[0], "warm_s": seconds[1:],
              "warm_median_s": warm, "tokens_per_s": n_tokens / warm,
              "losses": losses, "peak_device_bytes": peak,
              "state_bytes": tree_bytes(opt),
              "launches": no_launches("pp"), "nvidia_smi": smi,
              "note": "one stage on one card: no stage boundary is crossed; "
                      "the schedule over several stages runs only in the "
                      "eight-rank gloo test (tests/test_torch_pipeline.py)"})
        del params, staged, opt
    gc.collect()
    torch.cuda.empty_cache()


def phase_gnn_pp(smi: str) -> None:
    """The graph-network and pipeline phases, TF32 off as the earlier
    phases set it, then their seconds (``gnn_pp_phases``)."""
    t0 = time.perf_counter()
    seconds = {}
    for name, fn in (("gnn_check", phase_gnn_check),
                     ("gnn_sampled", phase_gnn_sampled),
                     ("gnn_full", phase_gnn_full), ("pp", phase_pp)):
        t1 = time.perf_counter()
        fn(smi)
        seconds[name] = time.perf_counter() - t1
    emit({"phase": "gnn_pp_phases", "seconds": time.perf_counter() - t0,
          "by_phase": seconds, "nvidia_smi": smi,
          "launches": no_launches("gnn_pp_phases")})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    build = phase_build()

    t0 = time.perf_counter()
    src, dst, planted = gen.planted_bridge_graph(N_NODES, N_EDGES, N_BRIDGES,
                                                 seed=SEED)
    emit({"phase": "graph", "n": N_NODES, "edges": len(src),
          "bridges": len(planted), "host_s": time.perf_counter() - t0})

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    checks = phase_kernels(pad_graph(src, dst, N_NODES), flush)
    del flush

    runs = {}
    for final in ("device", "host"):
        cold = run_main_path(src, dst, planted, final, "cold")
        runs[f"find_bridges(final={final!r})"] = warm = run_main_path(
            src, dst, planted, final, "warm")
        if cold["launches"] != warm["launches"]:
            raise AssertionError(f"launch counts differ between runs of "
                                 f"final={final!r}")
    phase_profile("find_bridges(final='device')",
                  lambda: find_bridges(src, dst, N_NODES, final="device"),
                  lambda got: got == planted)

    truth = planted_truth(N_NODES, N_BRIDGES, planted)
    runs.update(phase_analyze(src, dst, truth))
    for kind, final in (("cuts", "device"), ("cuts", "host")):
        phase_profile(run_label(kind, final, None),
                      lambda: analyze(src, dst, N_NODES, kind=kind,
                                      final=final),
                      lambda got: got == truth[kind])
    phase_kernel_paths(src, dst, planted, truth)
    phase_check()
    dist_launches = phase_distributed(src, dst, truth)
    engine_launches = phase_engine(src, dst, planted, truth, smi)
    stream_launches = phase_streaming(src, dst, planted, truth, smi)
    phase_streaming_sharded(src, dst, truth)
    phase_repairs()
    t0 = time.perf_counter()
    sched_launches = phase_scheduler(smi)
    phase_checkpoint(src, dst, planted, truth, smi)
    failover_launches = phase_failover(src, dst, truth, smi)
    phase_failover_drill(smi)
    emit({"phase": "serving_phases", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    driver_launches = phase_serve_driver(smi)
    baseline_launches = phase_baseline(smi)
    emit({"phase": "serve_driver_baseline_phases",
          "seconds": time.perf_counter() - t0})

    # the plain versions' float32 products run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = init_sasrec(SASREC, torch.Generator(device="cuda").manual_seed(
        SEED))
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    checks["embedding_bag"] = check_embedding_bag(params["item_emb"], flush)
    emit({"phase": "kernel_check", **checks["embedding_bag"]})
    sweep_embedding_bag(params["item_emb"], flush)
    attn_checks, attn_runs = check_flash_attention(flush,
                                                   torch.device("cuda"))
    for rec in attn_checks.values():
        emit({"phase": "kernel_check", **rec})
    checks.update(attn_checks)
    runs.update(attn_runs)
    del flush
    torch.cuda.empty_cache()
    runs.update(phase_recsys(params))
    t0 = time.perf_counter()
    phase_sasrec_train_check(params)
    phase_sasrec_train(params, smi)
    mesh_launches = phase_recsys_mesh(params)
    emit({"phase": "training_and_mesh_phases",
          "seconds": time.perf_counter() - t0})
    del params
    torch.cuda.empty_cache()
    phase_lm(smi)
    phase_lm_train_moe(smi)
    phase_gnn_pp(smi)

    kernels = []
    for name, rec in checks.items():
        launches = runs[LAUNCHES_FROM[name]]["launches"][name]
        if launches <= 0 or rec["path"] != "cuda":
            raise AssertionError(f"{name}: {LAUNCHES_FROM[name]} did not "
                                 f"launch it")
        kernels.append({
            "name": name, "route": rec["route"], "path": rec["path"],
            "source": rec["source"], "replaces": rec["replaces"],
            "launches": launches, "launches_from": LAUNCHES_FROM[name],
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            **({"launches_distributed": dist_launches[name]}
               if name in dist_launches else {}),
            **({"launches_engine": engine_launches[name]}
               if name in engine_launches else {}),
            **({"launches_streaming": stream_launches[name]}
               if name in stream_launches else {}),
            **({"launches_scheduler": sched_launches[name]}
               if name in sched_launches else {}),
            **({"launches_failover": failover_launches[name]}
               if name in failover_launches else {}),
            **({"launches_serve_driver": driver_launches[name]}
               if name in driver_launches else {}),
            **({"launches_baseline": baseline_launches}
               if name == "boruvka_round" else {}),
            **({"launches_recsys_mesh": mesh_launches}
               if name == "embedding_bag" else {}),
            **({"previous_kernel_ms": rec["previous_kernel_ms"]}
               if "previous_kernel_ms" in rec else {})})
    print(smi, flush=True)
    emit({"kernels": kernels, "build_s": build["nvcc_s"]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
