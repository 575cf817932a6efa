"""Smoke run of the PyTorch/CUDA port on one card: build, parity, exactness, full size.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without its last
line):

  1. build   — compile the nine CUDA kernels from ``src/repro_torch/csrc``
               (one nvcc per source, in parallel), print the build time and
               the ptxas reports; fails unless the flash library's SASS holds
               HGMMA (tensor-core) instructions and the bf16 backward's main
               kernel (`flash_bwd_wgmma_kernel`) HGMMA and no HMMA
               (mma.sync); prints the backward's ptxas report (registers,
               spills) by function;
  2. card    — print ``nvidia-smi --query-gpu=name,power.limit``;
  3. parity  — each kernel against its plain torch version on the card:
               mining kernels compared exactly (frontier expansion at
               k = 2..5, an edgeless graph, cap overflow and a stacked P > 1
               bucket; greedy mIS with τ cut mid-table, state carried across
               calls, P > 1, a shared-memory bitmap and a global-memory one
               (n > 1.8 M), and the adversarial `MIS_EDGE_CASES` — conflict
               chains, one shared vertex, duplicate vertices in a row, τ
               cut inside a batch, count ≥ τ at entry, n_valid ≤ 0 and
               > cap, k = 1 and 16 — each with a shared and a global
               bitmap; the frontier also at the planner's floor cap
               of 1 024, the smallest cap ``auto`` derives); flash attention on the reference's kernel-test
               cases, the qwen3-1.7b shape, hd 128 window + softcap,
               non-causal and ragged S, within `FLASH_TOL` (bf16 2e-2,
               f32 1e-5), each case's max abs error printed; the embedding
               bag (`BAG_CASES`: f32 / bf16, sum / mean, H 1 and 4 with
               pads and ids ≥ R, T 1, 2, 3 and 26, weights, D 8, 9, 64,
               72, 128, ragged B·T, a table view one element off its
               alignment; exact at H = 1, else `BAG_TOL`)
               and the gather-aggregate (`AGG_CASES`: Dmax 1, 15, 40, F 7,
               8, 128, 602, ragged N; `AGG_TOL`); the three backward
               kernels against autograd of their plain forwards on f32
               copies, each launched twice with identical bytes: the
               flash backward (`FLASH_BWD_CASES`: the trainer's qwen3
               shape and its train_4k length S 4 096, ragged S with GQA,
               window + softcap at hd 64 and 128, non-causal, hd 128 at
               S 1, 65, 129 and G 4, hd 16 MQA, bf16 and f32), the bag
               backward
               (`BAG_BWD_CASES`: repeated ids, pads, ids ≥ R, T 26, D 9)
               and the aggregate transpose (`AGG_T_CASES`: hub nodes, one
               node of 5 000 destinations among mostly empty ones, a view
               one element off its alignment on the narrow path with the
               16-byte path's bytes); the
               fused AdamW against its plain version, bit for bit
               (`ADAMW_CASES`);
  4. golden  — the port's mining CLI on cuda for gnutella ×0.1, σ = 20, mis,
               batched, equal to the reference CLI's committed --json; then
               the same flags under ``--execution auto`` (the planner at
               its built-in H100 calibration), whose frequent set must be
               the golden's;
  5. main    — the mining CLI on cuda at paper size (mico ×1.0: 100 000
               vertices, 1 080 298 edges, 29 labels), mis, batched, max
               size 3; launch counts are zeroed just before and read just
               after;
  5a. auto   — the same run under the CLI's default ``--execution auto``:
               the reference's default command; its frequent set and
               supports (and per-level counts) must equal phase 5's; the
               plan of each level is printed;
  5b. sampled — the same run under ``--execution sampled --sample-fraction
               0.25`` with escalation: the same frequent set and exact
               supports, at least one escalated block replayed from the
               sample pass's records (``counters["replay_blocks"]``) with
               the mis_bitmap kernel launched on those replays; prints the
               records' bytes and the process's peak host memory.  Both
               phases zero the launch counts just before and read them
               just after, and write their calibration files under
               ``build/smoke/``;
  6. serve   — the serving CLI on cuda: qwen3-1.7b at full width and depth
               (28 layers, random weights from seed 0), batch 4, a 1 024-token
               prompt prefilled into the KV cache, 32 new tokens decoded
               from it; launch counts zeroed just before and read just
               after; fails unless every prefill launched the flash kernel
               once per layer, the logits are finite and the replay of the
               first 128 prompt tokens through decode ends on the prefill's
               logits within 0.02·max|logit| + 0.05 (``launch/serve.py``
               says why);
  6b. serve-<arch> — the other four LM archs through ``serve.serve()``
               at full width, random weights from seed 0 built layer by
               layer in bf16, batch 4, a 1 024-token prompt, 16 new
               tokens (`SERVE_ARCHS`): qwen3-moe-30b-a3b (48 layers,
               replay 64, below its prefill's expert capacity 80),
               gemma2-27b (46) and minitron-4b (32) with replay 128, and
               mixtral-8x7b cut in depth to 16 of its 32 layers (printed;
               replay 128); each with counts zeroed just before and read
               just after, the same checks as phase 6, and for the MoE
               archs a second launch of layer 0's MoE on the timed
               prefill's input that must repeat its bytes; prints
               ``ttft_s``, decode step ms, ``moe_capacity``,
               ``moe_dropped`` and peak memory, and frees each model
               before the next;
  7. recsys  — dlrm-rm2 at full width (26 tables of 1 000 000 × 64, random
               from seed 0) through the arch's serve and retrieval steps:
               serve_p99 (batch 512), serve_bulk (262 144) and
               retrieval_cand (1 query × 1 000 448 candidates, top 100);
               counts zeroed just before and read just after, one
               embedding-bag launch per forward; the bags equal their
               plain version bit for bit and the outputs equal the same
               forward with the plain bag;
  8. gnn     — graphsage-reddit minibatch_lg: the R-MAT stand-in graph
               (Reddit's 232 965 vertices, 114 615 892 directed edges),
               block 0 of the port's sampler (1 024 seeds, fanout 15-10),
               the forward loss on the card; counts zeroed just before and
               read just after, two gather-aggregate launches per forward;
               logits equal to the same forward with the plain aggregate;
               then train-gnn: SAGE_TRAIN_STEPS train steps (loss, grads,
               AdamW) over the sampler's blocks 0.., counts zeroed and
               read around them (two aggregates and one transpose a
               step), block 0's loss falling, the transpose timed at
               layer 1 (the out-degrees' max, p99 and empty share; the
               CSR's build; a SHA-256 of the output) and held there against
               autograd of the plain aggregate (f32 copies), launched
               twice (identical bytes);
  8b. gnn-archs — every other GNN training run the port has
               (`GNN_ARCH_RUNS`): schnet, nequip and graphcast on
               full_graph_sm and molecule (the arch's full-size ``inputs``)
               and minibatch_lg (phase 8's sampler, blocks 0–3, positions
               for the whole graph from the seed), graphsage-reddit on
               full_graph_sm and molecule (its graph-level head), each at
               full width from ``torch.Generator`` seed 0 (graphcast at
               full_graph_sm cut to 4 of its 16 layers: `GNN_ARCH_LAYERS`),
               `GNN_ARCH_STEPS` train steps with counts zeroed just before
               and read just after (AdamW once a parameter a step;
               GraphSAGE two aggregates and one transpose a step); every
               loss finite, the held batch's loss falling by more than
               the spread of its readings; GraphSAGE's node logits equal to the same forward with the plain
               aggregate; at molecule the card against a CPU copy
               (`parity.gnn_card_against_cpu`; graphcast at 2 layers);
               prints losses, median step ms and peak memory;
  9. kernels — mining kernels vs plain versions again on real blocks of the
               mico graph at the main path's shapes (the frontier's hub
               block at level 2 also by pass, with its random loads and
               scratch; the mIS kernel's rows tested, passed by its
               prefilter and decided at the hub block), the flash kernel
               at the serve phase's per-layer shape (the row) and at
               phase 6b's (`FLASH_ARCH_SHAPES`: qwen3-moe's H 32 / KV 4,
               minitron's 24 / 8, gemma2's local layer 32 / 16 with
               softcap 50 and window 4 096 at S 5 120; printed, SDPA
               beside it where it computes the same function), the
               embedding bag at
               serve_bulk's bags and the gather-aggregate at layer 0 of
               the block, with times (CUDA events), bounds, the library
               call's time and the launch counts of phases 5a (the mining
               kernels: the reference's default command) and 6–8 (the
               flash kernel's: phases 6 and 6b), as one JSON line;
 10. session — after the kernel timings, checkpointed sessions through
               the CLI's session flags:
               session-auto (phase 5a's command with ``--checkpoint-dir``
               and ``--checkpoint-every`` `SESSION_EVERY`, uninterrupted;
               its --json equals 5a's minus wall-clock fields; prints the
               snapshots, bytes a snapshot, seconds in saves and the wall
               against 5a), session-kill (the same command killed by
               ``REPRO_TORCH_FAULT_PLAN`` — a crash at a mid-level-2
               ``session.snapshot`` — then ``--resume``: equal to
               session-auto, with fewer mining launches than an
               uninterrupted run), session-sigterm (the golden's flags in a
               child process with ``--checkpoint-every 1``, SIGTERM once the
               graph is loaded: exit 75, then ``--resume`` equals the
               golden) and mis-exact (``mine(metric="mis_exact")`` through
               the API on the card and on the CPU, on a graph inside the
               reference's 60-embedding limit: equal results; prints the
               collector's dispatches and frontier launches);
 11. train   — train-lm: the trainer CLI (``repro_torch.launch.train``)
               at qwen3-1.7b's full width and depth, `TRAIN_FLAGS` (8
               steps of batch 4 × 1 024, cut from train_4k), counts
               zeroed and read around it (flash forward and backward once
               a layer a step, AdamW once a parameter a step), a falling
               loss, its step time, tokens/s,
               peak memory and the ~21 GB final checkpoint (deleted
               after); then the flash backward timed at the per-layer
               shape (held against autograd of the plain version there;
               SDPA's backward beside it under one pinned backend)
               and AdamW at the embedding leaf (bit for bit against its
               plain version there; ``torch._fused_adamw_`` timed beside
               it, there and over all leaves).  train-resume, in a child
               process with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (the other
               phases keep cuBLAS's default workspace): the same width at
               2 layers under
               ``torch.use_deterministic_algorithms`` (warn_only: the
               ops without a deterministic path are printed), once
               uninterrupted and once cut by a stalled step past
               ``--step-budget-s`` (exit 75) and resumed: the final
               checkpoints equal byte for byte.  train-dlrm: dlrm-rm2
               at full width, `DLRM_TRAIN_STEPS` train_batch steps of
               65 536 (f32 tables cast to bf16 each step, the bag and its
               backward once a step), the first batch's loss falling;
               the table cast and the bag backward timed, the bag
               backward held against autograd of the plain bag at the
               first batch's bags (f32 copies, a table at a time) and
               launched twice (identical bytes).  train-lm-sharded, right
               after train-lm: (a) the same flags under ``torchrun
               --standalone --nproc-per-node 1`` on NCCL with
               ``--model-parallel 1``, through the trainer's mesh path
               (a 1×1 mesh, `phase_train_rank` in the rank: counts
               zeroed before the CLI, read after it): its loss lines and
               final checkpoint (every leaf's shape, dtype and CRC-32)
               must equal train-lm's, and so must its launches; its
               median step, tokens/s and peak are printed beside
               train-lm's; (b) world size 2 on the one card over gloo with
               CUDA tensors, ``--model-parallel 2``, full width at
               `SHARDED_LAYERS` of 28 layers, 4 steps, against world size
               1 (NCCL) at the same depth: losses within `SHARDED_TOL`,
               each rank's peak below world size 1's, and every rank
               launching the flash forward, backward and AdamW (neither
               run writes its final checkpoint: nothing reads it);
 12. distributed — the distributed plane through the CLI under
               ``torchrun --standalone`` (each rank `phase_dist_rank`:
               launch counts zeroed before the CLI and read after it,
               the plane's counters and its collectives' CUDA-event
               span): main-distributed, mico x1.0 with phase 5's flags
               under ``--metric mis_luby --execution distributed`` on one
               NCCL rank, whose frequent set, supports and level counts
               must equal the same flags under ``--execution batched``,
               with no ``plane_fallback`` and frontier launches counted;
               golden-distributed, the golden's flags under mis_luby
               (`DIST_GOLDEN_FLAGS`) at world size 2 (two gloo ranks
               with CUDA tensors on the one card: NCCL refuses two ranks
               on one device) equal to world size 1 (NCCL) minus wall
               clock and dispatches, then a world-size-2 session killed
               after snapshot `DIST_KILL_AT` (a super-block cursor in
               flight) and resumed at world size 1, equal to the
               uninterrupted run.  One card shows no multi-card
               behaviour: world size 2 checks the ranks' arithmetic and
               the collectives' semantics, not their speed;
 13. the kernels JSON line (all nine kernels; the backward kernels' and
     AdamW's launches from the training phases, phase 8b's added to the
     aggregate's, the transpose's and AdamW's, train-lm-sharded's to the
     flash kernels' and AdamW's), then the last line:
     {"ok": true, "device": {...}}.

Imports torch and the port (``src/repro_torch``) only — never JAX and
nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "src/repro_torch/testing/golden/gnutella_s0.1_sigma20_mis.json"
OUT = ROOT / "build" / "smoke"   # ignored by git: the runs' --json files

# the full-size main path (phase 5).  On this graph k = 3 mIS supports top
# out near 0.7× the k = 2 ones, below the 0.857× that λ = 0.4 demands
# (τ₃/τ₂ = 0.6σ/0.7σ), so the slider sits at λ = 0 (τ = σ/k) and σ = 784
# makes ~90 k = 2 and over a hundred k = 3 patterns frequent (PERF.md)
MICO_SIGMA = 784
MICO_LAM = 0.0
# frontier capacity: the largest level of any (k ≤ 3 candidate, root block)
# of that run finds 111 914 embeddings (scripts/torch_frontier_survey.py),
# so at 2^17 no level overflows and the answer is exact
MICO_CAP = 131072


def mico_flags(sigma: int, execution: str = "batched") -> list:
    return ["--dataset", "mico", "--scale", "1.0", "--sigma", str(sigma),
            "--lam", str(MICO_LAM), "--metric", "mis", "--execution",
            execution, "--max-size", "3", "--cap", str(MICO_CAP)]
GOLDEN_FLAGS = ["--dataset", "gnutella", "--scale", "0.1", "--sigma", "20",
                "--lam", "0.4", "--max-size", "3", "--execution", "batched",
                "--metric", "mis"]

# the session phases (10): the cadence of session-auto and session-kill.
# At 1 (the CLI's default) every snapshot inside mico's sampled level 1
# rewrites all its replay rows as JSON — 33–42 MB a snapshot, ~5 s each
# (PERF.md) — so the card phase snapshots every SESSION_EVERY
# carried-state updates; level boundaries always snapshot
SESSION_EVERY = 100
# mis_exact (10): the reference's exact MIS takes at most 60 distinct
# embeddings a pattern; this graph keeps every k ≤ 3 pattern inside it
MIS_EXACT_GRAPH = dict(n=300, m=450, n_labels=20, seed=9)
MIS_EXACT_SIGMA = 4

# the serving phase (6): full width and depth, random weights
# The prompt replay checks the prefill through 128 eager decode steps (2
# key tiles of the flash kernel): ~45 ms a step, so all 1 024 took ~50 s,
# half the smoke; the prefill's own cache feeds decode either way.
SERVE_FLAGS = ["--arch", "qwen3-1.7b", "--batch", "4", "--prompt-len", "1024",
               "--gen-len", "32", "--replay-len", "128", "--seed", "0"]

# the other LM archs (6b), each at full width through `serve.serve()` (the
# CLI has no depth flag): (arch, layers or None for all, replay length).
# Batch 4, a 1 024-token prompt, 16 new tokens, seed 0.  The replay stays
# below qwen3-moe's prefill capacity (C = 80; mixtral's is 320), where the
# prefill drops nothing (`launch/serve.py`), and short because eager
# decode is host-bound.  mixtral-8x7b runs 16 of its 32 layers: its 93.1
# GB of bf16 weights do not fit one 80 GB card until sharding exists.
SERVE_ARCHS = (("qwen3-moe-30b-a3b", None, 64), ("gemma2-27b", None, 128),
               ("minitron-4b", None, 128), ("mixtral-8x7b", 16, 128))
SERVE_ARCH_BATCH, SERVE_ARCH_PROMPT, SERVE_ARCH_GEN = 4, 1024, 16

# the flash kernel at those archs' per-layer shapes (phase 9): (name, B, S,
# H, KV, window, softcap), hd 128, bf16, causal.  gemma2's local layers run
# at S 5 120 so that the 4 096 window bites (B 1: the plain version holds
# the (S, S) f32 scores of every head)
FLASH_ARCH_SHAPES = (("qwen3-moe-30b-a3b", 4, 1024, 32, 4, None, None),
                     ("minitron-4b", 4, 1024, 24, 8, None, None),
                     ("gemma2-27b local", 1, 5120, 32, 16, 4096, 50.0))

# the GNN phase (8): the shape's graph at Reddit's size, no cut (build
# times in PERF.md)
SAGE_SEED = 0

# H100 SXM peaks: HBM bytes/s, dense bf16 tensor-core FLOP/s and float32
# FLOP/s outside the tensor cores (NVIDIA data sheet), and int32
# instructions/s: 132 SMs × 64 int32 lanes per clock × the 1.98 GHz boost
# clock (the data sheet's 67 TFLOP/s float32 counts an FMA as two
# operations, int32 does not)
HBM_BYTES_S = 3.35e12
BF16_FLOPS_S = 989e12
F32_FLOPS_S = 67e12
INT32_OPS_S = 132 * 64 * 1.98e9
INT32_MAX = 2**31 - 1


def _log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def _time_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after one warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms_by_kernel(fn) -> dict:
    """Device ms of each CUDA kernel (and copy or fill) of one call of fn,
    by torch.profiler; names cut to the kernel's own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels._build import kernel_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            name = kernel_function(ev.key)[:40]
            out[name] = out.get(name, 0.0) + ev.self_device_time_total / 1e3
    return out


def _peak_extra_bytes(fn, out_bytes: int) -> int:
    """Device bytes one call of fn allocates at its peak beyond its
    outputs' ``out_bytes`` (the caching allocator's count)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base - out_bytes
    del out
    return extra


def _sha256(t: torch.Tensor) -> str:
    """SHA-256 of a tensor's bytes (copied to the host)."""
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


def _strip_wall_clock(d: dict) -> dict:
    d = dict(d)
    d.pop("elapsed_s")
    d["per_level"] = {k: {kk: vv for kk, vv in v.items() if kk != "wall_s"}
                      for k, v in d["per_level"].items()}
    return d


def _run_cli(flags, json_path) -> dict:
    from repro_torch.launch import mine as cli

    rc = cli.main(flags + ["--device", "cuda", "--json", str(json_path)])
    if rc != 0:
        raise RuntimeError(f"CLI exited {rc}")
    return json.loads(Path(json_path).read_text())


def phase_build():
    import shutil

    from repro_torch.kernels import _build

    t0 = time.monotonic()
    _build.build_all()
    _log(f"build: {len(_build.SOURCES)} kernels in "
         f"{time.monotonic() - t0:.1f} s")
    for name in _build.SOURCES:
        for line in _build.ptxas_report(name).splitlines():
            if "Used" in line:
                _log(f"ptxas {name}: {line.strip()}")
    # the bf16 flash kernel must run on the tensor cores: HGMMA in its SASS
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass",
                           str(_build.library_path("flash_attention"))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    hgmma = {}
    for word in sass.split():
        if word.startswith("HGMMA."):
            hgmma[word] = hgmma.get(word, 0) + 1
    _log(f"sass flash_attention: {hgmma}")
    if not hgmma:
        raise AssertionError("no HGMMA instruction in the flash kernel's SASS")
    # the bf16 backward at hd 64 / 128: HGMMA and no HMMA (mma.sync) in its
    # main kernel; its ptxas report (registers, spills) by function
    sass = subprocess.run([cuobjdump, "-sass",
                           str(_build.library_path("flash_attention_bwd"))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    for fn, counts in _sass_mma_by_function(sass).items():
        _log(f"sass flash_attention_bwd {fn}: {counts}")
        if "flash_bwd_wgmma_kernel" in fn and (
                not counts["HGMMA"] or counts["HMMA"]):
            raise AssertionError(f"{fn}: the wgmma backward must issue "
                                 f"HGMMA and no HMMA: {counts}")
    for line in _ptxas_by_function(
            _build.ptxas_report("flash_attention_bwd")):
        _log(f"ptxas flash_attention_bwd {line}")


def _sass_mma_by_function(sass: str) -> dict:
    """HGMMA (wgmma) and HMMA (mma.sync) instruction counts of each function
    in a `cuobjdump -sass` listing, by the function's (mangled) name."""
    import re

    out, fn = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn is not None:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    out[fn][op] += 1
    return out


def _ptxas_by_function(report: str) -> list:
    """`-Xptxas -v` lines reduced to one per function: its (mangled) name,
    registers, stack, spill stores and loads."""
    import re

    lines, fn, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        elif fn and "spill" in line:
            spill = line.strip()
        elif fn and "Used" in line:
            lines.append(f"{fn}: {line.split(':', 1)[1].strip()}; {spill}")
            fn, spill = None, ""
    return lines


def phase_card() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def phase_parity(dev) -> dict:
    import numpy as np

    from repro_torch.core import MatchConfig, Pattern, build_graph
    from repro_torch.core.mis import bitmap_words
    from repro_torch.core.planner import CAP_FLOOR
    from repro_torch.data.synthetic import rmat_graph
    from repro_torch.kernels.mis_bitmap.kernel import uses_shared_memory
    from repro_torch.testing.parity import (
        MIS_EDGE_CASES, frontier_case, mis_case, mis_edge_case, patterns_by_k,
        random_graph,
    )

    worst = {"frontier_expand": 0, "mis_bitmap": 0}

    def fcase(g, pats, cfg, bs=0):
        worst["frontier_expand"] = max(worst["frontier_expand"],
                                       frontier_case(g, pats, cfg, dev, bs))

    def geometry(g, **kw):
        return MatchConfig.for_graph(g, **kw)

    g = random_graph(400, 3, 3, seed=1)
    cfg = geometry(g, cap=512, root_block=128)
    by_k = patterns_by_k(g, 5)
    assert sorted(by_k) == [2, 3, 4, 5], sorted(by_k)
    for k, pats in by_k.items():
        fcase(g, pats, cfg)                      # stacked P > 1 bucket
        fcase(g, pats[:1], cfg, cfg.root_block)  # P = 1, second block
    gd = random_graph(300, 4, 2, seed=2, undirected=False)
    cd = geometry(gd, cap=1024, chunk=4)         # several chunks per row
    for k, pats in patterns_by_k(gd, 4, per_level=8).items():
        fcase(gd, pats, cd)
    gs = rmat_graph(3000, 30000, n_labels=2, seed=4)  # skewed degrees
    for cap in (1000, CAP_FLOOR, 16384):  # partial / auto's floor / many tiles
        for k, pats in patterns_by_k(gs, 3, per_level=8).items():
            fcase(gs, pats, geometry(gs, cap=cap, root_block=1024, chunk=16))
    go = random_graph(200, 6, 1, seed=5)
    for k, pats in patterns_by_k(go, 3).items():  # cap overflow
        fcase(go, pats, geometry(go, cap=64, root_block=128))
    n = 32
    ge = build_graph(n, np.zeros((0, 2), np.int64), np.zeros(n, np.int32))
    fcase(ge, [Pattern(np.array([[False, True], [False, False]]),
                       np.zeros(2, np.int32))],
          geometry(ge, cap=64, root_block=32))
    _log("parity: frontier_expand == plain (exact, tolerance 0) on k=2..5, "
         f"multi-chunk, skewed degrees, cap {CAP_FLOOR}, overflow, edgeless, "
         "P>1")

    def mcase(*a, **kw):
        worst["mis_bitmap"] = max(worst["mis_bitmap"], mis_case(*a, **kw))

    assert uses_shared_memory(bitmap_words(100_000), dev)
    mcase(100_000, 4, 4096, 3, 3, seed=7, device=dev,
          taus=[50, INT32_MAX, 700, 1])          # τ cut mid-table, carry
    assert uses_shared_memory(bitmap_words(1_000_000), dev)
    mcase(1_000_000, 3, 4096, 3, 3, seed=9, device=dev,
          taus=[INT32_MAX, 100, 2000])           # > 48 KB of shared memory
    global_words = bitmap_words(2_000_000)
    assert not uses_shared_memory(global_words, dev)
    mcase(2_000_000, 3, 4096, 5, 4, seed=10, device=dev,
          taus=[INT32_MAX, 300, 1])              # global-memory bitmap
    for name in MIS_EDGE_CASES:
        for words in (0, global_words):
            worst["mis_bitmap"] = max(worst["mis_bitmap"],
                                      mis_edge_case(name, dev, words))
    _log("parity: mis_bitmap == plain (exact, tolerance 0) on tau cut, carry, "
         "P>1, shared (<48 KB, >48 KB) and global bitmaps, and on "
         f"{', '.join(MIS_EDGE_CASES)} with shared and global bitmaps")
    return worst


def phase_golden(out: Path):
    got = _run_cli(GOLDEN_FLAGS, out / "smoke_golden.json")
    want = json.loads(GOLDEN.read_text())
    if _strip_wall_clock(got) != _strip_wall_clock(want):
        raise AssertionError(
            "golden mismatch:\n" + json.dumps(_strip_wall_clock(got))[:2000]
            + "\nvs\n" + json.dumps(_strip_wall_clock(want))[:2000])
    _log(f"golden: port CLI on cuda == reference CLI --json "
         f"(n_frequent={got['n_frequent']}, searched={got['searched']})")
    flags = [f for f in GOLDEN_FLAGS]
    flags[flags.index("--execution") + 1] = "auto"
    _zero_counts()
    t0 = time.monotonic()
    auto = _run_cli(flags + ["--calibration", str(_default_calibration(out))],
                    out / "smoke_golden_auto.json")
    wall = time.monotonic() - t0
    if auto["frequent"] != want["frequent"]:
        raise AssertionError(f"golden under auto: frequent set "
                             f"{auto['frequent'][:20]} is not the golden's "
                             f"{want['frequent'][:20]}")
    _log(f"golden: --execution auto gives the golden's frequent set "
         f"(n_frequent={auto['n_frequent']}) in wall_s={wall:.2f}, "
         f"launches={_mining_counts()}; plans: {_plans(auto)}")


def _default_calibration(out: Path, name: str = "auto") -> Path:
    """The built-in cost model written as a file under ``out``, so that a
    run reads the H100 fit whatever the machine's environment holds (and a
    sampled run folds its escalation fraction in there)."""
    from repro_torch.core.planner import CostModel

    path = out / f"planner_calibration_{name}.json"
    path.write_text(json.dumps(CostModel().to_dict()))
    return path


def _mining_counts() -> dict:
    counts = _read_counts()
    return {k: counts[k] for k in ("frontier_expand", "mis_bitmap")}


def _plans(res: dict) -> list:
    """Each level's plan in short: plane, cap, the pricing's choice, replans."""
    out = []
    for lvl, st in res["per_level"].items():
        plan = st.get("plan", {})
        pricing = plan.get("pricing") or {}
        out.append({"level": lvl, "plane": plan.get("plane"),
                    "cap": plan.get("cap"), "max_batch": plan.get("max_batch"),
                    "replans": st.get("replans"),
                    "chosen": pricing.get("chosen"),
                    "batched_s": pricing.get("batched_s"),
                    "sampled_s": pricing.get("sampled_s"),
                    "esc": pricing.get("esc"),
                    "esc_source": pricing.get("esc_source"),
                    "tau_min": pricing.get("tau_min"),
                    "hidden_bound": pricing.get("hidden_bound"),
                    "sampled": st.get("sampled")})
    return out


def _same_frequent(name: str, got: dict, want: dict) -> None:
    """The frequent set with its supports and each level's counts."""
    def counts(res):
        return {lvl: (st["candidates"], st["searched"], st["frequent"])
                for lvl, st in res["per_level"].items()}

    if (got["frequent"], got["n_frequent"], got["searched"], counts(got)) \
            != (want["frequent"], want["n_frequent"], want["searched"],
                counts(want)):
        raise AssertionError(
            f"{name}: frequent set or level counts differ from the batched "
            f"run: {got['n_frequent']} vs {want['n_frequent']} frequent, "
            f"levels {counts(got)} vs {counts(want)}")


def _counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel name."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd
    from repro_torch.kernels.frontier_expand.kernel import frontier_expand
    from repro_torch.kernels.mis_bitmap.kernel import mis_bitmap_select

    from repro_torch.kernels.adamw.kernel import adamw_fused
    from repro_torch.kernels.embedding_bag.kernel import (
        embedding_bag_bwd_tbh, embedding_bag_tbh,
    )
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_bhsd,
    )
    from repro_torch.kernels.gather_aggregate.kernel import (
        gather_aggregate_nf, gather_aggregate_t_nf,
    )

    return {"frontier_expand": frontier_expand,
            "mis_bitmap": mis_bitmap_select,
            "flash_attention": flash_attention_bhsd,
            "embedding_bag": embedding_bag_tbh,
            "gather_aggregate": gather_aggregate_nf,
            "flash_attention_bwd": flash_attention_bwd_bhsd,
            "embedding_bag_bwd": embedding_bag_bwd_tbh,
            "gather_aggregate_t": gather_aggregate_t_nf,
            "adamw": adamw_fused}


def _zero_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def _read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def phase_flash_parity(dev) -> float:
    from repro_torch.testing.parity import FLASH_CASES, FLASH_TOL, flash_case

    worst = 0.0
    for case in FLASH_CASES:
        err = flash_case(case, dev)
        worst = max(worst, err)
        _log(f"parity: flash_attention {case[0]} max_abs_err={err:.3g} "
             f"(tolerance {FLASH_TOL[case[6]]})")
    return worst


def phase_main(out: Path, sigma: int) -> dict:
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.monotonic()
    res = _run_cli(mico_flags(sigma), out / "smoke_mico.json")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = _read_counts()
    launches = {k: counts[k] for k in ("frontier_expand", "mis_bitmap")}
    peak = torch.cuda.max_memory_allocated()
    for lvl, st in res["per_level"].items():
        _log(f"main: level {lvl} wall_s={st['wall_s']:.3f} "
             f"candidates={st['candidates']} searched={st['searched']} "
             f"frequent={st['frequent']} dispatches={st['dispatches']} "
             f"max_count={st['max_count']} overflowed={st['overflowed']}")
    frequent_k3 = sum(1 for k, _ in res["frequent"] if k == 3)
    _log(f"main: mico x1.0 sigma={sigma} wall_s={wall:.2f} "
         f"elapsed_s={res['elapsed_s']:.2f} n_frequent={res['n_frequent']} "
         f"(k=3: {frequent_k3}) searched={res['searched']} "
         f"max_memory_allocated={peak} launches={launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never ran: {launches}")
    overflowed = [lvl for lvl, st in res["per_level"].items()
                  if st["overflowed"]]
    if overflowed:
        raise AssertionError(f"levels {overflowed} overflowed the frontier cap "
                             f"{MICO_CAP}: the answer would not be exact")
    if res["timed_out"] or frequent_k3 == 0:
        raise AssertionError("the full-size run must finish with a frequent "
                             "k = 3 pattern")
    return launches, res


def phase_auto(out: Path, sigma: int, batched: dict) -> dict:
    """The main run under the CLI's default ``--execution auto``."""
    flags = mico_flags(sigma, "auto")
    flags.remove("--execution")
    flags.remove("auto")                    # the CLI's default
    cal = _default_calibration(out)
    _zero_counts()
    t0 = time.monotonic()
    res = _run_cli(flags + ["--calibration", str(cal)], out / "smoke_auto.json")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _mining_counts()
    _log(f"auto: mico x1.0 sigma={sigma} wall_s={wall:.2f} "
         f"elapsed_s={res['elapsed_s']:.2f} (batched run "
         f"{batched['elapsed_s']:.2f}) levels_s="
         f"{[round(st['wall_s'], 3) for st in res['per_level'].values()]} "
         f"dispatches={res['dispatches']} health={res['health']['counts']} "
         f"launches={launches}")
    _log(f"auto: plans {json.dumps(_plans(res))}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the auto path never ran: {launches}")
    _same_frequent("auto", res, batched)
    _log("auto: frequent set, supports and level counts == the batched run")
    return launches, res, wall


def phase_sampled(out: Path, sigma: int, batched: dict) -> dict:
    """The main run on the sampled plane with escalation by replay."""
    import resource
    from unittest import mock

    from repro_torch.core import batched as batched_lib
    from repro_torch.core import sampled as sampled_lib
    from repro_torch.kernels.mis_bitmap.kernel import mis_bitmap_select

    counters: dict = {}
    replay = {"mis_launches": 0, "record_bytes": 0, "records": 0}
    level_sampled = sampled_lib.evaluate_level_sampled
    sample_group = sampled_lib.sample_group
    replay_step_fn = batched_lib._replay_step_fn

    def counted_level(*a, **kw):
        kw["counters"] = counters
        return level_sampled(*a, **kw)

    def measured_group(*a, **kw):
        got = sample_group(*a, **kw)
        for rec in got[5] or []:
            for r in rec.values():
                replay["record_bytes"] += r["emb"].nbytes
                replay["records"] += 1
        return got

    def counted_replay(*a):
        step = replay_step_fn(*a)

        def run(*args):
            before = mis_bitmap_select.launches
            got = step(*args)
            replay["mis_launches"] += mis_bitmap_select.launches - before
            return got

        return run

    cal = _default_calibration(out, "sampled")
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    _zero_counts()
    t0 = time.monotonic()
    with mock.patch.object(sampled_lib, "evaluate_level_sampled",
                           counted_level), \
            mock.patch.object(sampled_lib, "sample_group", measured_group), \
            mock.patch.object(batched_lib, "_replay_step_fn", counted_replay):
        res = _run_cli(mico_flags(sigma, "sampled")
                       + ["--sample-fraction", "0.25", "--calibration",
                          str(cal)], out / "smoke_sampled.json")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _mining_counts()
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    _log(f"sampled: mico x1.0 sigma={sigma} fraction 0.25 wall_s={wall:.2f} "
         f"elapsed_s={res['elapsed_s']:.2f} (batched run "
         f"{batched['elapsed_s']:.2f}) levels_s="
         f"{[round(st['wall_s'], 3) for st in res['per_level'].values()]} "
         f"escalated={res['escalated']} estimated_patterns="
         f"{res['estimated_patterns']} counters={counters} "
         f"replay={replay} launches={launches} peak host RSS "
         f"{rss0 * 1024} -> {rss1 * 1024} bytes")
    _log(f"sampled: levels {json.dumps(_plans(res))}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the sampled path never ran: "
                             f"{launches}")
    if counters.get("replay_blocks", 0) < 1 or replay["mis_launches"] < 1:
        raise AssertionError(f"no escalated block was replayed through "
                             f"mis_bitmap: {counters}, {replay}")
    _same_frequent("sampled", res, batched)
    _log("sampled: frequent set, supports and level counts == the batched run")
    return launches


def _strip_resumed(d: dict) -> dict:
    """A --json without wall-clock fields and without ``health`` (a resumed
    run records the recoveries an uninterrupted one never needed)."""
    d = _strip_wall_clock(d)
    d.pop("health")
    return d


def phase_session_auto(out: Path, sigma: int, auto: dict, auto_wall: float):
    """Phase 5a's command as a session, uninterrupted: equal to 5a."""
    import shutil

    from repro_torch.testing.session_meter import SnapshotMeter

    ckpt_dir = out / "session_auto"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    flags = [f for f in mico_flags(sigma, "auto") if f not in
             ("--execution", "auto")]
    flags += ["--checkpoint-dir", str(ckpt_dir), "--checkpoint-every",
              str(SESSION_EVERY)]
    cal = _default_calibration(out, "session")
    _zero_counts()
    with SnapshotMeter() as meter:
        t0 = time.monotonic()
        res = _run_cli(flags + ["--calibration", str(cal)],
                       out / "smoke_session_auto.json")
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    launches = _mining_counts()
    summary = meter.summary()
    per_level = {lvl: meter.summary(lvl) for lvl in sorted(meter.updates)}
    _log(f"session-auto: mico x1.0 sigma={sigma} --checkpoint-every "
         f"{SESSION_EVERY}: wall_s={wall:.2f} (phase 5a {auto_wall:.2f}, "
         f"{wall / auto_wall:.2f}x) snapshots={summary['snapshots']} "
         f"(state updates {summary['updates']}) bytes a snapshot median="
         f"{summary['bytes_median']} max={summary['bytes_max']} total="
         f"{summary['bytes_total']} mining thread in snapshots "
         f"{summary['mining_s']:.2f} s, writes {summary['write_s']:.2f} s "
         f"launches={launches}")
    for lvl, row in per_level.items():
        _log(f"session-auto: level {lvl}: {json.dumps(row)}")
    if _strip_wall_clock(res) != _strip_wall_clock(auto):
        raise AssertionError("session-auto: --json differs from phase 5a's")
    _log("session-auto: --json == phase 5a's (minus wall-clock fields)")
    return res, launches, meter


def phase_session_kill(out: Path, sigma: int, session: dict,
                       full_launches: dict, meter) -> dict:
    """Kill the session at a mid-level-2 snapshot through the fault plan,
    resume it: equal to session-auto, with fewer launches."""
    import shutil

    from repro_torch.runtime import InjectedCrash, faults
    from repro_torch.train import checkpoint as ckpt

    level2 = [i for i, snap in enumerate(meter.snapshots, 1)
              if snap["level"] == 2 and snap["kind"] == "batched"]
    if not level2:
        raise AssertionError("session-auto wrote no in-flight level-2 "
                             "snapshot to kill at")
    at = level2[len(level2) // 2]
    ckpt_dir = out / "session_kill"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    flags = [f for f in mico_flags(sigma, "auto") if f not in
             ("--execution", "auto")]
    flags += ["--checkpoint-dir", str(ckpt_dir), "--checkpoint-every",
              str(SESSION_EVERY)]
    os.environ[faults.FAULT_PLAN_ENV] = json.dumps(
        [{"point": "session.snapshot", "kind": "crash", "at": at}])
    faults.clear()                  # re-arm the env var's pickup
    t0 = time.monotonic()
    try:
        _run_cli(flags + ["--calibration",
                          str(_default_calibration(out, "kill"))],
                 out / "smoke_session_kill.json")
        raise AssertionError("session-kill: the injected crash never fired")
    except InjectedCrash as e:
        _log(f"session-kill: {e} after {time.monotonic() - t0:.2f} s")
    finally:
        del os.environ[faults.FAULT_PLAN_ENV]
        faults.clear()
        ckpt.wait_pending(raise_errors=False)
    step = ckpt.latest_step(ckpt_dir)
    manifest = json.loads((ckpt_dir / f"step_{step:08d}" /
                           "manifest.json").read_text())
    cursor = manifest["extra"]["cursor"]
    _zero_counts()
    t0 = time.monotonic()
    res = _run_cli(flags + ["--resume", "--calibration",
                            str(_default_calibration(out, "kill"))],
                   out / "smoke_session_kill.json")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _mining_counts()
    _log(f"session-kill: crashed at snapshot {at} of {len(meter.snapshots)} "
         f"(level 2, in flight); resumed from step {step}, cursor {cursor}, "
         f"in wall_s={wall:.2f}; launches after the resume {launches} "
         f"against {full_launches} for the whole run")
    if _strip_resumed(res) != _strip_resumed(session):
        raise AssertionError("session-kill: the resumed --json differs from "
                             "session-auto's")
    if cursor["level"] != 2 or cursor["block"] is None:
        raise AssertionError(f"session-kill: not a mid-level-2 snapshot: "
                             f"{cursor}")
    if not all(0 < launches[k] < full_launches[k] for k in launches):
        raise AssertionError(f"session-kill: the resume did not run fewer "
                             f"launches than a whole run: {launches} vs "
                             f"{full_launches}")
    _log("session-kill: resumed --json == session-auto's (minus wall clock "
         "and health), with fewer launches")
    return launches


def phase_session_sigterm(out: Path) -> None:
    """The golden's flags as a session in a child process: SIGTERM once the
    graph is loaded → exit 75 with a committed snapshot → --resume equals
    the golden."""
    import shutil
    import signal

    from repro_torch.launch.mine import EXIT_PREEMPTED

    ckpt_dir = out / "session_sigterm"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    flags = GOLDEN_FLAGS + ["--checkpoint-dir", str(ckpt_dir),
                            "--checkpoint-every", "1"]
    path = out / "smoke_session_sigterm.json"
    path.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.mine", *flags,
           "--device", "cuda", "--json", str(path)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.monotonic()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=ROOT)
    head = []
    try:
        for line in proc.stdout:
            head.append(line)
            if "|V|=" in line:
                break
        proc.send_signal(signal.SIGTERM)
        output = "".join(head) + proc.communicate(timeout=300)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    committed = sorted(p.parent.name for p in ckpt_dir.glob("step_*/COMMIT"))
    _log(f"session-sigterm: child exited {proc.returncode} after "
         f"{time.monotonic() - t0:.2f} s, committed {committed}")
    if proc.returncode != EXIT_PREEMPTED or "preempted" not in output \
            or not committed or path.exists():
        raise AssertionError(f"session-sigterm: expected exit "
                             f"{EXIT_PREEMPTED} with a committed snapshot "
                             f"and no result:\n{output[-2000:]}")
    got = _run_cli(flags + ["--resume"], path)
    want = json.loads(GOLDEN.read_text())
    if _strip_resumed(got) != _strip_resumed(want):
        raise AssertionError("session-sigterm: the resumed --json is not "
                             "the golden's")
    _log("session-sigterm: exit 75, then --resume == the golden --json")


def phase_mis_exact(dev) -> dict:
    """``mine(metric="mis_exact")`` through the API on the card and on the
    CPU: equal results; the collector's dispatches and launches."""
    from repro_torch.core import MatchConfig, MiningConfig, mine
    from repro_torch.core.batched import MIS_EXACT_BLOCKS_PER_DISPATCH
    from repro_torch.data.synthetic import rmat_graph

    spec = dict(MIS_EXACT_GRAPH)
    g = rmat_graph(spec.pop("n"), spec.pop("m"), undirected=True, **spec)
    cfg = MiningConfig(sigma=MIS_EXACT_SIGMA, lam=1.0, metric="mis_exact",
                       max_pattern_size=3,
                       match=MatchConfig.for_graph(g, cap=1024,
                                                   root_block=32))
    runs, walls = {}, {}
    for device in ("cpu", "cuda"):
        _zero_counts()
        t0 = time.monotonic()
        res = mine(g, cfg, device=device)
        walls[device] = time.monotonic() - t0
        runs[device] = res
    launches = _mining_counts()
    summary = {dev: ([(p.key(), s) for p, s in r.frequent],
                     [(st.pattern.key(), st.support, st.embeddings_found,
                       st.overflowed, st.blocks_run, st.max_count,
                       st.dispatches) for st in r.stats], r.searched)
               for dev, r in runs.items()}
    got = runs["cuda"]
    dispatches = sum(st.dispatches for st in got.stats)
    shapes = sorted({st.pattern.k for st in got.stats})
    _log(f"mis-exact: rmat {g.n} vertices, {g.n_edges} edges, "
         f"{g.n_labels} labels, sigma={MIS_EXACT_SIGMA}: "
         f"{len(got.frequent)} frequent of {got.searched} searched (k in "
         f"{shapes}); collector dispatches {dispatches} (P = "
         f"{MIS_EXACT_BLOCKS_PER_DISPATCH} blocks each), frontier_expand "
         f"launches {launches['frontier_expand']}, "
         f"mis_bitmap {launches['mis_bitmap']}; wall cuda "
         f"{walls['cuda']:.2f} s, cpu {walls['cpu']:.2f} s")
    if summary["cuda"] != summary["cpu"]:
        raise AssertionError("mis-exact: the card's result differs from the "
                             "CPU's")
    if not got.frequent or launches["frontier_expand"] <= 0:
        raise AssertionError(f"mis-exact: nothing frequent or no frontier "
                             f"launch ({launches})")
    _log("mis-exact: card == CPU (frequent set, supports, every pattern's "
         "stats)")
    return {"dispatches": dispatches,
            "frontier_expand": launches["frontier_expand"]}


def phase_serve(out: Path) -> int:
    """qwen3-1.7b served at full width through the serving CLI; returns the
    flash kernel's launches in that run."""
    from repro_torch.configs.lm import model_flops
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve as cli

    cfg = get_arch("qwen3-1.7b").cfg
    path = out / "smoke_serve.json"
    _zero_counts()
    t0 = time.monotonic()
    rc = cli.main(SERVE_FLAGS + ["--device", "cuda", "--json", str(path)])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = _read_counts()
    if rc != 0:
        raise RuntimeError(f"serve CLI exited {rc}")
    res = json.loads(path.read_text())
    B, P = res["batch"], res["prompt_len"]
    flops = model_flops(cfg, "prefill", B, P)
    _log(f"serve: {res['config']} ({res['n_params']} parameters) batch {B} "
         f"prompt {P} gen {res['gen_len']}: wall_s={wall:.2f} "
         f"ttft_s={res['ttft_s']:.4f} "
         f"prefill_tflops={flops / res['ttft_s'] / 1e12:.1f} "
         f"(model_flops {flops:.4g}, "
         f"{flops / res['ttft_s'] / BF16_FLOPS_S:.3f} of the 989 TFLOP/s "
         f"bf16 dense peak) replay_s={res['replay_s']:.2f} over "
         f"{res['replay_len']} tokens "
         f"({res['replay_s'] / res['replay_len'] * 1e3:.2f} ms/step) "
         f"decode_step_ms median={res['decode_step_ms_median']:.3f} "
         f"p90={res['decode_step_ms_p90']:.3f} "
         f"decode_tokens_per_s={res['decode_tokens_per_s']:.1f} "
         f"max_memory_allocated={res['max_memory_allocated']} "
         f"launches={counts}")
    _log(f"serve: prompt gap max_abs={res['prompt_gap']:.4g} against the "
         f"bound {cli.GAP_SCALE}·max|logit| + {cli.GAP_FLOOR} = "
         f"{res['prompt_gap_bound']:.4g}; elementwise "
         f"|gap| / ({cli.GAP_ATOL} + {cli.GAP_RTOL}·|logit|) at most "
         f"{res['prompt_allclose_ratio']:.4g}; first tokens "
         f"{res['tokens'][0][:8]}")
    prefills = 1 + 1   # the untimed warm-up prefill and the timed one
    if res["prefill_flash_launches"] != cfg.n_layers or \
            counts["flash_attention"] != prefills * cfg.n_layers:
        raise AssertionError(
            f"a prefill must launch the flash kernel once per layer "
            f"({cfg.n_layers}): timed prefill {res['prefill_flash_launches']}, "
            f"run {counts['flash_attention']} over {prefills} prefills")
    if not res["logits_finite"]:
        raise AssertionError("non-finite logits in the serve run")
    if not res["prompt_gap_ok"]:
        raise AssertionError(
            f"prompt replay's last logits differ from the prefill's by "
            f"{res['prompt_gap']}, past {res['prompt_gap_bound']}")
    return counts["flash_attention"]


def phase_serve_arch(dev, arch: str, n_layers, replay: int) -> int:
    """One LM arch served at full width through ``serve.serve()`` (its
    depth cut to ``n_layers`` where given); returns the flash kernel's
    launches in that run.  The model is freed before the next phase."""
    import gc

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve as cli
    from repro_torch.models.transformer import transformer_init

    cfg = get_arch(arch).cfg
    tag = f"serve-{arch}"
    if n_layers is not None:
        _log(f"{tag}: cut in depth to {n_layers} of its {cfg.n_layers} "
             f"layers (all {cfg.n_layers} hold {cfg.param_count() * 2} "
             f"bytes of bf16 weights, more than one card)")
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    B, P, gen = SERVE_ARCH_BATCH, SERVE_ARCH_PROMPT, SERVE_ARCH_GEN
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    model = transformer_init(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    weights = torch.cuda.memory_allocated() - base
    init_peak = torch.cuda.max_memory_allocated() - base
    prompts = cli.make_prompts(cfg.vocab, B, P, 0, dev)
    seen = {}
    if cfg.moe_cfg is not None:
        # layer 0's MoE input and output in the (timed, last) prefill
        def keep(mod, args, out):
            if args[0].shape[1] == P:
                seen["x"], seen["y"] = args[0], out[0]
        hook = model.layers[0].moe.register_forward_hook(keep)
    _zero_counts()
    t0 = time.monotonic()
    res = cli.serve(model, prompts, gen, replay_len=replay)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = _read_counts()
    repeat = ""
    if cfg.moe_cfg is not None:
        hook.remove()
        with torch.inference_mode():
            again = model.layers[0].moe(seen["x"])[0]
        if _sha256(again) != _sha256(seen["y"]):
            raise AssertionError(f"{tag}: a second launch of layer 0's MoE "
                                 f"on the prefill's input changed its bytes")
        repeat = (f" layer 0's MoE relaunched on the prefill's input: same "
                  f"bytes (SHA-256 {_sha256(again)[:16]})")
    _log(f"{tag}: {res['config']} ({res['n_params']} parameters, "
         f"{cfg.n_layers} layers, {weights} bytes of weights; init "
         f"{init_s:.2f} s, peak {init_peak} bytes) batch {B} prompt {P} gen "
         f"{gen}: wall_s={wall:.2f} ttft_s={res['ttft_s']:.4f} "
         f"replay_s={res['replay_s']:.2f} over {res['replay_len']} tokens "
         f"decode_step_ms median={res['decode_step_ms_median']:.3f} "
         f"p90={res['decode_step_ms_p90']:.3f} "
         f"decode_tokens_per_s={res['decode_tokens_per_s']:.1f} "
         f"moe_capacity={res['moe_capacity']} "
         f"moe_dropped={res['moe_dropped']} "
         f"max_memory_allocated={res['max_memory_allocated']} "
         f"launches={counts}")
    capped = ("" if res["prompt_gap_capped"] is None else
              f" (logits before the final softcap {cfg.final_softcap}; "
              f"after it the gap is {res['prompt_gap_capped']:.4g})")
    _log(f"{tag}: prompt gap max_abs={res['prompt_gap']:.4g} against the "
         f"bound {res['prompt_gap_bound']:.4g}{capped}; elementwise ratio "
         f"{res['prompt_allclose_ratio']:.4g}; first tokens "
         f"{res['tokens'][0][:8]}" + repeat)
    prefills = 1 + 1   # the untimed warm-up prefill and the timed one
    if res["prefill_flash_launches"] != cfg.n_layers or \
            counts["flash_attention"] != prefills * cfg.n_layers:
        raise AssertionError(
            f"{tag}: a prefill must launch the flash kernel once per layer "
            f"({cfg.n_layers}): timed prefill {res['prefill_flash_launches']}"
            f", run {counts['flash_attention']} over {prefills} prefills")
    if not res["logits_finite"]:
        raise AssertionError(f"{tag}: non-finite logits")
    if not res["prompt_gap_ok"]:
        raise AssertionError(
            f"{tag}: prompt replay's last logits differ from the prefill's "
            f"by {res['prompt_gap']}, past {res['prompt_gap_bound']}")
    del model, prompts, seen, res
    gc.collect()
    torch.cuda.empty_cache()
    return counts["flash_attention"]


def _flash_row(dev, B, S, H, KV, hd, *, window=None, softcap=None,
               label="") -> dict:
    """The flash kernel at one per-layer shape (bf16, causal): kernel vs
    plain version, timed beside its bound and, where SDPA computes the
    same function (no softcap, no window), SDPA's time."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.testing.parity import FLASH_TOL, flash_inputs

    mask = dict(causal=True, window=window, softcap=softcap)
    q, k, v = flash_inputs(B, S, H, KV, hd, torch.bfloat16, dev, seed=1)
    # the kernel's own layout, as ops.flash_attention hands it over
    qf = q.transpose(1, 2).reshape(B * H, S, hd).contiguous()
    kf = k.transpose(1, 2).reshape(B * KV, S, hd).contiguous()
    vf = v.transpose(1, 2).reshape(B * KV, S, hd).contiguous()
    got = flash_attention_bhsd(qf, kf, vf, **mask)
    got = got.reshape(B, H, S, hd).transpose(1, 2).float()
    want = flash_attention_ref(q, k, v, **mask).float()
    err = float((got - want).abs().max())
    tol = FLASH_TOL[torch.bfloat16]
    if not torch.allclose(got, want, atol=tol, rtol=tol):
        raise AssertionError(f"flash_attention {label}: max abs err {err} "
                             f"past atol = rtol = {tol}")
    del got, want
    ms = _time_ms(lambda: flash_attention_bhsd(qf, kf, vf, **mask), reps=20)
    plain_ms = _time_ms(lambda: flash_attention_ref(q, k, v, **mask),
                        reps=5 if S <= 2048 else 2)
    library_ms = None
    if window is None and softcap is None:
        q4, k4, v4 = (t.view(B, -1, S, hd) for t in (qf, kf, vf))
        library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True), reps=20)
    # live work: the (query, key) pairs the causal window keeps (S(S+1)/2
    # without a window) per head, 2·hd FLOPs each for q·k and for p·v (the
    # softcap's tanh, one a pair, is not counted); bytes: q, k, v and o
    # once, bf16
    W = S if window is None else min(window, S)
    pairs = W * (W + 1) // 2 + (S - W) * W
    flops = 4.0 * hd * B * H * pairs
    nbytes = 2 * (2 * B * H * S * hd + 2 * B * KV * S * hd)
    t_ops, t_bytes = flops / BF16_FLOPS_S, nbytes / HBM_BYTES_S
    sdpa = "none" if library_ms is None else f"{library_ms:.4f}"
    _log(f"kernels: flash_attention {label} B={B} S={S} H={H} KV={KV} "
         f"hd={hd} bf16 causal window={window} softcap={softcap}: "
         f"ms={ms:.4f} ({flops / ms / 1e9:.1f} TFLOP/s) "
         f"plain_ms={plain_ms:.3f} sdpa_ms={sdpa} "
         f"bound_ms={max(t_ops, t_bytes) * 1e3:.4f} max_abs_err={err:.3g}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "max_abs_err": err}


def phase_flash_kernel(dev) -> dict:
    """The flash kernel at the serve phase's per-layer shape (the kernels
    line's row), then at the other archs' (`FLASH_ARCH_SHAPES`, printed);
    ``max_abs_err`` is the largest over all of them."""
    from repro_torch.configs.registry import get_arch

    cfg = get_arch("qwen3-1.7b").cfg
    row = _flash_row(dev, 4, 1024, cfg.n_heads, cfg.n_kv_heads,
                     cfg.head_dim, label="qwen3-1.7b")
    for label, B, S, H, KV, window, softcap in FLASH_ARCH_SHAPES:
        other = _flash_row(dev, B, S, H, KV, 128, window=window,
                           softcap=softcap, label=label)
        row["max_abs_err"] = max(row["max_abs_err"], other["max_abs_err"])
    return row


def phase_bag_agg_parity(dev) -> dict:
    """The embedding-bag and gather-aggregate kernels against their plain
    versions on the parity cases; the worst error of each."""
    from repro_torch.testing.parity import (
        AGG_CASES, AGG_TOL, BAG_CASES, BAG_TOL, agg_case, bag_case,
    )

    worst = {"embedding_bag": 0.0, "gather_aggregate": 0.0}
    for case in BAG_CASES:
        worst["embedding_bag"] = max(worst["embedding_bag"], bag_case(case, dev))
    _log(f"parity: embedding_bag == plain on {len(BAG_CASES)} cases (exact "
         f"at H = 1, else atol = rtol = {BAG_TOL}); max_abs_err="
         f"{worst['embedding_bag']:.3g}")
    for case in AGG_CASES:
        err = agg_case(case, dev)
        worst["gather_aggregate"] = max(worst["gather_aggregate"], err)
    _log(f"parity: gather_aggregate == plain on {len(AGG_CASES)} cases "
         f"(atol = rtol = {AGG_TOL}); max_abs_err="
         f"{worst['gather_aggregate']:.3g}")
    return worst


def _wall_ms(fn, reps: int) -> float:
    """Mean ms of a warm call, synchronised host clock (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


RECSYS_REPS = {"serve_p99": 10, "serve_bulk": 3, "retrieval_cand": 5}


def phase_recsys(dev) -> tuple:
    """dlrm-rm2 at full width through its serve and retrieval steps;
    returns (embedding-bag launches in the run, the kernel row's numbers)."""
    from unittest import mock

    import torch.nn.functional as F

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_tbh
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.models import dlrm

    arch = get_arch("dlrm-rm2")
    cfg = arch.cfg
    t0 = time.monotonic()
    model = arch.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    inputs = {shape: arch.inputs(shape, seed=0, device=dev)
              for shape in RECSYS_REPS}
    torch.cuda.synchronize()
    _log(f"recsys: dlrm-rm2 ({cfg.n_sparse} tables of {cfg.table_rows} x "
         f"{cfg.embed_dim} bf16, MLPs {cfg.bot_mlp} / {cfg.top_mlp}) and "
         f"inputs made in {time.monotonic() - t0:.1f} s")

    _zero_counts()
    forwards, outs = 0, {}
    for shape, reps in RECSYS_REPS.items():
        step = arch.step_fn(shape)
        x = inputs[shape]
        args = [x["dense"], x["sparse_idx"]] + (
            [x["candidates"]] if "candidates" in x else [])
        torch.cuda.reset_peak_memory_stats()
        ms = _wall_ms(lambda: step(model, *args), reps)
        forwards += reps + 1
        outs[shape] = step(model, *args)
        forwards += 1
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        B = arch.batch(shape)
        extra = ""
        if "candidates" in x:
            C = x["candidates"].shape[0]
            extra = (f" candidates={C} ({C / ms * 1e3:.4g} scored/s)")
        _log(f"recsys: {shape} batch={B} forward_ms={ms:.3f} "
             f"examples_per_s={B / ms * 1e3:.6g}{extra} "
             f"max_memory_allocated={peak}")
    launches = _read_counts()["embedding_bag"]
    _log(f"recsys: embedding_bag launches={launches} over {forwards} forwards")
    if launches != forwards:
        raise AssertionError(f"every DLRM forward must launch the embedding "
                             f"bag once: {launches} launches, {forwards} "
                             f"forwards")

    for shape in ("serve_p99", "serve_bulk"):
        p = outs[shape]
        if p.shape != (arch.batch(shape),) or not torch.isfinite(p).all() \
                or (p < 0).any() or (p > 1).any():
            raise AssertionError(f"{shape}: probabilities out of shape or "
                                 f"range")
    scores, ids = outs["retrieval_cand"]
    C = inputs["retrieval_cand"]["candidates"].shape[0]
    if ids.shape != (1, 100) or not torch.isfinite(scores).all() or \
            int(ids.min()) < 0 or int(ids.max()) >= C or \
            (scores[:, 1:] > scores[:, :-1]).any():
        raise AssertionError("retrieval_cand: top-100 out of shape or order")

    # the bags of one forward against their plain version (n_hot 1: exact)
    # and the whole forward against the same forward with the plain bag
    ids_bulk = inputs["serve_bulk"]["sparse_idx"]
    got = embedding_bag_tbh(model.tables, ids_bulk)
    want = embedding_bag_ref(model.tables, ids_bulk)
    if not torch.equal(got, want):
        raise AssertionError("serve_bulk bags differ from the plain version")

    def plain(m, idx):
        return embedding_bag_ref(m.tables, idx)

    with mock.patch.object(dlrm, "_lookups", plain):
        for shape in RECSYS_REPS:
            x = inputs[shape]
            args = [x["dense"], x["sparse_idx"]] + (
                [x["candidates"]] if "candidates" in x else [])
            ref = arch.step_fn(shape)(model, *args)
            pairs = zip(ref, outs[shape]) if isinstance(ref, tuple) else \
                [(ref, outs[shape])]
            if not all(torch.equal(a, b) for a, b in pairs):
                raise AssertionError(f"{shape}: the forward differs from the "
                                     f"same forward with the plain bag")
    _log("recsys: serve_bulk bags == plain (exact); serve_p99, serve_bulk "
         "probabilities and retrieval top-100 == the same forwards with the "
         "plain bag (exact)")

    # the kernel at serve_bulk's bags, timed
    T, R, D = model.tables.shape
    B, _, H = ids_bulk.shape
    ms = _time_ms(lambda: embedding_bag_tbh(model.tables, ids_bulk), reps=20)
    plain_ms = _time_ms(lambda: embedding_bag_ref(model.tables, ids_bulk),
                        reps=3)
    if int((ids_bulk < 0).sum()):
        raise AssertionError("serve_bulk ids hold pads: the library call "
                             "below has no zero row for them")
    flat = (ids_bulk.long() + torch.arange(T, device=dev)[None, :, None] * R
            ).reshape(B * T, H)
    weight = model.tables.view(T * R, D)
    lib = F.embedding_bag(flat, weight, mode="sum").view(B, T, D)
    if not torch.equal(lib, got):
        raise AssertionError("F.embedding_bag disagrees with the kernel")
    library_ms = _time_ms(lambda: F.embedding_bag(flat, weight, mode="sum"),
                          reps=20)
    valid = int((ids_bulk >= 0).sum())
    # a row that several bags name need be read only once: the bytes count
    # each table's distinct ids, the adds every id
    distinct = int(torch.unique(flat[ids_bulk.reshape(B * T, H) >= 0]).numel())
    esize = model.tables.element_size()
    nbytes = B * T * H * 4 + distinct * D * esize + B * T * D * esize
    t_bytes, t_ops = nbytes / HBM_BYTES_S, valid * D / F32_FLOPS_S
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "max_abs_err": float((got.float() - want.float()).abs().max())}
    _log(f"kernels: embedding_bag B={B} T={T} H={H} D={D} bf16, {valid} "
         f"ids, {distinct} distinct (table, row) pairs: ms={ms:.4f} "
         f"({nbytes / ms / 1e6:.1f} GB/s) plain_ms={plain_ms:.3f} "
         f"F.embedding_bag_ms={library_ms:.4f} bound_ms={row['bound_ms']:.4f} "
         f"({nbytes} bytes)")
    del model
    torch.cuda.empty_cache()
    return launches, row


SAGE_REPS = 5


def phase_gnn(dev) -> tuple:
    """graphsage-reddit's forward loss on block 0 of the port's sampler,
    under ``torch.inference_mode()``; returns (gather-aggregate launches in
    the run, the kernel row, the sampler and the node data for the
    training phase)."""
    import numpy as np
    from unittest import mock

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.sampler import block_graph_batch
    from repro_torch.kernels.gather_aggregate.kernel import gather_aggregate_nf
    from repro_torch.kernels.gather_aggregate.ops import in_neighbor_table
    from repro_torch.kernels.gather_aggregate.ref import gather_aggregate_ref
    from repro_torch.models.gnn import graphsage

    arch = get_arch("graphsage-reddit")
    shape = "minibatch_lg"
    meta = arch.meta(shape)
    t0 = time.monotonic()
    g = arch.graph(shape, seed=SAGE_SEED)
    build_s = time.monotonic() - t0
    deg = np.diff(g.out_indptr)
    if (g.n, g.n_edges) != (meta["graph_nodes"], meta["graph_edges"]):
        raise AssertionError(f"the graph holds {g.n} vertices and "
                             f"{g.n_edges} directed edges, not Reddit's")
    _log(f"gnn: R-MAT stand-in for reddit: {g.n} vertices, {g.n_edges} "
         f"directed edges, "
         f"max degree {int(deg.max())}, degree >= 15: "
         f"{float((deg >= 15).mean()):.3f} of vertices; built in "
         f"{build_s:.1f} s")
    sampler = arch.sampler(g, shape, seed=SAGE_SEED)
    t0 = time.monotonic()
    blk = sampler.sample(0)
    sample_s = time.monotonic() - t0
    seeds = blk.node_ids[:meta["seeds"]]
    feats, labels = arch.node_data(shape, g.n, seed=SAGE_SEED, device=dev)
    gb = block_graph_batch(blk, feats, labels)
    model = arch.init(shape, torch.Generator(device=dev).manual_seed(0),
                      device=dev)
    loss_fn = arch.loss_fn(shape)
    nbrs = in_neighbor_table(gb.edge_src, gb.edge_dst, gb.edge_mask,
                             gb.x.shape[0])
    _log(f"gnn: block 0 (cap {sampler.node_cap} nodes, {sampler.edge_cap} "
         f"edges): {blk.n_real_nodes} real nodes, {blk.n_real_edges} real "
         f"edges, largest in-degree {nbrs.shape[1]}, seeds with degree >= "
         f"15: {float((deg[seeds] >= 15).mean()):.3f}; sampled in "
         f"{sample_s:.2f} s")

    def forward():
        with torch.inference_mode():
            return loss_fn(model, gb)

    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    ms = _wall_ms(forward, SAGE_REPS)
    loss = forward()
    torch.cuda.synchronize()
    forwards = SAGE_REPS + 2
    launches = _read_counts()["gather_aggregate"]
    peak = torch.cuda.max_memory_allocated()
    _log(f"gnn: graphsage-reddit {shape} forward_ms={ms:.3f} "
         f"loss={float(loss):.6f} max_memory_allocated={peak} "
         f"gather_aggregate launches={launches} over {forwards} forwards")
    if launches != 2 * forwards:
        raise AssertionError(f"every forward must launch the gather-"
                             f"aggregate twice: {launches} launches, "
                             f"{forwards} forwards")
    if not torch.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")

    with torch.inference_mode():
        got = graphsage.sage_apply(model, gb).float()
        with mock.patch.object(graphsage, "gather_aggregate",
                               gather_aggregate_ref):
            want = graphsage.sage_apply(model, gb).float()
    # the same bf16 inputs, f32 sums in the same order and one rounding:
    # the aggregates, and so the logits, must be equal
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"sage logits differ from the plain aggregate's "
                             f"by up to {err} (max |logit| "
                             f"{float(want.abs().max()):.4g})")
    _log(f"gnn: logits == the same forward with the plain aggregate (exact; "
         f"max |logit| {float(want.abs().max()):.4g})")

    # the kernel at layer 0 of the block, timed
    h = gb.x.to(torch.bfloat16)
    N, Fd = h.shape
    k_out = gather_aggregate_nf(h, nbrs, mean=True)
    p_out = gather_aggregate_ref(h, nbrs, mean=True)
    k_err = float((k_out.float() - p_out.float()).abs().max())
    if not torch.equal(k_out, p_out):
        raise AssertionError(f"gather_aggregate at layer 0 differs from its "
                             f"plain version by up to {k_err}")
    ms_k = _time_ms(lambda: gather_aggregate_nf(h, nbrs, mean=True), reps=20)
    plain_ms = _time_ms(lambda: gather_aggregate_ref(h, nbrs, mean=True),
                        reps=3)
    valid_mask = nbrs >= 0
    deg_in = valid_mask.sum(1)
    crow = torch.zeros(N + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(deg_in, 0)
    col = nbrs[valid_mask].long()
    vals = (1.0 / deg_in.clamp(min=1).float()).repeat_interleave(deg_in)
    lib_dtype = torch.bfloat16
    try:
        adj = torch.sparse_csr_tensor(crow, col, vals.to(lib_dtype), (N, N),
                                      check_invariants=False)
        torch.sparse.mm(adj, h)
    except RuntimeError as e:   # a yardstick only: time it in f32 instead
        _log(f"kernels: torch.sparse.mm has no bf16 CSR path here ({e}); "
             f"timing it in f32")
        lib_dtype = torch.float32
        adj = torch.sparse_csr_tensor(crow, col, vals, (N, N),
                                      check_invariants=False)
    h_lib = h.to(lib_dtype)
    library_ms = _time_ms(lambda: torch.sparse.mm(adj, h_lib), reps=20)
    lib_err = float((torch.sparse.mm(adj, h_lib).float()
                     - k_out.float()).abs().max())
    valid = int(valid_mask.sum())
    # a row that several nodes aggregate need be read only once: the bytes
    # count the distinct neighbours, the adds every valid one
    distinct = int(torch.unique(col).numel())
    esize = h.element_size()
    nbytes = N * nbrs.shape[1] * 4 + distinct * Fd * esize + N * Fd * esize
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = (valid + N) * Fd / F32_FLOPS_S
    row = {"ms": ms_k, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "max_abs_err": max(err, k_err)}
    _log(f"kernels: gather_aggregate N={N} F={Fd} Dmax={nbrs.shape[1]} bf16 "
         f"mean, {valid} valid neighbours, {distinct} distinct: ms={ms_k:.4f} "
         f"({nbytes / ms_k / 1e6:.1f} GB/s) plain_ms={plain_ms:.3f} "
         f"sparse_mm_ms={library_ms:.4f} ({str(lib_dtype)[6:]}, max abs diff "
         f"to the kernel {lib_err:.3g}) bound_ms={row['bound_ms']:.4f} "
         f"({nbytes} bytes)")
    del model
    torch.cuda.empty_cache()
    return launches, row, {"sampler": sampler, "feats": feats,
                           "labels": labels}


def phase_kernels(dev, launches: dict, worst: dict, sigma: int) -> list:
    """Kernel vs plain version on real mico blocks, timed, with bounds."""
    from repro_torch.core import MatchConfig
    from repro_torch.core.flexis import initial_candidates, tau_threshold
    from repro_torch.core.generation import generate_new_patterns
    from repro_torch.core.graph import DeviceGraph
    from repro_torch.core.matcher import _init_roots, match_block
    from repro_torch.core.mis import bitmap_words, mis_greedy_update
    from repro_torch.core.plan import make_plan, stack_plans
    from repro_torch.core.planner import CAP_FLOOR, root_block_order
    from repro_torch.data.synthetic import paper_dataset
    from repro_torch.kernels.frontier_expand.ops import frontier_expand_level
    from repro_torch.kernels.frontier_expand.ref import frontier_expand_ref
    from repro_torch.kernels.mis_bitmap.kernel import mis_bitmap_select
    from repro_torch.testing.parity import (
        frontier_case, frontier_work, max_abs_diff, mis_rows_scanned,
    )

    g = paper_dataset("mico", scale=1.0)
    cfg = MatchConfig.for_graph(g, cap=MICO_CAP)
    dev_g = DeviceGraph.from_host(g, dev)
    first = int(root_block_order(g, cfg.root_block)[0]) * cfg.root_block
    k2 = initial_candidates(g)
    k3 = generate_new_patterns(k2[:12])
    P = 64
    bucket3 = k3[:P]
    # real blocks: the schedule's first (highest-degree) block, a full
    # k = 2 bucket and a full k = 3 bucket, kernel vs plain at every level
    floor = dataclasses.replace(cfg, cap=CAP_FLOOR)   # overflows at the hub
    for pats, geo in ((k2[:P], cfg), (bucket3, cfg), (bucket3, floor)):
        worst["frontier_expand"] = max(worst["frontier_expand"],
                                       frontier_case(g, pats, geo, dev, first))
    _log(f"kernels: frontier_expand == plain on mico blocks (P={P}, k=2, 3, "
         f"cap={cfg.cap} and {CAP_FLOOR}, chunk={cfg.chunk}, "
         f"max_chunks={cfg.max_chunks})")

    # timing at the main path's shapes: level 2 of the k = 3 bucket
    plans = stack_plans([make_plan(p, g) for p in bucket3], dev)
    emb0, cnt0 = _init_roots(dev_g, plans, first, cfg)
    emb1, cnt1, *_ = frontier_expand_ref(dev_g, plans, emb0, cnt0, 1, cfg)
    lanes, bisect_steps, rand_loads = frontier_work(dev_g, plans, emb1, cnt1,
                                                    2, cfg)
    fe_ms = _time_ms(lambda: frontier_expand_level(dev_g, plans, emb1, cnt1,
                                                   2, cfg), reps=10)
    fe_plain_ms = _time_ms(lambda: frontier_expand_ref(dev_g, plans, emb1,
                                                       cnt1, 2, cfg), reps=2)
    passes = _device_ms_by_kernel(
        lambda: frontier_expand_level(dev_g, plans, emb1, cnt1, 2, cfg))
    n, P_, cap, k = g.n, emb1.shape[0], cfg.cap, 3
    fe_scratch = _peak_extra_bytes(
        lambda: frontier_expand_level(dev_g, plans, emb1, cnt1, 2, cfg),
        P_ * cap * k * 4)
    graph_bytes = (n + 2 * (n + 1) + 2 * g.n_edges) * 4
    fe_bytes = graph_bytes + 2 * P_ * cap * k * 4 + P_ * (4 + 4 * (5 + 2 * k)) \
        + P_ * (4 + 4 + 1)
    # ~8 int32 instructions per live lane (gather, filters, injectivity) and
    # per step of a bounded bisection (add, shift, clamp, load, compare,
    # two selects)
    fe_ops = 8 * lanes + 8 * bisect_steps
    fe_bound = max(fe_bytes / HBM_BYTES_S, fe_ops / INT32_OPS_S) * 1e3
    fe_by = "bytes" if fe_bytes / HBM_BYTES_S >= fe_ops / INT32_OPS_S \
        else "operations"

    # greedy mIS at the main path's shapes: the k = 3 bucket's block table
    emb, n_valid, *_ = match_block(dev_g, plans, first, cfg)
    Nw = bitmap_words(n)
    bm = torch.zeros((P_, Nw), dtype=torch.int32, device=dev)
    cnt = torch.zeros(P_, dtype=torch.int32, device=dev)
    tau = torch.full((P_,), tau_threshold(sigma, MICO_LAM, 3), dtype=torch.int32,
                     device=dev)
    got = mis_bitmap_select(bm, cnt, emb, n_valid, tau, k=3)
    ref = mis_greedy_update(bm, cnt, emb, n_valid, tau, 3)
    d = max(max_abs_diff(got[0], ref[0]), max_abs_diff(got[1], ref[1]))
    if d:
        raise AssertionError(f"mis_bitmap differs on mico blocks by {d}")
    worst["mis_bitmap"] = max(worst["mis_bitmap"], d)
    mis_ms = _time_ms(lambda: mis_bitmap_select(bm, cnt, emb, n_valid, tau,
                                                k=3), reps=10)
    mis_plain_ms = _time_ms(lambda: mis_greedy_update(bm, cnt, emb, n_valid,
                                                      tau, 3), reps=1)
    # the kernel's own device time a launch (the events above also hold
    # the wrapper's host time when it is longer than the kernel's)
    mis_device_ms = _device_ms_by_kernel(lambda: [
        mis_bitmap_select(bm, cnt, emb, n_valid, tau, k=3)
        for _ in range(10)]).get("mis_greedy_kernel")
    # informational: a trace that lost the kernel's events is "not measured"
    mis_device_ms = ("not measured" if mis_device_ms is None
                     else f"{mis_device_ms / 10:.4f}")
    rows = mis_rows_scanned(emb, n_valid, tau, 3)
    # per pattern: rows the prefilter tested and passed, rows the decider
    # examined, the CTA's ns (one more launch, untimed)
    stats = torch.zeros((P_, 4), dtype=torch.int64, device=dev)
    mis_bitmap_select(bm, cnt, emb, n_valid, tau, k=3, stats=stats)
    per = [[nv, *st, c] for nv, st, c in zip(
        n_valid.tolist(), stats.tolist(), got[1].tolist())]
    slow = max(per, key=lambda r: r[4])
    tot = stats.sum(0).tolist()
    _log(f"kernels: mis_bitmap hub block: ms={mis_ms:.4f} (CUDA events, "
         f"through the wrapper), kernel device ms={mis_device_ms} "
         f"(torch.profiler); rows tested {tot[0]}, passed by the "
         f"prefilter {tot[1]}, decided {tot[2]} (greedy reads {rows}); "
         f"slowest pattern: n_valid {slow[0]}, tested {slow[1]}, passed "
         f"{slow[2]}, decided {slow[3]}, {slow[4]} ns "
         f"({slow[4] / max(slow[3], 1):.1f} ns a decided row), count {slow[5]}")
    _log("kernels: mis_bitmap hub block per pattern [n_valid, tested, passed, "
         "decided, ns, count]: " + json.dumps(per))
    mis_bytes = 2 * P_ * Nw * 4 + rows * 3 * 4 + 5 * P_ * 4
    mis_ops = 4 * 3 * rows
    mis_bound = max(mis_bytes / HBM_BYTES_S, mis_ops / INT32_OPS_S) * 1e3
    mis_by = "bytes" if mis_bytes / HBM_BYTES_S >= mis_ops / INT32_OPS_S \
        else "operations"
    _log(f"kernels: shapes P={P_} cap={cap} k=3 n={n} live_lanes={lanes} "
         f"bisect_steps={bisect_steps} random_loads={rand_loads} "
         f"mis_rows={rows}")
    _log(f"kernels: frontier_expand hub block level 2 passes, device ms: "
         + ", ".join(f"{k} {v:.4f}" for k, v in passes.items()))
    _log(f"kernels: frontier_expand hub block level 2: valid rows "
         f"{int(cnt1.sum())}, scratch {fe_scratch} bytes (allocator peak "
         f"beyond the output table); ms={fe_ms:.4f} plain_ms={fe_plain_ms:.2f} "
         f"bound_ms={fe_bound:.4f} ({fe_by}: {fe_bytes} bytes, {fe_ops} "
         f"int32 operations)")
    return [
        {"name": "frontier_expand", "route": "cuda",
         "source": "src/repro_torch/csrc/frontier_expand.cu",
         "replaces": "src/repro/kernels/frontier_expand/kernel.py:73",
         "launches": launches["frontier_expand"],
         "max_abs_err": worst["frontier_expand"], "ms": fe_ms,
         "plain_ms": fe_plain_ms, "bound_ms": fe_bound, "bound_by": fe_by,
         "library_ms": None},
        {"name": "mis_bitmap", "route": "cuda",
         "source": "src/repro_torch/csrc/mis_bitmap.cu",
         "replaces": "src/repro/kernels/mis_bitmap/kernel.py:23",
         "launches": launches["mis_bitmap"],
         "max_abs_err": worst["mis_bitmap"], "ms": mis_ms,
         "plain_ms": mis_plain_ms, "bound_ms": mis_bound, "bound_by": mis_by,
         "library_ms": None},
    ]


# ---------------------------------------------------------------------------
# training (phase 11; train-gnn runs after phase 8)
# ---------------------------------------------------------------------------

# the trainer at full width: qwen3-1.7b's 28 layers, cut from train_4k's
# 256 × 4 096 to batch 4 × 1 024 so that masters, moments, grads and
# activations fit one card without sharding (PERF.md)
TRAIN_FLAGS = ["--arch", "qwen3-1.7b", "--steps", "8", "--batch", "4",
               "--seq", "1024", "--log-every", "1", "--ckpt-every", "100"]
# the kernels a training run launches (the rank records of train-rank)
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "adamw")
# train-lm-sharded (b): two ranks at --model-parallel 2 on the one card
# (gloo), full width at 4 of 28 layers, 4 steps, against one rank at the
# same depth; every step's loss within 1e-4 relative (the same weights and
# batch: the sharded step differs only in the order of f32 sums).  Sound
# runs read at most 1.1e-5; with the replicated leaves' gradient sum left
# out, step 3 reads 1.4e-4 (PERF.md, PR 23)
SHARDED_LAYERS = 4
SHARDED_FLAGS = ["--arch", "qwen3-1.7b", "--steps", "4", "--batch", "4",
                 "--seq", "1024", "--log-every", "1", "--ckpt-every", "100"]
SHARDED_TOL = 1e-4
# the kill-and-resume: the same width at 2 layers (checkpoints ~5 GB), cut
# by a stalled step 2 under --step-budget-s, then resumed
RESUME_LAYERS, RESUME_STEPS, RESUME_STALL_AT, RESUME_BUDGET_S = 2, 4, 3, 10
DLRM_TRAIN_STEPS = 4
SAGE_TRAIN_STEPS = 4


def phase_backward_parity(dev) -> dict:
    """The three backward kernels against autograd of their plain forwards
    on f32 copies, each launched twice (identical bytes), and the fused
    AdamW against its plain version (bit for bit); the worst error of
    each."""
    from repro_torch.testing.parity import (
        ADAMW_CASES, AGG_T_CASES, AGG_T_TOL, BAG_BWD_CASES, BAG_BWD_TOL,
        FLASH_BWD_CASES, FLASH_BWD_TOL, adamw_case, agg_t_case, bag_bwd_case,
        flash_bwd_case,
    )

    worst = {}
    for name, cases, fn, tol in (
            ("flash_attention_bwd", FLASH_BWD_CASES, flash_bwd_case,
             FLASH_BWD_TOL),
            ("embedding_bag_bwd", BAG_BWD_CASES, bag_bwd_case, BAG_BWD_TOL),
            ("gather_aggregate_t", AGG_T_CASES, agg_t_case, AGG_T_TOL)):
        errs = {case[0]: fn(case, dev) for case in cases}
        worst[name] = max(errs.values())
        _log(f"parity: {name} == autograd of its plain version on "
             f"{len(cases)} cases (tolerance {tol}), a second launch "
             f"byte-identical; max_abs_err by case: "
             + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    worst["adamw"] = max(adamw_case(case, dev) for case in ADAMW_CASES)
    _log(f"parity: adamw == its plain version bit for bit on "
         f"{len(ADAMW_CASES)} cases ({', '.join(c[0] for c in ADAMW_CASES)})")
    return worst


def _train_cli(flags, log: Path) -> tuple:
    """The trainer CLI in this process on cuda; (rc, its stdout)."""
    import contextlib
    import io

    from repro_torch.launch import train as cli

    buf = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, s):
            buf.write(s)
            sys.__stdout__.write(s)
            return len(s)

    with contextlib.redirect_stdout(Tee()):
        rc = cli.main(flags + ["--device", "cuda"])
    sys.stdout.flush()
    log.write_text(buf.getvalue())
    return rc, buf.getvalue()


def _losses(text: str) -> list:
    import re

    return [float(v) for v in
            re.findall(r"\[train\] step=\d+ loss=([0-9.]+)", text)]


def _steady(text: str) -> dict:
    """The trainer's closing measurements: median step seconds, tokens/s
    and the lead rank's peak bytes."""
    import re

    m = re.search(r"step_s median=([0-9.]+) .*tokens_per_s=([0-9.]+) "
                  r"max_memory_allocated=(\d+)", text)
    if m is None:
        raise AssertionError("the trainer printed no [train] steady line")
    return {"step_s": float(m.group(1)), "tokens_per_s": float(m.group(2)),
            "peak": int(m.group(3))}


def _flash_bwd_row(dev) -> dict:
    """The flash backward at the trainer's per-layer shape: held against
    autograd of the plain version on f32 copies (`FLASH_BWD_TOL`) and
    launched twice (identical bytes); time beside its bound, the plain
    version's and SDPA's backward under a pinned backend."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bhsd, flash_attention_bwd_bhsd,
    )
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.testing.parity import (
        FLASH_BWD_TOL, flash_inputs, grads_close,
    )

    cfg = get_arch("qwen3-1.7b").cfg
    B, S = 4, 1024
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = flash_inputs(B, S, H, KV, hd, torch.bfloat16, dev, seed=2)
    qf, kf, vf = (t.transpose(1, 2).reshape(-1, S, hd).contiguous()
                  for t in (q, k, v))
    o, lse = flash_attention_bhsd(qf, kf, vf, causal=True, return_lse=True)
    do = torch.randn(o.shape, generator=torch.Generator(device=dev)
                     .manual_seed(3), device=dev).to(o.dtype)
    got = flash_attention_bwd_bhsd(qf, kf, vf, o, do, lse, causal=True)
    if not all(map(torch.equal, got, flash_attention_bwd_bhsd(
            qf, kf, vf, o, do, lse, causal=True))):
        raise AssertionError("flash_attention_bwd: a second launch at the "
                             "trainer's shape gave other bytes")
    ms = _time_ms(lambda: flash_attention_bwd_bhsd(qf, kf, vf, o, do, lse,
                                                   causal=True), reps=10)
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    out = flash_attention_ref(*leaves, causal=True)
    dref = do.float().reshape(B, H, S, hd).transpose(1, 2)
    want = torch.autograd.grad(out, leaves, dref, retain_graph=True)
    err = max(grads_close(f"flash_attention_bwd (trainer's shape) d{n}",
                          g.view(B, -1, S, hd).transpose(1, 2), w,
                          scaled=FLASH_BWD_TOL[torch.bfloat16])
              for n, g, w in zip("qkv", got, want))
    del got, want
    plain_ms = _time_ms(lambda: torch.autograd.grad(out, leaves, dref,
                                                    retain_graph=True), reps=3)
    del out
    library_ms, backend = _sdpa_bwd_ms(qf, kf, vf, do, B)
    # five products of 2·hd FLOPs per causal-live pair (2.5× the
    # forward's two); bytes: q, k, v, o, dO and dq, dk, dv once (bf16), lse
    flops = 2.5 * 4.0 * hd * B * H * S * (S + 1) / 2
    nbytes = 2 * (4 * B * H * S * hd + 4 * B * KV * S * hd) + 4 * B * H * S
    t_ops, t_bytes = flops / BF16_FLOPS_S, nbytes / HBM_BYTES_S
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "max_abs_err": err}
    _log(f"kernels: flash_attention_bwd B={B} S={S} H={H} KV={KV} hd={hd} "
         f"bf16 causal: == autograd of the plain version on f32 copies "
         f"(within {FLASH_BWD_TOL[torch.bfloat16]}·max|grad|, max_abs_err="
         f"{err:.3g}), a second launch byte-identical; ms={ms:.4f} "
         f"({flops / ms / 1e9:.1f} TFLOP/s) plain_ms={plain_ms:.3f} "
         f"sdpa_bwd_ms={library_ms:.4f} ({backend}) "
         f"bound_ms={row['bound_ms']:.4f}")
    return row


def _sdpa_bwd_ms(qf, kf, vf, do, B) -> tuple:
    """ms of SDPA's backward alone (CUDA events) at the kernel's inputs,
    under one pinned backend (flash, else memory-efficient): K and V are
    expanded to the query heads outside the timed region, so the backend
    needs no GQA; returns (ms, the backend's name)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    BH, S, hd = qf.shape
    G = BH // kf.shape[0]
    q4 = qf.view(B, -1, S, hd).detach().requires_grad_()
    k4, v4 = (t.repeat_interleave(G, dim=0).view(B, -1, S, hd).detach()
              .requires_grad_() for t in (kf, vf))
    g4 = do.view(B, -1, S, hd)
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        try:
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(q4, k4, v4,
                                                     is_causal=True)
            break
        except RuntimeError as e:
            _log(f"kernels: SDPA refuses {backend.name} here ({e})")
    else:
        raise RuntimeError("SDPA ran under neither pinned backend")
    ms = _time_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), g4,
                                              retain_graph=True), reps=10)
    return ms, backend.name


def phase_train_lm(out: Path, dev) -> tuple:
    """qwen3-1.7b trained at full width through the trainer CLI: 8 steps at
    batch 4 × 1 024, a falling loss, one final checkpoint (then deleted);
    returns (launches by kernel, the flash backward's and AdamW's kernel
    rows, and what train-lm-sharded compares with: the losses, launches,
    steady line and the final checkpoint's manifest)."""
    import shutil

    from repro_torch.configs.registry import get_arch
    from repro_torch.models.transformer import Transformer

    cfg = get_arch("qwen3-1.7b").cfg
    ckpt_dir = out / "train_lm"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.monotonic()
    rc, text = _train_cli(TRAIN_FLAGS + ["--ckpt-dir", str(ckpt_dir)],
                          out / "train_lm.log")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = _read_counts()
    if rc != 0:
        raise RuntimeError(f"trainer exited {rc}")
    losses = _losses(text)
    steps = int(TRAIN_FLAGS[TRAIN_FLAGS.index("--steps") + 1])
    launches = {k: counts[k] for k in ("flash_attention",
                                       "flash_attention_bwd", "adamw")}
    n_leaves = len(list(Transformer(cfg, device="meta")
                        .parameters()))
    ck_bytes = sum(f.stat().st_size for f in (ckpt_dir / f"step_{steps - 1:08d}")
                   .iterdir())
    _log(f"train-lm: qwen3-1.7b {cfg.n_layers} layers d_model {cfg.d_model} "
         f"vocab {cfg.vocab}, {steps} steps at batch 4 x seq 1024: "
         f"wall_s={wall:.1f} losses={losses} launches={launches} final "
         f"checkpoint {ck_bytes} bytes")
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train-lm: {len(losses)} finite losses logged "
                             f"of {steps}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train-lm: the loss did not fall: {losses}")
    if launches != {"flash_attention": steps * cfg.n_layers,
                    "flash_attention_bwd": steps * cfg.n_layers,
                    "adamw": steps * n_leaves}:
        raise AssertionError(f"train-lm: every step must launch the flash "
                             f"forward and backward once per layer and "
                             f"AdamW once per parameter ({n_leaves}): "
                             f"{launches}")
    ref = {"losses": losses, "launches": launches, "steady": _steady(text),
           "manifest": json.loads((ckpt_dir / f"step_{steps - 1:08d}"
                                   / "manifest.json").read_text())}
    shutil.rmtree(ckpt_dir)
    torch.cuda.empty_cache()
    return launches, _flash_bwd_row(dev), _adamw_row(dev, cfg), ref


def _adamw_row(dev, cfg) -> dict:
    """The fused AdamW at the LM's largest leaf (the embedding, vocab ×
    d_model f32): equal to its plain version bit for bit there; its time
    beside its bound, the plain version's and the library's multi-tensor
    update (``torch._fused_adamw_``, which rounds in another order: its
    largest difference is printed); then both over every leaf of the model
    (a launch a leaf against one call)."""
    from repro_torch.kernels.adamw.kernel import adamw_fused
    from repro_torch.kernels.adamw.ref import adamw_ref
    from repro_torch.models.transformer import Transformer
    from repro_torch.train.optimizer import AdamWConfig

    gen = torch.Generator(device=dev).manual_seed(6)
    opt = AdamWConfig()
    step = 2   # the scalars' bias corrections are 1 − b1², 1 − b2²
    scalars = torch.tensor([0.5, 3e-4, 1 - opt.b1 ** step,
                            1 - opt.b2 ** step], device=dev)
    inv_scale = (1 / scalars[0]).reshape(())
    lr = scalars[1].clone().reshape(())

    def library(ps, gs, ms_, vs, steps):
        torch._fused_adamw_(
            ps, gs, ms_, vs, [], steps, lr=lr, beta1=opt.b1, beta2=opt.b2,
            weight_decay=opt.weight_decay, eps=opt.eps, amsgrad=False,
            maximize=False, grad_scale=inv_scale, found_inf=None)

    shapes = [t.shape for t in Transformer(cfg, device="meta").parameters()]
    steps = [torch.full((), float(step), device=dev) for _ in shapes]

    n = cfg.vocab * cfg.d_model
    p, g, m = (torch.randn(n, generator=gen, device=dev) for _ in range(3))
    v = torch.rand(n, generator=gen, device=dev)
    want = [t.clone() for t in (p, m, v)]
    adamw_ref(want[0], g, want[1], want[2], scalars, opt)
    got = [t.clone() for t in (p, m, v)]
    adamw_fused(got[0], g, got[1], got[2], scalars, opt)
    if not all(map(torch.equal, got, want)):
        raise AssertionError("adamw: the kernel differs from its plain "
                             "version at the embedding leaf")
    lib = [t.clone() for t in (p, m, v)]
    library([lib[0]], [g], [lib[1]], [lib[2]], steps[:1])
    lib_err = max(float((a - b).abs().max()) for a, b in zip(lib, want))
    del got, want, lib
    ms = _time_ms(lambda: adamw_fused(p, g, m, v, scalars, opt), reps=10)
    plain_ms = _time_ms(lambda: adamw_ref(p, g, m, v, scalars, opt), reps=3)
    library_ms = _time_ms(lambda: library([p], [g], [m], [v], steps[:1]),
                          reps=10)
    nbytes = 7 * 4 * n          # p, g, m, v read; p, m, v written
    t_bytes, t_ops = nbytes / HBM_BYTES_S, 20 * n / F32_FLOPS_S
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "max_abs_err": 0.0}
    del p, g, m, v
    torch.cuda.empty_cache()
    P, G, M = ([torch.randn(s, generator=gen, device=dev) for s in shapes]
               for _ in range(3))
    V = [torch.rand(s, generator=gen, device=dev) for s in shapes]
    n_all = sum(t.numel() for t in P)
    all_ms = _time_ms(lambda: [adamw_fused(*t, scalars, opt)
                               for t in zip(P, G, M, V)], reps=3)
    all_lib_ms = _time_ms(lambda: library(P, G, M, V, steps), reps=3)
    _log(f"kernels: adamw n={n} f32 (the embedding leaf): == its plain "
         f"version bit for bit; ms={ms:.4f} ({nbytes / ms / 1e6:.1f} GB/s) "
         f"plain_ms={plain_ms:.3f} torch._fused_adamw__ms={library_ms:.4f} "
         f"(max abs diff to the plain version {lib_err:.3g}) "
         f"bound_ms={row['bound_ms']:.4f}; all {len(shapes)} leaves "
         f"({n_all} elements): ms={all_ms:.4f} ({len(shapes)} launches) "
         f"torch._fused_adamw__ms={all_lib_ms:.4f} (one call) bound_ms="
         f"{7 * 4 * n_all / HBM_BYTES_S * 1e3:.4f}")
    del P, G, M, V
    torch.cuda.empty_cache()
    return row


def _checkpoint_leaves_equal(a: Path, b: Path) -> int:
    """Both committed steps hold the same leaves, byte for byte (read one
    pair at a time); returns the bytes compared."""
    import numpy as np

    ma = json.loads((a / "manifest.json").read_text())
    mb = json.loads((b / "manifest.json").read_text())
    if ma["treedef"] != mb["treedef"] or ma["extra"] != mb["extra"]:
        raise AssertionError(f"checkpoints differ in tree or extra: "
                             f"{ma['extra']} vs {mb['extra']}")
    total = 0
    for i in range(ma["n_leaves"]):
        x = np.load(a / f"arr_{i:05d}.npy")
        y = np.load(b / f"arr_{i:05d}.npy")
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"leaf {i} differs between the resumed and "
                                 f"the uninterrupted run")
        total += x.nbytes
    return total


def phase_train_resume(out: Path) -> None:
    """The trainer at full width but 2 layers, under deterministic
    algorithms: an uninterrupted run, and a run whose step 2 stalls past
    --step-budget-s (exit 75) then resumes; the final checkpoints must be
    equal byte for byte."""
    import shutil
    import warnings
    from unittest import mock

    from repro_torch.configs import qwen3_1_7b
    from repro_torch.launch import train as cli
    from repro_torch.runtime import faults

    arch = dataclasses.replace(
        qwen3_1_7b.ARCH, cfg=dataclasses.replace(qwen3_1_7b.CONFIG,
                                                 n_layers=RESUME_LAYERS))
    flags = ["--arch", "qwen3-1.7b", "--steps", str(RESUME_STEPS), "--batch",
             "4", "--seq", "1024", "--log-every", "1", "--ckpt-every", "100"]
    dirs = {k: out / f"train_resume_{k}" for k in ("a", "b")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    t0 = time.monotonic()
    try:
        with warnings.catch_warnings(record=True) as caught, \
                mock.patch.object(cli, "get_arch", lambda name: arch):
            warnings.simplefilter("always")
            rc_a, _ = _train_cli(flags + ["--ckpt-dir", str(dirs["a"])],
                                 out / "train_resume_a.log")
            torch.cuda.empty_cache()
            faults.install(faults.FaultPlan([faults.FaultSpec(
                "train.step", "stall", at=RESUME_STALL_AT,
                stall_s=4 * RESUME_BUDGET_S)]))
            try:
                rc_cut, cut = _train_cli(
                    flags + ["--ckpt-dir", str(dirs["b"]), "--step-budget-s",
                             str(RESUME_BUDGET_S)], out / "train_resume_b1.log")
            finally:
                faults.clear()
            torch.cuda.empty_cache()
            rc_b, resumed = _train_cli(flags + ["--ckpt-dir", str(dirs["b"])],
                                       out / "train_resume_b2.log")
    finally:
        torch.use_deterministic_algorithms(False)
    wall = time.monotonic() - t0
    nondet = sorted({str(w.message).split(".")[0][:160] for w in caught
                     if "deterministic" in str(w.message)})
    _log(f"train-resume: ops without a deterministic implementation "
         f"(warn_only): {nondet or 'none'}")
    if (rc_a, rc_cut, rc_b) != (0, cli.EXIT_STRAGGLER, 0):
        raise AssertionError(f"train-resume: exit codes {rc_a}, {rc_cut}, "
                             f"{rc_b}; want 0, 75, 0")
    stalled = RESUME_STALL_AT - 1
    if f"step {stalled} straggled" not in cut or \
            f"resumed from step {stalled - 1}" not in resumed:
        raise AssertionError("train-resume: the cut or the resume is not "
                             "where the stall was")
    last = f"step_{RESUME_STEPS - 1:08d}"
    nbytes = _checkpoint_leaves_equal(dirs["a"] / last, dirs["b"] / last)
    _log(f"train-resume: qwen3-1.7b width, {RESUME_LAYERS} layers, "
         f"{RESUME_STEPS} steps; step {stalled} stalled past "
         f"--step-budget-s {RESUME_BUDGET_S} → exit 75, checkpoint of step "
         f"{stalled - 1}; resumed: final parameters and moments == the "
         f"uninterrupted run's, byte for byte ({nbytes} bytes); "
         f"wall_s={wall:.1f}")
    for d in dirs.values():
        shutil.rmtree(d)
    torch.cuda.empty_cache()


def phase_train_resume_child() -> None:
    """train-resume in a child process: deterministic cuBLAS needs a fixed
    workspace (``CUBLAS_WORKSPACE_CONFIG``) set before cuBLAS starts, and
    this process's phases keep the default one."""
    sys.stdout.flush()
    torch.cuda.empty_cache()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    rc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                         "--phase", "train-resume"], env=env,
                        timeout=600).returncode
    if rc != 0:
        raise RuntimeError(f"train-resume exited {rc}")


# the distributed phase (12): main-distributed runs mico x1.0 under
# mis_luby on one NCCL rank beside the batched mis_luby run;
# golden-distributed runs the golden's flags under mis_luby at world size 2
# (gloo with CUDA tensors: NCCL refuses two ranks on one card) and 1.  Its
# root blocks are cut to 64 vertices (10 blocks, against one at the
# default width) so that both ranks match roots, and one super-block width
# (2 blocks) fixes the schedule at both world sizes.
DIST_GOLDEN_FLAGS = [f if f not in ("batched", "mis") else
                     {"batched": "distributed", "mis": "mis_luby"}[f]
                     for f in GOLDEN_FLAGS] + ["--root-block", "64",
                                               "--blocks-per-super", "2"]
DIST_KILL_AT = 3          # golden-distributed's session crashes here


def _torchrun(tag: str, nproc: int, flags: list, *, env_extra=None,
              timeout: int = 600, rank_phase: str = "dist-rank") -> tuple:
    """A CLI under ``torchrun --standalone`` in ``nproc`` ranks, each
    through ``rank_phase`` (`phase_dist_rank`: the mining CLI;
    `phase_train_rank`: the trainer); returns (exit code, rank 0's record,
    the ranks' and torchrun's output)."""
    rec = _rank_record(rank_phase, tag, 0)
    for r in range(nproc):
        _rank_record(rank_phase, tag, r).unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", str(Path(__file__).resolve()),
           "--phase", rank_phase, "--", *flags]
    env = dict(os.environ, SMOKE_DIST_TAG=tag, **(env_extra or {}))
    sys.stdout.flush()
    # a session of its own, so that a timeout stops torchrun's ranks too
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out = proc.communicate(timeout=timeout)[0]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    return (proc.returncode,
            json.loads(rec.read_text()) if rec.exists() else None, out)


def _rank_record(rank_phase: str, tag: str, rank: int) -> Path:
    prefix = {"dist-rank": "dist", "train-rank": "train"}[rank_phase]
    return OUT / f"{prefix}_{tag}_rank{rank}.json"


def phase_dist_rank(flags: list) -> int:
    """One torchrun rank: the mining CLI with its launch counts, the
    distributed plane's counters and its collectives' device time (CUDA
    events) written to ``build/smoke/dist_<tag>_rank<r>.json``."""
    from repro_torch.core import distributed as D
    from repro_torch.launch import mine as cli

    _zero_counts()
    D.reset_counters()
    D.time_collectives(True)
    t0 = time.monotonic()
    rc = cli.main(flags)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    rank = int(os.environ.get("RANK", "0"))
    (OUT / f"dist_{os.environ['SMOKE_DIST_TAG']}_rank{rank}.json").write_text(
        json.dumps({"rank": rank, "rc": rc, "wall_s": wall,
                    "launches": _mining_counts(),
                    "counters": dict(D.COUNTERS),
                    "collective_ms": D.collective_device_ms()}))
    return rc


def phase_train_rank(flags: list) -> int:
    """One torchrun rank of the trainer CLI: its launch counts (zeroed
    before the CLI, read after it), wall and peak device memory, written
    to ``build/smoke/train_<tag>_rank<r>.json``.  ``SMOKE_TRAIN_LAYERS``
    cuts the arch's depth (its width unchanged); ``SMOKE_TRAIN_NO_SAVE=1``
    leaves the final checkpoint's directory empty (no leaf is gathered or
    written) for a run whose checkpoint nothing reads."""
    import contextlib
    from unittest import mock

    from repro_torch.launch import train as cli

    layers = os.environ.get("SMOKE_TRAIN_LAYERS")
    get_arch = cli.get_arch

    def cut(name):
        arch = get_arch(name)
        return dataclasses.replace(arch, cfg=dataclasses.replace(
            arch.cfg, n_layers=int(layers)))

    def no_save(ckpt_dir, step, tree, **_):
        (Path(ckpt_dir) / f"step_{step:08d}").mkdir(parents=True,
                                                     exist_ok=True)

    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    with contextlib.ExitStack() as patches:
        if layers:
            patches.enter_context(mock.patch.object(cli, "get_arch", cut))
        if os.environ.get("SMOKE_TRAIN_NO_SAVE") == "1":
            patches.enter_context(mock.patch.object(
                cli, "state_tree", lambda *a: None))
            patches.enter_context(mock.patch.object(cli.ckpt, "save",
                                                    no_save))
        rc = cli.main(flags)
    torch.cuda.synchronize()
    rank = int(os.environ.get("RANK", "0"))
    counts = _read_counts()
    _rank_record("train-rank", os.environ["SMOKE_DIST_TAG"], rank).write_text(
        json.dumps({"rank": rank, "rc": rc,
                    "wall_s": time.monotonic() - t0,
                    "launches": {k: counts[k] for k in TRAIN_KERNELS},
                    "peak": torch.cuda.max_memory_allocated()}))
    return rc


def _manifest_leaves_equal(name: str, got: dict, want: dict) -> int:
    """Two checkpoints' manifests: the same tree, and every leaf of the
    same shape, dtype and CRC-32; returns the leaf count."""
    if got["treedef"] != want["treedef"] or got["extra"] != want["extra"]:
        raise AssertionError(f"{name}: checkpoint tree or extra differs")
    if got["leaves"] != want["leaves"]:
        bad = [i for i, (a, b) in enumerate(zip(got["leaves"],
                                                 want["leaves"])) if a != b]
        raise AssertionError(f"{name}: {len(bad)} checkpoint leaves differ "
                             f"(first {bad[:5]})")
    return len(got["leaves"])


def sharded_loss_gaps(sharded: list, one: list) -> list:
    """Each step's relative gap between world size 2's losses and world
    size 1's; AssertionError past `SHARDED_TOL` (or on a missing or
    non-finite loss)."""
    rel = [abs(a - b) / abs(b) for a, b in zip(sharded, one)]
    if len(sharded) != len(one) or not one or \
            not all(map(math.isfinite, sharded)) or \
            not all(r <= SHARDED_TOL for r in rel):
        raise AssertionError(f"train-lm-sharded (b): world size 2's losses "
                             f"{sharded} vs world size 1's {one}: relative "
                             f"{rel} (tolerance {SHARDED_TOL})")
    return rel


def phase_train_lm_sharded(out: Path, lm: dict) -> dict:
    """train-lm-sharded: the trainer through the mesh code path under
    ``torchrun`` (module doc, phase 11); returns the launches of its runs,
    by kernel."""
    import shutil

    card = phase_card()
    total = {k: 0 for k in TRAIN_KERNELS}

    def run(tag, nproc, flags, layers=None):
        d = out / f"train_{tag}"
        shutil.rmtree(d, ignore_errors=True)
        torch.cuda.empty_cache()
        t = time.monotonic()
        rc, rank0, text = _torchrun(
            tag, nproc, flags + ["--device", "cuda", "--ckpt-dir", str(d)],
            rank_phase="train-rank", timeout=900,
            env_extra={"SMOKE_TRAIN_LAYERS": str(layers),
                       "SMOKE_TRAIN_NO_SAVE": "1"} if layers else None)
        torchrun_s = time.monotonic() - t
        if rc != 0 or rank0 is None:
            raise AssertionError(f"train-lm-sharded {tag}: torchrun exited "
                                 f"{rc}:\n{text[-3000:]}")
        ranks = [json.loads(_rank_record("train-rank", tag, r).read_text())
                 for r in range(nproc)]
        for r in ranks:
            for k in total:
                total[k] += r["launches"][k]
        saved = [ln for ln in text.splitlines() if "[train] saved step" in ln]
        _log(f"train-lm-sharded {tag}: torchrun {torchrun_s:.1f} s, ranks' "
             f"wall_s {[round(r['wall_s'], 1) for r in ranks]}; "
             f"{saved[-1:]}")
        return d, ranks, text

    # (a) world size 1 on NCCL, the mesh path, full width and depth
    steps = int(TRAIN_FLAGS[TRAIN_FLAGS.index("--steps") + 1])
    d, ranks, text = run("lm-sharded", 1, TRAIN_FLAGS + ["--model-parallel",
                                                         "1"])
    losses, steady = _losses(text), _steady(text)
    if "mesh (data, model)=(1, 1)" not in text:
        raise AssertionError("train-lm-sharded: the trainer ran no mesh")
    if losses != lm["losses"]:
        raise AssertionError(f"train-lm-sharded: losses {losses} != "
                             f"train-lm's {lm['losses']}")
    n = _manifest_leaves_equal(
        "train-lm-sharded", json.loads((d / f"step_{steps - 1:08d}"
                                        / "manifest.json").read_text()),
        lm["manifest"])
    if ranks[0]["launches"] != lm["launches"]:
        raise AssertionError(f"train-lm-sharded: launches "
                             f"{ranks[0]['launches']} != train-lm's "
                             f"{lm['launches']}")
    _log(f"train-lm-sharded (a): qwen3-1.7b full width and depth, 1x1 mesh "
         f"on one NCCL rank under torchrun ({card}): losses == train-lm's "
         f"{losses}; final checkpoint == train-lm's ({n} leaves: shape, "
         f"dtype and CRC-32 each); median step_s {steady['step_s']:.4f} "
         f"(train-lm {lm['steady']['step_s']:.4f}), tokens_per_s "
         f"{steady['tokens_per_s']:.1f} ({lm['steady']['tokens_per_s']:.1f}),"
         f" peak {steady['peak']} bytes ({lm['steady']['peak']}); launches "
         f"{ranks[0]['launches']} (train-lm {lm['launches']}); rank wall_s="
         f"{ranks[0]['wall_s']:.1f}")
    shutil.rmtree(d)

    # (b) world size 2 over gloo on the one card, --model-parallel 2, at
    # SHARDED_LAYERS layers, against world size 1 at the same depth
    got = {}
    for ws, extra in ((1, []), (2, ["--backend", "gloo"])):
        d, ranks, text = run(f"lm-sharded-ws{ws}", ws, SHARDED_FLAGS + [
            "--model-parallel", str(ws)] + extra, layers=SHARDED_LAYERS)
        got[ws] = (_losses(text), _steady(text), ranks)
        _log(f"train-lm-sharded (b): {SHARDED_LAYERS} of 28 layers, world "
             f"size {ws} ({'gloo, CUDA tensors' if ws > 1 else 'NCCL'}), "
             f"--model-parallel {ws}: losses {got[ws][0]}; median step_s "
             f"{got[ws][1]['step_s']:.4f}; peak bytes by rank "
             f"{[r['peak'] for r in ranks]}; launches by rank "
             f"{[r['launches'] for r in ranks]}")
        shutil.rmtree(d)
    (l1, s1, r1), (l2, s2, r2) = got[1], got[2]
    rel = sharded_loss_gaps(l2, l1)
    if not all(r["peak"] < r1[0]["peak"] for r in r2):
        raise AssertionError(f"train-lm-sharded (b): a rank's peak "
                             f"{[r['peak'] for r in r2]} is not below world "
                             f"size 1's {r1[0]['peak']}")
    for r in r2:
        if r["launches"]["flash_attention"] <= 0 or \
                r["launches"]["flash_attention_bwd"] <= 0 or \
                r["launches"]["adamw"] <= 0:
            raise AssertionError(f"train-lm-sharded (b): rank {r['rank']} "
                                 f"launched no kernel: {r['launches']}")
    _log(f"train-lm-sharded (b): world size 2 losses within {SHARDED_TOL} "
         f"relative of world size 1's ("
         f"{[f'{r:.2e}' for r in rel]}); each rank's peak "
         f"{[r['peak'] for r in r2]} below world size 1's {r1[0]['peak']}")
    return total


def _no_dispatches(d: dict) -> dict:
    d = _strip_resumed(d)
    d.pop("dispatches")
    for st in d["per_level"].values():
        st.pop("dispatches")
    return d


def phase_distributed(out: Path, sigma: int) -> dict:
    """12. main-distributed and golden-distributed (see the module doc)."""
    import shutil

    card = phase_card()
    flags = [f if f != "mis" else "mis_luby"
             for f in mico_flags(sigma, "batched")]
    _zero_counts()
    t0 = time.monotonic()
    batched = _run_cli(flags, out / "smoke_mico_luby_batched.json")
    torch.cuda.synchronize()
    batched_wall = time.monotonic() - t0
    batched_launches = _mining_counts()
    flags[flags.index("batched")] = "distributed"
    path = out / "smoke_mico_luby_distributed.json"
    path.unlink(missing_ok=True)
    rc, rank0, tail = _torchrun("main", 1, flags + ["--device", "cuda",
                                                    "--json", str(path)])
    if rc != 0 or rank0 is None:
        raise AssertionError(f"main-distributed: torchrun exited {rc}:\n"
                             f"{tail[-3000:]}")
    got = json.loads(path.read_text())
    c = rank0["counters"]
    _log(f"main-distributed: mico x1.0 sigma={sigma} mis_luby, 1 NCCL rank "
         f"({card}): wall_s={rank0['wall_s']:.2f} (CLI in the rank) "
         f"elapsed_s={got['elapsed_s']:.2f}; batched mis_luby wall_s="
         f"{batched_wall:.2f} elapsed_s={batched['elapsed_s']:.2f}; "
         f"dispatches={c['dispatches']} luby_rounds={c['luby_rounds']} "
         f"all_reduce calls={c['all_reduce']} bytes="
         f"{c['all_reduce_bytes']} device_ms={rank0['collective_ms']:.3f}; "
         f"launches={rank0['launches']} (batched {batched_launches}); "
         f"levels_s={[round(st['wall_s'], 3) for st in got['per_level'].values()]}")
    _same_frequent("main-distributed", got, batched)
    if got["health"]["counts"].get("plane_fallback"):
        raise AssertionError(f"main-distributed fell back to the batched "
                             f"plane: {got['health']}")
    if rank0["launches"]["frontier_expand"] <= 0 or c["all_reduce"] <= 0:
        raise AssertionError(f"main-distributed: no frontier launch or no "
                             f"collective: {rank0}")
    _log("main-distributed: frequent set, supports and level counts == the "
         "batched mis_luby run; no plane_fallback")

    runs = {}
    for ws, extra in ((2, ["--backend", "gloo"]), (1, [])):
        path = out / f"smoke_golden_distributed_ws{ws}.json"
        path.unlink(missing_ok=True)
        rc, rank0, tail = _torchrun(
            f"golden{ws}", ws, DIST_GOLDEN_FLAGS + extra + [
                "--device", "cuda", "--json", str(path)], timeout=300)
        if rc != 0 or rank0 is None:
            raise AssertionError(f"golden-distributed at world size {ws}: "
                                 f"torchrun exited {rc}:\n{tail[-3000:]}")
        runs[ws] = json.loads(path.read_text())
        c = rank0["counters"]
        _log(f"golden-distributed: world size {ws} wall_s="
             f"{rank0['wall_s']:.2f} n_frequent={runs[ws]['n_frequent']} "
             f"dispatches={c['dispatches']} luby_rounds={c['luby_rounds']} "
             f"all_reduce calls={c['all_reduce']} device_ms="
             f"{rank0['collective_ms']:.3f} launches={rank0['launches']}")
        if runs[ws]["health"]["events"] or rank0["launches"][
                "frontier_expand"] <= 0:
            raise AssertionError(f"golden-distributed at world size {ws}: "
                                 f"{runs[ws]['health']} {rank0}")
    if _no_dispatches(runs[2]) != _no_dispatches(runs[1]):
        raise AssertionError("golden-distributed: world size 2 differs from "
                             "world size 1")
    _log("golden-distributed: world size 2 (gloo) == world size 1 (NCCL), "
         "minus wall clock and dispatches")

    ckpt_dir = out / "dist_kill"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    session = DIST_GOLDEN_FLAGS + ["--device", "cuda", "--checkpoint-dir",
                                   str(ckpt_dir), "--checkpoint-every", "1"]
    rc, _, tail = _torchrun(
        "kill", 2, session + ["--backend", "gloo"], timeout=300,
        env_extra={"REPRO_TORCH_FAULT_PLAN": json.dumps(
            [{"point": "session.snapshot", "kind": "crash",
              "at": DIST_KILL_AT}])})
    if rc == 0 or "InjectedCrash" not in tail:
        raise AssertionError(f"golden-distributed: the injected crash never "
                             f"fired (exit {rc}):\n{tail[-3000:]}")
    steps = sorted(ckpt_dir.glob("step_*/COMMIT"))
    if not steps:
        raise AssertionError("golden-distributed: no committed snapshot")
    manifest = json.loads((steps[-1].parent / "manifest.json").read_text())
    inflight = (manifest["extra"].get("level_cursor") or {}).get("inflight")
    if not inflight or inflight["plane"] != "distributed":
        raise AssertionError(f"golden-distributed: the last snapshot holds "
                             f"no super-block cursor: {manifest['extra']['cursor']}")
    path = out / "smoke_golden_distributed_resumed.json"
    path.unlink(missing_ok=True)
    rc, rank0, tail = _torchrun("resume", 1, session + [
        "--resume", "--json", str(path)], timeout=300)
    if rc != 0 or rank0 is None:
        raise AssertionError(f"golden-distributed resume: torchrun exited "
                             f"{rc}:\n{tail[-3000:]}")
    resumed = json.loads(path.read_text())
    _log(f"golden-distributed: killed at world size 2 after snapshot "
         f"{DIST_KILL_AT}, resumed at world size 1 from "
         f"{steps[-1].parent.name} (cursor {manifest['extra']['cursor']}, "
         f"next block {inflight['next_block']}) in wall_s="
         f"{rank0['wall_s']:.2f}, launches={rank0['launches']}")
    if _no_dispatches(resumed) != _no_dispatches(runs[1]):
        raise AssertionError("golden-distributed: the resumed --json differs "
                             "from the uninterrupted run")
    _log("golden-distributed: resumed --json == the uninterrupted run, minus "
         "wall clock, health and dispatches")
    return {"launches": rank0["launches"]}


def phase_train_dlrm(dev) -> tuple:
    """dlrm-rm2 trained at full width: DLRM_TRAIN_STEPS train_batch steps of
    65 536; the loss on the first batch falls; then the bag backward at the
    first batch's bags, held against autograd of the plain bag on f32
    copies (`BAG_BWD_TOL`, a table at a time) and launched twice
    (identical bytes); returns (launches by kernel, the bag backward's
    kernel row)."""
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.embedding_bag.kernel import (
        embedding_bag_bwd_tbh, embedding_bag_tbh,
    )
    from repro_torch.kernels.embedding_bag.ops import bag_grad_plan
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.models.dlrm import dlrm_loss
    from repro_torch.testing.parity import BAG_BWD_TOL, grads_close
    from repro_torch.train.step import init_opt_state

    arch = get_arch("dlrm-rm2")
    cfg = arch.cfg
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    model = arch.init(torch.Generator(device=dev).manual_seed(0), device=dev,
                      train=True)
    state = init_opt_state(model)
    batches = [arch.inputs("train_batch", seed=0, step=s, device=dev)
               for s in range(DLRM_TRAIN_STEPS)]
    torch.cuda.synchronize()
    _log(f"train-dlrm: dlrm-rm2 f32 tables {tuple(model.tables.shape)}, "
         f"moments and {DLRM_TRAIN_STEPS} batches made in "
         f"{time.monotonic() - t0:.1f} s")
    step = arch.step_fn("train_batch")
    first = batches[0]

    def held_loss():
        with torch.no_grad():
            return float(dlrm_loss(model, first["dense"], first["sparse_idx"],
                                   first["labels"]))

    before = held_loss()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    losses, step_ms = [], []
    for x in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, model, state = step(model, state, x["dense"], x["sparse_idx"],
                                  x["labels"])
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t) * 1e3)
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    after = held_loss()
    launches = {k: counts[k] for k in ("embedding_bag", "embedding_bag_bwd",
                                       "adamw")}
    B = arch.batch("train_batch")
    med = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    cast_ms = _time_ms(lambda: model.tables.to(torch.bfloat16), reps=5)
    _log(f"train-dlrm: batch {B}: losses={losses} first-batch loss "
         f"{before:.6f} → {after:.6f}; step_ms={[round(m, 3) for m in step_ms]} "
         f"(median after the first {med:.3f}, examples_per_s="
         f"{B / med * 1e3:.6g}) f32→bf16 table cast_ms={cast_ms:.4f} "
         f"max_memory_allocated={peak} launches={launches}")
    n_leaves = len(list(model.parameters()))
    if launches != {"embedding_bag": DLRM_TRAIN_STEPS,
                    "embedding_bag_bwd": DLRM_TRAIN_STEPS,
                    "adamw": DLRM_TRAIN_STEPS * n_leaves}:
        raise AssertionError(f"train-dlrm: every step must launch the bag "
                             f"and its backward once, AdamW once per "
                             f"parameter ({n_leaves}): {launches}")
    if not all(map(math.isfinite, losses)) or not after < before:
        raise AssertionError(f"train-dlrm: the first batch's loss did not "
                             f"fall: {before} → {after} ({losses})")

    # the backward kernel at the train shape's bags: checked, then timed
    T, R, D = model.tables.shape
    ids = first["sparse_idx"]
    Bn, _, H = ids.shape
    tables = model.tables.detach().to(torch.bfloat16)
    del model, state, batches, first
    torch.cuda.empty_cache()
    d_out = torch.randn((Bn, T, D), generator=torch.Generator(device=dev)
                        .manual_seed(4), device=dev).to(torch.bfloat16)
    plan = bag_grad_plan(ids, None, R, False)
    plan_ms = _time_ms(lambda: bag_grad_plan(ids, None, R, False), reps=5)
    got = embedding_bag_bwd_tbh(d_out, plan, T, R)
    if not torch.equal(got, embedding_bag_bwd_tbh(d_out, plan, T, R)):
        raise AssertionError("embedding_bag_bwd: a second launch at "
                             "train_batch's bags gave other bytes")
    t32 = tables.float().requires_grad_()
    embedding_bag_ref(t32, ids).backward(d_out.float())
    rtol, atol = BAG_BWD_TOL[torch.bfloat16]
    err = max(grads_close(f"embedding_bag_bwd (train_batch) table {t}",
                          got[t], t32.grad[t], rtol=rtol, atol=atol)
              for t in range(T))
    del got, t32
    torch.cuda.empty_cache()
    ms = _time_ms(lambda: embedding_bag_bwd_tbh(d_out, plan, T, R), reps=10)
    leaf = tables.detach().requires_grad_()
    ref_out = embedding_bag_ref(leaf, ids)
    plain_ms = _time_ms(lambda: torch.autograd.grad(
        ref_out, leaf, d_out, retain_graph=True), reps=3)
    del ref_out
    flat = (ids.long() + torch.arange(T, device=dev)[None, :, None] * R
            ).reshape(Bn * T, H)
    weight = tables.view(T * R, D).detach().requires_grad_()
    lib_out = F.embedding_bag(flat, weight, mode="sum")
    library_ms = _time_ms(lambda: torch.autograd.grad(
        lib_out, weight, d_out.view(Bn * T, D), retain_graph=True), reps=5)
    del lib_out, weight, leaf
    # bytes: the dense zero fill of the (T, R, D) gradient, d_out and the
    # ids read once, the touched rows written; adds: one FMA per id and D
    n_seg = plan.seg_row.numel()
    esize = tables.element_size()
    nbytes = T * R * D * esize + Bn * T * D * esize + Bn * T * H * 4 \
        + n_seg * D * esize
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = 2 * Bn * T * H * D / F32_FLOPS_S
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "max_abs_err": err}
    _log(f"kernels: embedding_bag_bwd B={Bn} T={T} R={R} D={D} bf16, "
         f"{n_seg} segments: == autograd of the plain bag on f32 copies "
         f"(rtol, atol = {BAG_BWD_TOL[torch.bfloat16]}, max_abs_err="
         f"{err:.3g}), a second launch byte-identical; "
         f"ms={ms:.4f} (zero fill + segments; the plan's "
         f"sort {plan_ms:.4f} ms more) plain_ms={plain_ms:.3f} "
         f"F.embedding_bag_bwd_ms={library_ms:.4f} bound_ms="
         f"{row['bound_ms']:.4f} ({nbytes} bytes)")
    del tables
    torch.cuda.empty_cache()
    return launches, row


def phase_train_gnn(dev, gnn: dict) -> tuple:
    """graphsage-reddit minibatch_lg trained on the sampler's blocks of the
    Reddit-sized graph: SAGE_TRAIN_STEPS steps; block 0's loss falls; then
    the transpose at layer 1 of block 0, held against autograd of the plain
    aggregate on f32 copies (`AGG_T_TOL`) and launched twice (identical
    bytes); returns (launches by kernel, the transpose kernel's row)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.sampler import block_graph_batch
    from repro_torch.kernels.gather_aggregate.kernel import (
        gather_aggregate_t_nf,
    )
    from repro_torch.kernels.gather_aggregate.ops import (
        in_neighbor_table, out_neighbor_csr,
    )
    from repro_torch.kernels.gather_aggregate.ref import gather_aggregate_ref
    from repro_torch.testing.parity import AGG_T_TOL, grads_close
    from repro_torch.train.step import init_opt_state

    arch = get_arch("graphsage-reddit")
    shape = "minibatch_lg"
    sampler, feats, labels = gnn["sampler"], gnn["feats"], gnn["labels"]
    model = arch.init(shape, torch.Generator(device=dev).manual_seed(0),
                      device=dev, train=True)
    state = init_opt_state(model)
    loss_fn = arch.loss_fn(shape)
    step = arch.step_fn(shape)
    t0 = time.monotonic()
    gbs = [block_graph_batch(sampler.sample(s), feats, labels)
           for s in range(SAGE_TRAIN_STEPS)]
    _log(f"train-gnn: {SAGE_TRAIN_STEPS} blocks sampled in "
         f"{time.monotonic() - t0:.2f} s")

    def held_loss():
        with torch.no_grad():
            return float(loss_fn(model, gbs[0]))

    before = held_loss()
    _zero_counts()
    losses, step_ms = [], []
    for gb in gbs:
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, model, state = step(model, state, gb)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t) * 1e3)
    counts = _read_counts()
    after = held_loss()
    launches = {k: counts[k] for k in ("gather_aggregate",
                                       "gather_aggregate_t", "adamw")}
    _log(f"train-gnn: graphsage-reddit {shape}: losses={losses} block-0 "
         f"loss {before:.6f} → {after:.6f}; step_ms="
         f"{[round(m, 3) for m in step_ms]} launches={launches}")
    n_leaves = len(list(model.parameters()))
    if launches != {"gather_aggregate": 2 * SAGE_TRAIN_STEPS,
                    "gather_aggregate_t": SAGE_TRAIN_STEPS,
                    "adamw": SAGE_TRAIN_STEPS * n_leaves}:
        raise AssertionError(f"train-gnn: every step must launch the "
                             f"aggregate twice and its transpose once (layer "
                             f"1's input only), AdamW once per parameter "
                             f"({n_leaves}): {launches}")
    if not after < before:
        raise AssertionError(f"train-gnn: block 0's loss did not fall: "
                             f"{before} → {after} ({losses})")

    # the transpose at layer 1 of block 0 (its input is (N, d_hidden)), timed
    gb = gbs[0]
    nbrs = in_neighbor_table(gb.edge_src, gb.edge_dst, gb.edge_mask,
                             gb.x.shape[0])
    N = nbrs.shape[0]
    Fd = arch.config(shape).d_hidden
    d_out = torch.randn((N, Fd), generator=torch.Generator(device=dev)
                        .manual_seed(5), device=dev).to(torch.bfloat16)
    indptr, dst, deg = out_neighbor_csr(nbrs)
    csr_ms = _time_ms(lambda: out_neighbor_csr(nbrs), reps=5)
    got = gather_aggregate_t_nf(d_out, indptr, dst, deg)
    if not torch.equal(got, gather_aggregate_t_nf(d_out, indptr, dst, deg)):
        raise AssertionError("gather_aggregate_t: a second launch at layer "
                             "1's shape gave other bytes")
    digest = _sha256(got)
    # the out-degrees: does one node's chain set the kernel's tail?
    out_deg = (indptr[1:] - indptr[:-1]).float()
    deg_max = int(out_deg.max())
    deg_p99 = float(torch.quantile(out_deg, 0.99))
    deg_zero = float((out_deg == 0).float().mean())
    h32 = torch.zeros((N, Fd), dtype=torch.float32, device=dev,
                      requires_grad=True)
    gather_aggregate_ref(h32, nbrs, mean=True).backward(d_out.float())
    rtol, atol = AGG_T_TOL[torch.bfloat16]
    err = grads_close("gather_aggregate_t (layer 1 of block 0)", got,
                      h32.grad, rtol=rtol, atol=atol)
    del got, h32
    ms = _time_ms(lambda: gather_aggregate_t_nf(d_out, indptr, dst, deg),
                  reps=20)
    h = torch.zeros((N, Fd), dtype=torch.bfloat16, device=dev,
                    requires_grad=True)
    ref_out = gather_aggregate_ref(h, nbrs, mean=True)
    # slow: every pad of the padded table clamps to row 0, and autograd's
    # index backward accumulates ~2 M of them into one row
    plain_ms = _time_ms(lambda: torch.autograd.grad(
        ref_out, h, d_out, retain_graph=True), reps=1)
    del ref_out
    nnz = int(indptr[-1])
    counts_i = torch.bincount(dst.long(), minlength=N)
    crow = indptr.long()
    vals = (1.0 / deg.clamp(min=1).float())[dst.long()]
    lib_dtype = torch.bfloat16
    try:
        adj_t = torch.sparse_csr_tensor(crow, dst.long(), vals.to(lib_dtype),
                                        (N, N), check_invariants=False)
        torch.sparse.mm(adj_t, d_out)
    except RuntimeError as e:   # a yardstick only: time it in f32 instead
        _log(f"kernels: torch.sparse.mm has no bf16 CSR path here ({e}); "
             f"timing it in f32")
        lib_dtype = torch.float32
        adj_t = torch.sparse_csr_tensor(crow, dst.long(), vals, (N, N),
                                        check_invariants=False)
    d_lib = d_out.to(lib_dtype)
    library_ms = _time_ms(lambda: torch.sparse.mm(adj_t, d_lib), reps=20)
    # bytes: the CSR, deg, each destination row read once, every node's
    # row written; adds: one per (u, i) pair and column
    rows_read = int((counts_i > 0).sum())
    esize = d_out.element_size()
    nbytes = (N + 1 + nnz + N) * 4 + rows_read * Fd * esize + N * Fd * esize
    t_bytes, t_ops = nbytes / HBM_BYTES_S, 2 * nnz * Fd / F32_FLOPS_S
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "max_abs_err": err}
    _log(f"kernels: gather_aggregate_t N={N} F={Fd} nnz={nnz} bf16 mean: "
         f"== autograd of the plain aggregate on f32 copies (rtol, atol = "
         f"{AGG_T_TOL[torch.bfloat16]}, max_abs_err={err:.3g}), a second "
         f"launch byte-identical; "
         f"ms={ms:.4f} (out-degree max {deg_max}, p99 {deg_p99:.1f}, share "
         f"of nodes without out-edges {deg_zero:.3f}; the out-neighbour "
         f"CSR's build {csr_ms:.4f} ms more) "
         f"plain_ms={plain_ms:.3f} sparse_mm_ms={library_ms:.4f} "
         f"({str(lib_dtype)[6:]}) bound_ms={row['bound_ms']:.4f} "
         f"({nbytes} bytes); output sha256 {digest}")
    del model, state, gbs
    torch.cuda.empty_cache()
    return launches, row


# the GNN archs (phase 8b, gnn-archs): every (arch, shape) the port trains
# beyond train-gnn's graphsage-reddit minibatch_lg, at full width
GNN_ARCH_RUNS = tuple((a, s) for a in ("schnet", "nequip", "graphcast")
                      for s in ("full_graph_sm", "molecule", "minibatch_lg")
                      ) + (("graphsage-reddit", "full_graph_sm"),
                           ("graphsage-reddit", "molecule"))
GNN_ARCH_STEPS = 4
# depth cuts: graphcast's processor sums edge states with no normalisation
# (the reference's model), so at the R-MAT stand-in's in-degree-274 hub its
# node states grow with every layer at full_graph_sm: at 16 layers the f32
# loss is inf, and 4 layers keep the loss and the gradient norm finite, in
# the reference's arithmetic as in the port's (tests/test_torch_gnn_archs
# .py::test_graphcast_full_graph_sm_overflows_as_reference; ROADMAP Queue 3)
GNN_ARCH_LAYERS = {("graphcast", "full_graph_sm"): 4}
# the molecule card-against-CPU check runs graphcast at 2 of its 16 layers
# (the CPU's bf16 products at 16 layers cost minutes)
GRAPHCAST_CPU_LAYERS = 2


def phase_gnn_archs(dev, gnn: dict) -> dict:
    """The GNN archs trained at full width: for each of `GNN_ARCH_RUNS`,
    the model from ``torch.Generator`` seed 0 (f32 masters), GNN_ARCH_STEPS
    train steps (loss + grads + AdamW) on the shape's batch (``inputs``:
    the one batch of full_graph_sm or molecule) or on blocks 0.. of
    phase 8's sampler (minibatch_lg, positions drawn for the whole graph),
    counts zeroed just before the steps and read just after; every loss
    finite, the held batch's (block 0's) loss, read twice before the
    steps and twice after, falling by more than the larger spread of a
    pair of readings; GraphSAGE's logits equal to the same forward with the
    plain aggregate; at molecule the card against the CPU
    (`parity.gnn_card_against_cpu`; graphcast at GRAPHCAST_CPU_LAYERS
    layers).
    Returns the launches by kernel over the runs' steps."""
    import copy
    import statistics
    from unittest import mock

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.sampler import block_graph_batch
    from repro_torch.kernels.gather_aggregate.ref import gather_aggregate_ref
    from repro_torch.models.gnn import graphsage
    from repro_torch.models.gnn.graphcast import graphcast_init
    from repro_torch.testing.parity import AGG_TOL, gnn_card_against_cpu
    from repro_torch.train.step import init_opt_state

    sampler, feats, labels = gnn["sampler"], gnn["feats"], gnn["labels"]
    t0 = time.monotonic()
    blocks = [sampler.sample(s) for s in range(GNN_ARCH_STEPS)]
    pos = get_arch("schnet").node_pos(feats.shape[0], seed=SAGE_SEED,
                                      device=dev)
    _log(f"gnn-archs: blocks 0-{GNN_ARCH_STEPS - 1} sampled and the graph's "
         f"positions drawn in {time.monotonic() - t0:.2f} s")
    total = {"gather_aggregate": 0, "gather_aggregate_t": 0, "adamw": 0}
    for name, shape in GNN_ARCH_RUNS:
        arch = get_arch(name)
        if shape == "minibatch_lg":
            gbs = [block_graph_batch(b, feats, labels,
                                     pos if arch.needs_positions else None)
                   for b in blocks]
        else:
            gbs = [arch.inputs(shape, seed=SAGE_SEED, device=dev)] * \
                GNN_ARCH_STEPS
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev).manual_seed(0)
        layers = GNN_ARCH_LAYERS.get((name, shape))
        if layers is None:
            model = arch.init(shape, gen, device=dev, train=True)
        else:
            model = graphcast_init(dataclasses.replace(
                arch.config(shape), n_layers=layers), gen, device=dev,
                train=True)
        n_params = sum(p.numel() for p in model.parameters())
        n_leaves = len(list(model.parameters()))
        state = init_opt_state(model)
        loss_fn, step = arch.loss_fn(shape), arch.step_fn(shape)

        def held_loss():
            with torch.no_grad():
                return float(loss_fn(model, gbs[0]))

        before = (held_loss(), held_loss())
        _zero_counts()
        losses, step_ms = [], []
        for gb in gbs:
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss, model, state = step(model, state, gb)
            losses.append(float(loss))
            step_ms.append((time.perf_counter() - t) * 1e3)
        counts = _read_counts()
        peak = torch.cuda.max_memory_allocated()
        after = (held_loss(), held_loss())
        launches = {k: counts[k] for k in total}
        sage = name == "graphsage-reddit"
        want = {"gather_aggregate": 2 * GNN_ARCH_STEPS if sage else 0,
                "gather_aggregate_t": GNN_ARCH_STEPS if sage else 0,
                "adamw": GNN_ARCH_STEPS * n_leaves}
        gb0 = gbs[0]
        cut = "" if layers is None else f" (cut to {layers} layers)"
        _log(f"gnn-archs: {name}{cut} {shape}: {int(gb0.node_mask.sum())} "
             f"nodes, {int(gb0.edge_mask.sum())} edges (padded "
             f"{gb0.x.shape[0]} / {gb0.edge_src.shape[0]}), {n_params} "
             f"parameters in {n_leaves} leaves; losses={losses}; held loss "
             f"{before[0]!r} (again {before[1]!r}) → {after[0]!r} (again "
             f"{after[1]!r}); "
             f"step_ms={[round(m, 3) for m in step_ms]} (median after the "
             f"first {statistics.median(step_ms[1:]):.3f}); "
             f"max_memory_allocated={peak}; launches={launches}")
        if not all(math.isfinite(v) for v in losses + [*before, *after]):
            raise AssertionError(f"gnn-archs: {name} {shape}: a non-finite "
                                 f"loss: {losses}, {before}, {after}")
        # the held loss's two readings differ where atomics sum in bf16:
        # the fall must exceed the larger spread of a pair of readings
        spread = max(abs(before[0] - before[1]), abs(after[0] - after[1]))
        if not min(before) - max(after) > spread:
            raise AssertionError(f"gnn-archs: {name} {shape}: the held "
                                 f"loss did not fall by more than its "
                                 f"spread {spread}: {before} → {after}")
        if launches != want:
            raise AssertionError(f"gnn-archs: {name} {shape}: launches "
                                 f"{launches}, expected {want}")
        for k in total:
            total[k] += launches[k]
        if sage:
            # the head on every node's state (molecule pools them after:
            # the pool's atomics add in no fixed order, so two forwards'
            # pooled logits may differ by a rounding; held to AGG_TOL)
            nodes = copy.copy(model)
            nodes.cfg = dataclasses.replace(model.cfg, graph_level=False)
            with torch.inference_mode():
                got = [graphsage.sage_apply(m, gb0).float()
                       for m in (nodes, model)]
                with mock.patch.object(graphsage, "gather_aggregate",
                                       gather_aggregate_ref):
                    plain = [graphsage.sage_apply(m, gb0).float()
                             for m in (nodes, model)]
            if not torch.equal(got[0], plain[0]):
                raise AssertionError(
                    f"gnn-archs: sage {shape} logits differ from the plain "
                    f"aggregate's by {float((got[0] - plain[0]).abs().max())}")
            tol = AGG_TOL[torch.bfloat16]
            torch.testing.assert_close(got[1], plain[1], atol=tol, rtol=tol)
            _log(f"gnn-archs: graphsage-reddit {shape} node logits == the "
                 f"same forward with the plain aggregate (exact); outputs "
                 f"max abs err {float((got[1] - plain[1]).abs().max()):.3g}")
        elif shape == "molecule":
            check = model
            if name == "graphcast":
                cfg = dataclasses.replace(arch.config(shape),
                                          n_layers=GRAPHCAST_CPU_LAYERS)
                check = graphcast_init(cfg, torch.Generator(device=dev)
                                       .manual_seed(0), device=dev,
                                       train=True)
            t = time.monotonic()
            msg = gnn_card_against_cpu(arch, shape, check, gb0)
            depth = (f"{GRAPHCAST_CPU_LAYERS} layers, "
                     if name == "graphcast" else "")
            _log(f"gnn-archs: {name} molecule on the card against the CPU "
                 f"({depth}{time.monotonic() - t:.1f} s): {msg}")
            del check
        del model, state, gbs, gb0
        torch.cuda.empty_cache()
    _log(f"gnn-archs: launches over the runs' steps {total}")
    return total


def _timed(phase, *args):
    """``phase(*args)``, its wall time logged."""
    t = time.monotonic()
    try:
        return phase(*args)
    finally:
        _log(f"time {phase.__name__}: {time.monotonic() - t:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mico-sigma", type=int, default=MICO_SIGMA,
                    help="σ of the full-size mico run (phase 5)")
    ap.add_argument("--phase", choices=["train-resume", "distributed",
                                        "dist-rank", "serve-archs",
                                        "gnn-archs", "train-rank",
                                        "train-sharded"],
                    help="run this phase alone (the smoke runs train-resume "
                         "so, in a child process of its own, and each rank "
                         "of the distributed phase as dist-rank, the CLI's "
                         "flags after --; serve-archs: phase 6b and the "
                         "flash kernel's rows of phase 9; gnn-archs: phase "
                         "8's graph and forward, then phase 8b; "
                         "train-sharded: train-lm, then train-lm-sharded, "
                         "whose torchrun ranks run as train-rank)")
    argv = sys.argv[1:] if argv is None else list(argv)
    cli_flags = argv[argv.index("--") + 1:] if "--" in argv else []
    argv = argv[:argv.index("--")] if "--" in argv else argv
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[smoke] no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    if args.phase == "train-resume":
        OUT.mkdir(parents=True, exist_ok=True)
        phase_train_resume(OUT)
        return 0
    if args.phase == "dist-rank":
        return phase_dist_rank(cli_flags)
    if args.phase == "train-rank":
        return phase_train_rank(cli_flags)
    if args.phase == "train-sharded":
        OUT.mkdir(parents=True, exist_ok=True)
        dev = torch.device("cuda")
        phase_build()
        t0 = time.monotonic()
        lm_ref = phase_train_lm(OUT, dev)[3]
        t1 = time.monotonic()
        phase_train_lm_sharded(OUT, lm_ref)
        _log(f"train-sharded alone: train-lm {t1 - t0:.1f} s, "
             f"train-lm-sharded {time.monotonic() - t1:.1f} s")
        phase_card()
        return 0
    if args.phase == "distributed":
        OUT.mkdir(parents=True, exist_ok=True)
        phase_build()
        phase_distributed(OUT, args.mico_sigma)
        return 0
    if args.phase == "serve-archs":
        phase_build()
        phase_card()
        for arch, n_layers, replay in SERVE_ARCHS:
            phase_serve_arch(torch.device("cuda"), arch, n_layers, replay)
        phase_flash_kernel(torch.device("cuda"))
        return 0
    if args.phase == "gnn-archs":
        phase_build()
        phase_card()
        t0 = time.monotonic()
        gnn = phase_gnn(torch.device("cuda"))[2]
        t1 = time.monotonic()
        phase_gnn_archs(torch.device("cuda"), gnn)
        _log(f"gnn-archs alone: phase 8 {t1 - t0:.1f} s, phase 8b "
             f"{time.monotonic() - t1:.1f} s")
        phase_card()
        return 0

    dev = torch.device("cuda")
    t0 = time.monotonic()
    phase_build()
    phase_card()
    worst = _timed(phase_parity, dev)
    worst_flash = _timed(phase_flash_parity, dev)
    worst_new = _timed(phase_bag_agg_parity, dev)
    worst_bwd = _timed(phase_backward_parity, dev)
    OUT.mkdir(parents=True, exist_ok=True)
    _timed(phase_golden, OUT)
    _, batched = _timed(phase_main, OUT, args.mico_sigma)
    launches, auto, auto_wall = _timed(phase_auto, OUT, args.mico_sigma,
                                       batched)
    _timed(phase_sampled, OUT, args.mico_sigma, batched)
    flash_launches = _timed(phase_serve, OUT)
    for arch, n_layers, replay in SERVE_ARCHS:
        flash_launches += _timed(phase_serve_arch, dev, arch, n_layers,
                                 replay)
    bag_launches, bag = _timed(phase_recsys, dev)
    agg_launches, agg, gnn = _timed(phase_gnn, dev)
    aggt_launches, aggt = _timed(phase_train_gnn, dev, gnn)
    arch_launches = _timed(phase_gnn_archs, dev, gnn)
    del gnn
    kernels = _timed(phase_kernels, dev, launches, worst, args.mico_sigma)
    flash = _timed(phase_flash_kernel, dev)
    session, session_launches, meter = _timed(
        phase_session_auto, OUT, args.mico_sigma, auto, auto_wall)
    _timed(phase_session_kill, OUT, args.mico_sigma, session,
           session_launches, meter)
    _timed(phase_session_sigterm, OUT)
    _timed(phase_mis_exact, dev)
    lm_launches, flash_bwd, adamw, lm_ref = _timed(phase_train_lm, OUT, dev)
    sharded = _timed(phase_train_lm_sharded, OUT, lm_ref)
    _timed(phase_train_resume_child)
    bag_bwd_launches, bag_bwd = _timed(phase_train_dlrm, dev)
    _timed(phase_distributed, OUT, args.mico_sigma)
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
        "launches": flash_launches + sharded["flash_attention"],
        "max_abs_err": max(worst_flash, flash["max_abs_err"]),
        "ms": flash["ms"], "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"]})
    for name, n, row, replaces in (
            ("embedding_bag", bag_launches, bag,
             "src/repro/kernels/embedding_bag/kernel.py:20"),
            ("gather_aggregate",
             agg_launches + arch_launches["gather_aggregate"], agg,
             "src/repro/kernels/gather_aggregate/kernel.py:24")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu", "replaces": replaces,
            "launches": n,
            "max_abs_err": max(worst_new[name], row["max_abs_err"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    # the backward kernels replace no TPU kernel: "replaces" names the
    # forward kernel each differentiates (AdamW: the reference's update it
    # fuses); launches are the training runs'
    for name, n, row, replaces in (
            ("flash_attention_bwd", lm_launches["flash_attention_bwd"]
             + sharded["flash_attention_bwd"],
             flash_bwd, "src/repro/kernels/flash_attention/kernel.py:27"),
            ("embedding_bag_bwd", bag_bwd_launches["embedding_bag_bwd"],
             bag_bwd, "src/repro/kernels/embedding_bag/kernel.py:20"),
            ("gather_aggregate_t", aggt_launches["gather_aggregate_t"]
             + arch_launches["gather_aggregate_t"], aggt,
             "src/repro/kernels/gather_aggregate/kernel.py:24"),
            ("adamw", lm_launches["adamw"] + arch_launches["adamw"]
             + sharded["adamw"], adamw, "src/repro/train/optimizer.py:59")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu", "replaces": replaces,
            "launches": n,
            "max_abs_err": max(worst_bwd[name], row["max_abs_err"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "repro" or m.startswith("repro.")]
    if bad:
        raise AssertionError(f"the smoke imported the reference: {bad[:5]}")
    _log(f"total {time.monotonic() - t0:.1f} s")
    phase_card()    # again, so that the card line also ends the log
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
