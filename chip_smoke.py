"""Smoke run of the PyTorch/CUDA port on one card: build, parity, exactness, full size.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without its last
line):

  1. build   — compile the five CUDA kernels from ``src/repro_torch/csrc``
               (one nvcc per source, in parallel), print the build time and
               the ptxas reports; fails unless the flash library's SASS holds
               HGMMA (tensor-core) instructions;
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
               8, 128, 602, ragged N; `AGG_TOL`);
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
  9. kernels — mining kernels vs plain versions again on real blocks of the
               mico graph at the main path's shapes (the frontier's hub
               block at level 2 also by pass, with its random loads and
               scratch; the mIS kernel's rows tested, passed by its
               prefilter and decided at the hub block), the flash kernel
               at the serve phase's per-layer shape, the embedding bag at
               serve_bulk's bags and the gather-aggregate at layer 0 of
               the block, with times (CUDA events), bounds, the library
               call's time and the launch counts of phases 5a (the mining
               kernels: the reference's default command) and 6–8, as one
               JSON line;
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
 11. the last line: {"ok": true, "device": {...}}.

Imports torch and the port (``src/repro_torch``) only — never JAX and
nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
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

    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_tbh
    from repro_torch.kernels.gather_aggregate.kernel import gather_aggregate_nf

    return {"frontier_expand": frontier_expand,
            "mis_bitmap": mis_bitmap_select,
            "flash_attention": flash_attention_bhsd,
            "embedding_bag": embedding_bag_tbh,
            "gather_aggregate": gather_aggregate_nf}


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


def phase_flash_kernel(dev) -> dict:
    """The flash kernel at the serve phase's per-layer shape: kernel vs
    plain version, timed beside its bound and the library call."""
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.testing.parity import FLASH_TOL, flash_inputs

    cfg = get_arch("qwen3-1.7b").cfg
    B, S = 4, 1024
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = flash_inputs(B, S, H, KV, hd, torch.bfloat16, dev, seed=1)
    # the kernel's own layout, as ops.flash_attention hands it over
    qf = q.transpose(1, 2).reshape(B * H, S, hd).contiguous()
    kf = k.transpose(1, 2).reshape(B * KV, S, hd).contiguous()
    vf = v.transpose(1, 2).reshape(B * KV, S, hd).contiguous()
    got = flash_attention_bhsd(qf, kf, vf, causal=True)
    got = got.reshape(B, H, S, hd).transpose(1, 2).float()
    want = flash_attention_ref(q, k, v, causal=True).float()
    err = float((got - want).abs().max())
    tol = FLASH_TOL[torch.bfloat16]
    if not torch.allclose(got, want, atol=tol, rtol=tol):
        raise AssertionError(f"flash_attention at the serve shape: max abs "
                             f"err {err} past atol = rtol = {tol}")
    ms = _time_ms(lambda: flash_attention_bhsd(qf, kf, vf, causal=True),
                  reps=20)
    plain_ms = _time_ms(lambda: flash_attention_ref(q, k, v, causal=True),
                        reps=5)
    q4, k4, v4 = (t.view(B, -1, S, hd) for t in (qf, kf, vf))
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, enable_gqa=True), reps=20)
    # causal-live work: S(S+1)/2 (query, key) pairs per head, 2·hd FLOPs
    # each for q·k and for p·v; bytes: q, k, v and o once, bf16
    flops = 4.0 * hd * B * H * S * (S + 1) / 2
    nbytes = 2 * (2 * B * H * S * hd + 2 * B * KV * S * hd)
    t_ops, t_bytes = flops / BF16_FLOPS_S, nbytes / HBM_BYTES_S
    _log(f"kernels: flash_attention B={B} S={S} H={H} KV={KV} hd={hd} bf16 "
         f"causal: ms={ms:.4f} ({flops / ms / 1e9:.1f} TFLOP/s) "
         f"plain_ms={plain_ms:.3f} sdpa_ms={library_ms:.4f} "
         f"bound_ms={max(t_ops, t_bytes) * 1e3:.4f} max_abs_err={err:.3g}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "max_abs_err": err}


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
    """graphsage-reddit's forward loss on block 0 of the port's sampler;
    returns (gather-aggregate launches in the run, the kernel row)."""
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

    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    ms = _wall_ms(lambda: loss_fn(model, gb), SAGE_REPS)
    loss = loss_fn(model, gb)
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
    return launches, row


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mico-sigma", type=int, default=MICO_SIGMA,
                    help="σ of the full-size mico run (phase 5)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[smoke] no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    dev = torch.device("cuda")
    t0 = time.monotonic()
    phase_build()
    phase_card()
    worst = phase_parity(dev)
    worst_flash = phase_flash_parity(dev)
    worst_new = phase_bag_agg_parity(dev)
    OUT.mkdir(parents=True, exist_ok=True)
    phase_golden(OUT)
    _, batched = phase_main(OUT, args.mico_sigma)
    launches, auto, auto_wall = phase_auto(OUT, args.mico_sigma, batched)
    phase_sampled(OUT, args.mico_sigma, batched)
    flash_launches = phase_serve(OUT)
    bag_launches, bag = phase_recsys(dev)
    agg_launches, agg = phase_gnn(dev)
    kernels = phase_kernels(dev, launches, worst, args.mico_sigma)
    flash = phase_flash_kernel(dev)
    session, session_launches, meter = phase_session_auto(
        OUT, args.mico_sigma, auto, auto_wall)
    phase_session_kill(OUT, args.mico_sigma, session, session_launches, meter)
    phase_session_sigterm(OUT)
    phase_mis_exact(dev)
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
        "launches": flash_launches,
        "max_abs_err": max(worst_flash, flash["max_abs_err"]),
        "ms": flash["ms"], "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"]})
    for name, n, row, replaces in (
            ("embedding_bag", bag_launches, bag,
             "src/repro/kernels/embedding_bag/kernel.py:20"),
            ("gather_aggregate", agg_launches, agg,
             "src/repro/kernels/gather_aggregate/kernel.py:24")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu", "replaces": replaces,
            "launches": n,
            "max_abs_err": max(worst_new[name], row["max_abs_err"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "repro" or m.startswith("repro.")]
    if bad:
        raise AssertionError(f"the smoke imported the reference: {bad[:5]}")
    _log(f"total {time.monotonic() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
