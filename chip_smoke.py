"""Smoke run of the PyTorch/CUDA port on one card: build, parity, exactness, full size.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without its last
line):

  1. build   — compile both CUDA kernels from ``src/repro_torch/csrc`` (one
               nvcc per source, in parallel) and print the build time;
  2. card    — print ``nvidia-smi --query-gpu=name,power.limit``;
  3. parity  — each kernel against its plain torch version on the card,
               integers compared exactly: frontier expansion at k = 2..5,
               an edgeless graph, cap overflow and a stacked P > 1 bucket;
               greedy mIS with τ cut mid-table, state carried across calls,
               P > 1, a shared-memory bitmap and a global-memory one
               (n > 1.8 M);
  4. golden  — the port's CLI on cuda for gnutella ×0.1, σ = 20, mis,
               batched, equal to the reference CLI's committed --json;
  5. main    — the port's CLI on cuda at paper size (mico ×1.0: 100 000
               vertices, 1 080 298 edges, 29 labels), mis, batched,
               max size 3; launch counts are zeroed just before and read
               just after;
  6. kernels — kernel vs plain version again on real blocks of the mico
               graph at the main path's shapes, with times (CUDA events),
               the bound and the launch counts of phase 5, as one JSON line;
  7. the last line: {"ok": true, "device": {...}}.

Imports torch and the port (``src/repro_torch``) only — never JAX and
nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
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


def mico_flags(sigma: int) -> list:
    return ["--dataset", "mico", "--scale", "1.0", "--sigma", str(sigma),
            "--lam", str(MICO_LAM), "--metric", "mis", "--execution",
            "batched", "--max-size", "3", "--cap", str(MICO_CAP)]
GOLDEN_FLAGS = ["--dataset", "gnutella", "--scale", "0.1", "--sigma", "20",
                "--lam", "0.4", "--max-size", "3", "--execution", "batched",
                "--metric", "mis"]

# H100 SXM peaks: HBM bytes/s (NVIDIA data sheet), and int32 instructions/s:
# 132 SMs × 64 int32 lanes per clock × the 1.98 GHz boost clock (the data
# sheet's 67 TFLOP/s float32 counts an FMA as two operations, int32 does not)
HBM_BYTES_S = 3.35e12
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
    from repro_torch.kernels import _build

    t0 = time.monotonic()
    _build.build_all()
    _log(f"build: both kernels in {time.monotonic() - t0:.1f} s")
    for name in _build.SOURCES:
        for line in _build.ptxas_report(name).splitlines():
            if "Used" in line:
                _log(f"ptxas {name}: {line.strip()}")


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
    from repro_torch.data.synthetic import rmat_graph
    from repro_torch.kernels.mis_bitmap.kernel import uses_shared_memory
    from repro_torch.testing.parity import (
        frontier_case, mis_case, patterns_by_k, random_graph,
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
    for cap in (1000, 16384):                     # partial / many row tiles
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
         "multi-chunk, skewed degrees, overflow, edgeless, P>1")

    def mcase(*a, **kw):
        worst["mis_bitmap"] = max(worst["mis_bitmap"], mis_case(*a, **kw))

    assert uses_shared_memory(bitmap_words(100_000), dev)
    mcase(100_000, 4, 4096, 3, 3, seed=7, device=dev,
          taus=[50, INT32_MAX, 700, 1])          # τ cut mid-table, carry
    assert uses_shared_memory(bitmap_words(1_000_000), dev)
    mcase(1_000_000, 3, 4096, 3, 3, seed=9, device=dev,
          taus=[INT32_MAX, 100, 2000])           # > 48 KB of shared memory
    assert not uses_shared_memory(bitmap_words(2_000_000), dev)
    mcase(2_000_000, 3, 4096, 5, 4, seed=10, device=dev,
          taus=[INT32_MAX, 300, 1])              # global-memory bitmap
    _log("parity: mis_bitmap == plain (exact, tolerance 0) on tau cut, carry, "
         "P>1, shared (<48 KB, >48 KB) and global bitmaps")
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


def phase_main(out: Path, sigma: int) -> dict:
    from repro_torch.kernels.frontier_expand.kernel import frontier_expand
    from repro_torch.kernels.mis_bitmap.kernel import mis_bitmap_select

    torch.cuda.reset_peak_memory_stats()
    frontier_expand.launches = 0
    mis_bitmap_select.launches = 0
    t0 = time.monotonic()
    res = _run_cli(mico_flags(sigma), out / "smoke_mico.json")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"frontier_expand": frontier_expand.launches,
                "mis_bitmap": mis_bitmap_select.launches}
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
    return launches


def phase_kernels(dev, launches: dict, worst: dict, sigma: int) -> list:
    """Kernel vs plain version on real mico blocks, timed, with bounds."""
    from repro_torch.core import MatchConfig
    from repro_torch.core.flexis import initial_candidates, tau_threshold
    from repro_torch.core.generation import generate_new_patterns
    from repro_torch.core.graph import DeviceGraph
    from repro_torch.core.matcher import _init_roots, match_block
    from repro_torch.core.mis import bitmap_words, mis_greedy_update
    from repro_torch.core.plan import make_plan, stack_plans
    from repro_torch.core.planner import root_block_order
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
    for pats in (k2[:P], bucket3):
        worst["frontier_expand"] = max(worst["frontier_expand"],
                                       frontier_case(g, pats, cfg, dev, first))
    _log(f"kernels: frontier_expand == plain on mico blocks (P={P}, k=2, 3, "
         f"cap={cfg.cap}, chunk={cfg.chunk}, max_chunks={cfg.max_chunks})")

    # timing at the main path's shapes: level 2 of the k = 3 bucket
    plans = stack_plans([make_plan(p, g) for p in bucket3], dev)
    emb0, cnt0 = _init_roots(dev_g, plans, first, cfg)
    emb1, cnt1, *_ = frontier_expand_ref(dev_g, plans, emb0, cnt0, 1, cfg)
    lanes, bisect_steps = frontier_work(dev_g, plans, emb1, cnt1, 2, cfg)
    fe_ms = _time_ms(lambda: frontier_expand_level(dev_g, plans, emb1, cnt1,
                                                   2, cfg), reps=10)
    fe_plain_ms = _time_ms(lambda: frontier_expand_ref(dev_g, plans, emb1,
                                                       cnt1, 2, cfg), reps=2)
    n, P_, cap, k = g.n, emb1.shape[0], cfg.cap, 3
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
    rows = mis_rows_scanned(emb, n_valid, tau, 3)
    mis_bytes = 2 * P_ * Nw * 4 + rows * 3 * 4 + 5 * P_ * 4
    mis_ops = 4 * 3 * rows
    mis_bound = max(mis_bytes / HBM_BYTES_S, mis_ops / INT32_OPS_S) * 1e3
    mis_by = "bytes" if mis_bytes / HBM_BYTES_S >= mis_ops / INT32_OPS_S \
        else "operations"
    _log(f"kernels: shapes P={P_} cap={cap} k=3 n={n} live_lanes={lanes} "
         f"bisect_steps={bisect_steps} "
         f"mis_rows={rows}")
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
    OUT.mkdir(parents=True, exist_ok=True)
    phase_golden(OUT)
    launches = phase_main(OUT, args.mico_sigma)
    kernels = phase_kernels(dev, launches, worst, args.mico_sigma)
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
