"""Fit the planner's cost model on the card.

    PYTHONPATH=src python -m repro_torch.launch.calibrate \\
        [--out planner_calibration_torch.json] [--iters 20] [--device cuda]

The port's counterpart of the reference's ``benchmarks/calibrate.py``: it
times the port's batched block step (`core.batched._step_fn`) at the same
controlled geometries and fits the same `core.planner.CostModel` constants,

    t = dispatch_overhead_s + lanes·lane_time_s + cap·row_time_s

  * ``lane_time_s`` — same cap, chunk 4 vs 64 (``max_chunks`` pinned to 1):
    only the lane count moves;
  * ``row_time_s`` — same chunk, cap 512 vs 4096, the lane term subtracted;
  * ``dispatch_overhead_s`` — the small geometry minus both work terms: the
    step's launches, its host read-back and the host loop's work;
  * ``vmap_factor`` — the reference fits it on JAX's vmapped step; on the
    card a bucket of P patterns is one stacked launch per level, so here it
    is the per-pattern time of a stacked bucket of 4 over 4× the
    one-pattern work, at the wide geometry (≥ 1);
  * ``row_time_{mni,frac,luby}_s`` — the cap pair re-timed per metric.

Each timed call is what `_mine_group` does per block: the step, then the
host read of its per-pattern results (which synchronises with the card);
a probe's time is the median of ``--iters`` such calls.
The file keeps any ``escalation_fraction`` a sampled run has folded in.  It
is the port's own file (`core.planner.DEFAULT_CALIBRATION_FILE`), never the
reference's.  Runs on the card unless ``--device cpu`` is asked for, and
records the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.core import MatchConfig, build_graph, initial_candidates
from repro_torch.core.batched import _state_init, _step_fn
from repro_torch.core.graph import DeviceGraph
from repro_torch.core.plan import make_plan, stack_plans
from repro_torch.core.planner import (
    CALIBRATION_SCHEMA, DEFAULT_CALIBRATION_FILE,
)
from repro_torch.device import resolve_device


def card_name(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or the device."""
    if device.type != "cuda":
        return str(device)
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def fit_cost_model(device, iters: int = 20) -> dict:
    """Time the step on ``device`` and return a CostModel dict (schema 3)."""
    rng = np.random.default_rng(0)
    n, deg = 4096, 3
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, n * deg)
    g = build_graph(n, np.stack([src, dst], 1), rng.integers(0, 4, n),
                    undirected=True)
    dev_g = DeviceGraph.from_host(g, device)
    plans = [make_plan(p, g) for p in initial_candidates(g)[:4]]
    k = plans[0].k

    def step_time(cap: int, chunk: int, bucket: int,
                  metric: str = "mis") -> float:
        # max_chunks pinned to 1 so lanes == cap·chunk exactly (a timing
        # probe: truncated candidate enumeration is fine here)
        cfg = dataclasses.replace(
            MatchConfig.for_graph(g, cap=cap, root_block=1024),
            chunk=chunk, max_chunks=1, two_phase=False)
        step = _step_fn(metric, k, cfg)
        stacked = stack_plans([plans[i % len(plans)] for i in range(bucket)],
                              device)
        state = _state_init(metric, bucket, k, n, device)
        taus = torch.full((bucket,), 10**9, dtype=torch.int32, device=device)

        def call():
            out = step(dev_g, stacked, 0, state, taus)
            torch.stack([out[2], out[3].to(torch.int32), out[4]]).cpu()
            out[1].cpu()

        call()                                    # warm-up (and build)
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            call()                                # ends in a host read
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    CAP_S, CAP_B, CH_S, CH_B = 512, 4096, 4, 64
    t_ss = step_time(CAP_S, CH_S, 1)      # small cap, small chunk
    t_sb = step_time(CAP_S, CH_B, 1)      # small cap, big chunk
    t_bs = step_time(CAP_B, CH_S, 1)      # big cap, small chunk

    # lanes = (k-1)·cap·chunk with max_chunks == 1
    lane_time = max((t_sb - t_ss) / ((k - 1) * CAP_S * (CH_B - CH_S)),
                    1e-12)
    row_time = max(
        (t_bs - t_ss - (k - 1) * (CAP_B - CAP_S) * CH_S * lane_time)
        / (CAP_B - CAP_S), 1e-12)
    overhead = max(
        t_ss - (k - 1) * CAP_S * CH_S * lane_time - CAP_S * row_time, 1e-6)

    # the stacked-bucket factor, where the lane term dominates
    work_bb = (k - 1) * CAP_B * CH_B * lane_time + CAP_B * row_time
    t_stack4 = step_time(CAP_B, CH_B, 4)
    vmap_factor = max(1.0, (t_stack4 - overhead) / (4 * work_bb))

    lane_delta = (k - 1) * (CAP_B - CAP_S) * CH_S * lane_time
    metric_rows, metric_probe = {}, {}
    for metric, key in (("mni", "row_time_mni_s"),
                        ("frac", "row_time_frac_s"),
                        ("mis_luby", "row_time_luby_s")):
        t_s_m = step_time(CAP_S, CH_S, 1, metric)
        t_b_m = step_time(CAP_B, CH_S, 1, metric)
        metric_rows[key] = float(
            max((t_b_m - t_s_m - lane_delta) / (CAP_B - CAP_S), 1e-12))
        metric_probe[f"t_cap4096_ch4_{metric}"] = t_b_m

    return {
        "schema": CALIBRATION_SCHEMA,
        "dispatch_overhead_s": float(overhead),
        "lane_time_s": float(lane_time),
        "row_time_s": float(row_time),
        **metric_rows,
        "escalation_fraction": None,
        "vmap_factor": float(round(vmap_factor, 3)),
        "backend": card_name(device),
        "source": "repro_torch.launch.calibrate",
        "probe": {
            "n": n, "k": k, "iters": iters,
            "t_cap512_ch4": t_ss, "t_cap512_ch64": t_sb,
            "t_cap4096_ch4": t_bs, "t_cap4096_ch64_stack4": t_stack4,
            **metric_probe,
        },
        "_model": "t_step = dispatch_overhead_s + bucket * ((k-1)*cap*chunk"
                  "*max_chunks*lane_time_s + cap*row_time_s)"
                  " * (vmap_factor if bucket>1)",
    }


def write_calibration(out: str, device, iters: int = 20) -> dict:
    model = fit_cost_model(device, iters=iters)
    try:
        # a re-fit must not discard the escalation fraction sampled runs
        # folded in
        with open(out) as f:
            prev = json.load(f).get("escalation_fraction")
        if isinstance(prev, (int, float)):
            model["escalation_fraction"] = float(prev)
    except (OSError, ValueError):
        pass
    with open(out, "w") as f:
        json.dump(model, f, indent=2, sort_keys=True)
        f.write("\n")
    return model


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_CALIBRATION_FILE)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    model = write_calibration(args.out, resolve_device(args.device),
                              iters=args.iters)
    print(f"[calibrate] {model['backend']} → {args.out}: "
          f"overhead={model['dispatch_overhead_s'] * 1e6:.1f}us "
          f"lane={model['lane_time_s'] * 1e9:.4f}ns "
          f"row={model['row_time_s'] * 1e9:.3f}ns "
          f"(mni {model['row_time_mni_s'] * 1e9:.3f} / "
          f"frac {model['row_time_frac_s'] * 1e9:.3f} / "
          f"luby {model['row_time_luby_s'] * 1e9:.3f}) "
          f"vmap_factor={model['vmap_factor']:.3f}")
    print(json.dumps(model, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
