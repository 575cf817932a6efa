"""Survey complete mIS supports of a dataset's k = 2 and k = 3 candidates.

    PYTHONPATH=src python scripts/torch_support_survey.py --dataset mico \\
        --scale 1.0 --lam 0.4 560 566 573

Runs the port (``repro_torch``) on the card by default.  Evaluates every
k = 2 edge pattern with τ early exit off, generates the k = 3 candidates of
the k = 2 patterns frequent at the smallest σ given, evaluates those
completely too, and prints, for each σ, how many patterns of each size
would be frequent at the λ given.  This is how the full-size smoke run's σ
and λ were chosen (``chip_smoke.py``, PERF.md).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.core import MatchConfig
from repro_torch.core.batched import evaluate_level_batched
from repro_torch.core.canonical import canonical_key
from repro_torch.core.flexis import initial_candidates, tau_threshold
from repro_torch.core.generation import generate_new_patterns
from repro_torch.core.graph import DeviceGraph
from repro_torch.core.planner import root_block_order
from repro_torch.data.synthetic import PAPER_DATASETS, paper_dataset
from repro_torch.device import resolve_device

NO_TAU = 2**31 - 1


def complete_supports(g, dev_g, cfg, order, patterns) -> np.ndarray:
    t0 = time.monotonic()
    out, _, tel = evaluate_level_batched(
        g, dev_g, patterns, [NO_TAU] * len(patterns), "mis", cfg,
        complete=True, block_order=order)
    sup = np.array([o.support for o in out], np.int64)
    print(f"  {len(patterns)} patterns in {time.monotonic() - t0:.1f} s, "
          f"{tel.dispatches} steps, max_count {tel.max_count}, "
          f"overflowed {tel.overflowed}")
    if sup.size:
        print(f"  support quantiles 0/.5/.9/.99/1: "
              f"{np.quantile(sup, [0, .5, .9, .99, 1]).tolist()}")
    return sup


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="mico", choices=sorted(PAPER_DATASETS))
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--lam", type=float, default=0.4)
    ap.add_argument("--cap", type=int, default=16384)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("sigmas", type=int, nargs="+")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = paper_dataset(args.dataset, scale=args.scale)
    cfg = MatchConfig.for_graph(g, cap=args.cap)
    print(f"{args.dataset}×{args.scale}: |V|={g.n} |E|={g.n_edges} "
          f"max degree {g.max_out_degree}; {cfg}")
    dev_g = DeviceGraph.from_host(g, dev)
    order = root_block_order(g, cfg.root_block)

    k2 = initial_candidates(g)
    print("k = 2:")
    sup2 = complete_supports(g, dev_g, cfg, order, k2)
    tau2 = tau_threshold(min(args.sigmas), args.lam, 2)
    k3 = generate_new_patterns([p for p, s in zip(k2, sup2) if s >= tau2])
    print(f"k = 3 (candidates of the k = 2 patterns frequent at σ = "
          f"{min(args.sigmas)}):")
    sup3 = complete_supports(g, dev_g, cfg, order, k3)
    keys3 = [canonical_key(p) for p in k3]
    for sigma in sorted(args.sigmas, reverse=True):
        t2 = tau_threshold(sigma, args.lam, 2)
        t3 = tau_threshold(sigma, args.lam, 3)
        freq2 = [p for p, s in zip(k2, sup2) if s >= t2]
        cand3 = {canonical_key(p) for p in generate_new_patterns(freq2)}
        freq3 = sum(1 for key, s in zip(keys3, sup3) if key in cand3 and s >= t3)
        print(f"σ={sigma} λ={args.lam}: τ2={t2} frequent k=2: {len(freq2)}; "
              f"k=3 candidates: {len(cand3)}, τ3={t3}, frequent k=3: {freq3}")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
