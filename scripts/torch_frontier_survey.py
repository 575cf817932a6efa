"""Survey how large each matcher level's frontier gets on a dataset.

    PYTHONPATH=src python scripts/torch_frontier_survey.py --dataset mico \\
        --scale 1.0 --sigma 784 --lam 0.0 --root-blocks 4096 1024

Runs the port (``repro_torch``) on the card by default.  Takes the k = 2
candidates of the dataset and the k = 3 candidates of the k = 2 patterns
frequent at σ and λ (as ``mine`` generates them), and expands every bucket
of ``--batch`` of them over every root block, with τ early exit off.  For
each root-block width and each (k, level) it prints the largest ``found``
of any (pattern, block), which is the frontier capacity ``--cap`` that
level needs to never overflow, and how many (pattern, block) pairs would
overflow at a few capacities.  ``found`` of a level is exact only while
every earlier level stayed within ``--cap``; the survey says when one did
not.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from repro_torch.core import MatchConfig, MiningConfig, mine
from repro_torch.core.flexis import initial_candidates
from repro_torch.core.generation import generate_new_patterns
from repro_torch.core.graph import DeviceGraph
from repro_torch.core.matcher import _expand_level, _init_roots
from repro_torch.core.plan import make_plan, stack_plans
from repro_torch.core.planner import root_block_order
from repro_torch.data.synthetic import PAPER_DATASETS, paper_dataset
from repro_torch.device import resolve_device

CAPS = (16384, 65536, 262144, 1048576)


def survey(g, dev_g, cfg, patterns, batch):
    """(k - 1, n_pairs) int64 uncapped found per level, and whether an
    earlier level overflowed ``cfg.cap`` anywhere."""
    order = root_block_order(g, cfg.root_block)
    per_level, truncated = [], False
    for lo in range(0, len(patterns), batch):
        plans = stack_plans([make_plan(p, g) for p in patterns[lo:lo + batch]],
                            dev_g.device)
        for b in order:
            emb, count = _init_roots(dev_g, plans, int(b) * cfg.root_block, cfg)
            row = []
            for level in range(1, plans.k):
                emb, count, found, _ = _expand_level(dev_g, plans, emb, count,
                                                     level, cfg)
                row.append(found)
            per_level.append(torch.stack(row))
    found = torch.cat(per_level, 1).long().cpu().numpy()
    if found.shape[0] > 1:
        truncated = bool((found[:-1] > cfg.cap).any())
    return found, truncated


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="mico", choices=sorted(PAPER_DATASETS))
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--sigma", type=int, default=784)
    ap.add_argument("--lam", type=float, default=0.0)
    ap.add_argument("--cap", type=int, default=16384)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--root-blocks", type=int, nargs="+", default=[4096])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = paper_dataset(args.dataset, scale=args.scale)
    base = MatchConfig.for_graph(g, cap=args.cap)
    print(f"{args.dataset}×{args.scale}: |V|={g.n} |E|={g.n_edges} "
          f"max degree {g.max_out_degree}; {base}")
    dev_g = DeviceGraph.from_host(g, dev)
    k2 = initial_candidates(g)
    res = mine(g, MiningConfig(sigma=args.sigma, lam=args.lam,
                               max_pattern_size=2, match=base), device=dev)
    k3 = generate_new_patterns([p for p, _ in res.frequent])
    print(f"σ={args.sigma} λ={args.lam}: {len(k2)} k=2 candidates, "
          f"{len(res.frequent)} frequent, {len(k3)} k=3 candidates")
    for rb in args.root_blocks:
        # single-phase, as the kernel runs: the two-phase pipeline stops
        # counting a chunk's lanes at the cap
        cfg = dataclasses.replace(base, root_block=rb, two_phase=False)
        for k, pats in ((2, k2), (3, k3)):
            t0 = time.monotonic()
            found, truncated = survey(g, dev_g, cfg, pats, args.batch)
            for lvl in range(found.shape[0]):
                f = found[lvl]
                over = ", ".join(f"{int((f > c).sum())} > {c}" for c in CAPS)
                print(f"root_block={rb} k={k} level={lvl + 1}: "
                      f"max found {int(f.max())}, (pattern, block) pairs "
                      f"{f.size}: {over}")
            print(f"root_block={rb} k={k}: {time.monotonic() - t0:.1f} s"
                  f"{'; an earlier level overflowed --cap, later found is a lower bound' if truncated else ''}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
