"""FLEXIS mining launcher on PyTorch — the paper's end-to-end run.

    PYTHONPATH=src python -m repro_torch.launch.mine --dataset gnutella \\
        --scale 0.05 --sigma 30 --lam 0.4 --metric mis [--device cpu]

Synthesizes a dataset, mines frequent subgraphs with the configured
metric/generation strategy and prints the paper's telemetry (per-level
counts, searched patterns, memory, time).  Runs on the card by default
(``--device cuda``), where every expansion level and every greedy-mIS update
is a hand-written CUDA kernel; ``--device cpu`` runs the plain torch
versions instead (the torch expansion pipeline, two-phase as
``MatchConfig.for_graph`` sets it).  The device alone picks the path.  ``--json`` writes the reference
launcher's schema.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from repro_torch.core import MatchConfig, MiningConfig, mine
from repro_torch.core.flexis import tau_threshold
from repro_torch.data.synthetic import PAPER_DATASETS, paper_dataset
from repro_torch.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="gnutella",
                    choices=sorted(PAPER_DATASETS))
    ap.add_argument("--scale", type=float, default=0.05,
                    help="dataset size multiplier (1.0 = paper size)")
    ap.add_argument("--sigma", type=int, default=20)
    ap.add_argument("--lam", type=float, default=0.4)
    ap.add_argument("--metric", default="mis",
                    choices=["mis", "mis_luby", "mni", "frac"])
    ap.add_argument("--generation", default="merge",
                    choices=["merge", "edge_ext"])
    ap.add_argument("--execution", default="batched",
                    choices=["batched", "sequential"],
                    help="data plane: one batched step per same-k candidate "
                         "group and root block (batched, default), or the "
                         "paper's per-pattern loop (sequential oracle)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to mine: the card with the CUDA kernels "
                         "(default) or the CPU with their plain versions")
    ap.add_argument("--sample-fraction", type=float, default=0.25,
                    help="sampled-plane knob, validated as the reference does "
                         "(the sampled plane is not ported yet)")
    ap.add_argument("--confidence", type=float, default=0.95,
                    help="sampled-plane knob (see --sample-fraction)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="sampled-plane knob (see --sample-fraction)")
    ap.add_argument("--sample-rounds", type=int, default=3,
                    help="sampled-plane knob (see --sample-fraction)")
    ap.add_argument("--root-order", default="degree",
                    choices=["degree", "vertex"],
                    help="root-block schedule: highest max-out-degree "
                         "blocks first (degree, default) or vertex-id order")
    ap.add_argument("--root-block", type=int, default=None,
                    help="root-block width override (default: sized by "
                         "MatchConfig.for_graph)")
    ap.add_argument("--max-size", type=int, default=4)
    ap.add_argument("--time-limit", type=float, default=1800.0,
                    help="paper uses a 30-minute timeout")
    ap.add_argument("--cap", type=int, default=16384)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, help="write result JSON here")
    return ap


def result_json(args, res) -> dict:
    """The reference launcher's ``--json`` document for one run."""
    return {
        "dataset": args.dataset, "scale": args.scale,
        "sigma": args.sigma, "lam": args.lam, "metric": args.metric,
        "generation": args.generation, "execution": args.execution,
        "elapsed_s": res.elapsed_s, "timed_out": res.timed_out,
        "n_frequent": len(res.frequent), "searched": res.searched,
        "peak_device_bytes": res.peak_device_bytes,
        "dispatches": sum(int(v.get("dispatches", 0))
                          for v in res.per_level.values()),
        "escalated": sum(int(v.get("sampled", {}).get("escalated", 0))
                         for v in res.per_level.values()),
        "estimated_patterns": sum(1 for st in res.stats if st.estimated),
        "health": res.health.to_dict(),
        "per_level": {str(k): v for k, v in res.per_level.items()},
        "frequent": [[p.k, int(s)] for p, s in res.frequent],
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    t0 = time.monotonic()
    g = paper_dataset(args.dataset, scale=args.scale, seed=args.seed)
    print(f"[mine] {args.dataset}×{args.scale}: |V|={g.n} |E|={g.n_edges} "
          f"labels={g.n_labels} (load {time.monotonic() - t0:.1f}s)")

    cfg = MiningConfig(
        sigma=args.sigma, lam=args.lam, metric=args.metric,
        generation=args.generation, max_pattern_size=args.max_size,
        time_limit_s=args.time_limit, execution=args.execution,
        root_order=args.root_order,
        sample_fraction=args.sample_fraction, confidence=args.confidence,
        sample_seed=args.sample_seed, sample_rounds=args.sample_rounds,
        match=dataclasses.replace(
            MatchConfig.for_graph(g, cap=args.cap),
            **({"root_block": args.root_block}
               if args.root_block is not None else {})),
    )
    res = mine(g, cfg, device=device)

    print(f"[mine] done in {res.elapsed_s:.2f}s on {device}"
          f"{' (TIMED OUT)' if res.timed_out else ''}")
    print(f"[mine] frequent patterns: {len(res.frequent)}  "
          f"searched: {res.searched}  peak device bytes: "
          f"{res.peak_device_bytes / 2**20:.1f} MiB")
    for lvl, st in res.per_level.items():
        pretty = {k: (round(v, 3) if isinstance(v, float) else v)
                  for k, v in st.items()}
        print(f"[mine]   level {lvl}: {pretty}")
    for pat, sup in res.frequent[:10]:
        tau = tau_threshold(args.sigma, args.lam, pat.k)
        print(f"[mine]   k={pat.k} sup={sup} (tau={tau}) "
              f"labels={pat.labels.tolist()} edges={pat.edges()}")
    if len(res.frequent) > 10:
        print(f"[mine]   … and {len(res.frequent) - 10} more")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(result_json(args, res), f, indent=2, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
