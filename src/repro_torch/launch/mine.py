"""FLEXIS mining launcher on PyTorch — the paper's end-to-end run.

    PYTHONPATH=src python -m repro_torch.launch.mine --dataset gnutella \\
        --scale 0.05 --sigma 30 --lam 0.4 --metric mis [--device cpu]

Synthesizes a dataset, mines frequent subgraphs with the configured
metric/generation strategy and prints the paper's telemetry (per-level
counts, searched patterns, memory, time).  Runs on the card by default
(``--device cuda``), where every expansion level and every greedy-mIS update
is a hand-written CUDA kernel; ``--device cpu`` runs the plain torch
versions instead (the torch expansion pipeline, two-phase as
``MatchConfig.for_graph`` sets it).  The device alone picks the path.
``--execution auto`` (the default) lets the planner choose each level's
plane and geometry from the port's calibration (``--calibration``, else
``$REPRO_TORCH_PLANNER_CALIBRATION``, else
``./planner_calibration_torch.json``, else the built-in H100 fit); a run
with sampled levels folds its measured escalation fraction into that file.
``--json`` writes the reference launcher's schema.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from repro_torch.core import MatchConfig, MiningConfig, mine
from repro_torch.core.flexis import tau_threshold
from repro_torch.core.planner import persist_escalation_fraction
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
    ap.add_argument("--execution", default="auto",
                    choices=["auto", "batched", "sequential", "sampled"],
                    help="data plane: the cost-model planner picks per level "
                         "(auto, default; decisions recorded in per_level "
                         "and --json), one batched step per same-k "
                         "candidate group and root block (batched), the "
                         "paper's per-pattern loop (sequential oracle), or "
                         "a weighted root-block sample with exact "
                         "escalation (sampled; a pattern is pruned only "
                         "when its confidence interval lies below tau, "
                         "every other support is exact — see "
                         "--sample-fraction/--confidence)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to mine: the card with the CUDA kernels "
                         "(default) or the CPU with their plain versions")
    ap.add_argument("--sample-fraction", type=float, default=0.25,
                    help="sampled plane: target fraction of root blocks "
                         "drawn per level (1.0 degenerates to the exact "
                         "batched plane)")
    ap.add_argument("--confidence", type=float, default=0.95,
                    help="sampled plane: nominal CI level of the support "
                         "estimator — patterns whose interval reaches tau "
                         "escalate to the exact plane")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="sampled plane: RNG key root of the per-level "
                         "block draws")
    ap.add_argument("--sample-rounds", type=int, default=3,
                    help="sampled plane: max adaptive draw rounds per level "
                         "(1 = the single --sample-fraction draw)")
    ap.add_argument("--root-order", default="degree",
                    choices=["degree", "vertex"],
                    help="root-block schedule: highest max-out-degree "
                         "blocks first (degree, default) or vertex-id order")
    ap.add_argument("--calibration", default=None,
                    help="planner calibration JSON (repro_torch.launch."
                         "calibrate); default: "
                         "$REPRO_TORCH_PLANNER_CALIBRATION, then "
                         "./planner_calibration_torch.json, then the "
                         "built-in H100 fit")
    ap.add_argument("--root-block", type=int, default=None,
                    help="root-block width override (default: sized by "
                         "MatchConfig.for_graph).  The sampled plane draws "
                         "root blocks: a graph one block covers has "
                         "nothing to sample")
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
    res = mine(g, cfg, device=device, calibration=args.calibration)

    print(f"[mine] done in {res.elapsed_s:.2f}s on {device}"
          f"{' (TIMED OUT)' if res.timed_out else ''}")
    print(f"[mine] frequent patterns: {len(res.frequent)}  "
          f"searched: {res.searched}  peak device bytes: "
          f"{res.peak_device_bytes / 2**20:.1f} MiB")
    if res.health.degraded:
        print(f"[mine] health: {res.health.to_dict()['counts']} — results "
              f"are exact; see --json health.events for detail")
    for lvl, st in res.per_level.items():
        pretty = {k: (round(v, 3) if isinstance(v, float) else v)
                  for k, v in st.items()
                  if k != "block_peaks"}  # long per-block list; JSON only
        print(f"[mine]   level {lvl}: {pretty}")
    for pat, sup in res.frequent[:10]:
        tau = tau_threshold(args.sigma, args.lam, pat.k)
        print(f"[mine]   k={pat.k} sup={sup} (tau={tau}) "
              f"labels={pat.labels.tolist()} edges={pat.edges()}")
    if len(res.frequent) > 10:
        print(f"[mine]   … and {len(res.frequent) - 10} more")

    # warm-start future pricing: fold the measured escalation fraction of
    # this run's sampled levels into the calibration file (schema 3)
    samp = [v["sampled"] for v in res.per_level.values()
            if isinstance(v.get("sampled"), dict)
            and not v["sampled"].get("exact", False)]
    decided = sum(int(d.get("escalated", 0)) + int(d.get("pruned", 0))
                  for d in samp)
    if decided > 0 and not res.timed_out:
        measured = sum(int(d.get("escalated", 0)) for d in samp) / decided
        where = persist_escalation_fraction(measured, path=args.calibration)
        if where:
            print(f"[mine] calibration: measured escalation fraction "
                  f"{measured:.3f} folded into {where}")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(result_json(args, res), f, indent=2, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
