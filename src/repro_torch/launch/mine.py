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

``--checkpoint-dir`` makes the run a resumable *session*
(`repro_torch.runtime`): the full mining state is snapshotted at every
level boundary and every ``--checkpoint-every`` root blocks, SIGTERM or
SIGINT stops the run at its next snapshot with exit code 75
(`EXIT_PREEMPTED`), and rerunning the same command line (``--resume``
makes a missing snapshot an error) continues it to the uninterrupted
run's result.

``--execution distributed`` (metric ``mis_luby``, forced) shards each
level's root blocks over the ranks of a ``torch.distributed`` group.  Under
``torchrun`` the CLI reads ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``,
joins the group — NCCL for ``--device cuda`` (rank r on ``cuda:LOCAL_RANK``),
gloo for ``--device cpu``; ``--backend gloo`` also reduces CUDA tensors,
so several ranks can share one card — and leaves it at exit; rank 0 alone
prints, writes ``--json``, the calibration file and the checkpoints.
Without torchrun's environment it mines on a mesh of one::

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.mine \
        --device cpu --execution distributed --dataset gnutella --scale 0.01
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import MatchConfig, MiningConfig, mine
from repro_torch.core.distributed import process_rank
from repro_torch.core.flexis import tau_threshold
from repro_torch.core.planner import persist_escalation_fraction
from repro_torch.data.synthetic import PAPER_DATASETS, paper_dataset
from repro_torch.device import resolve_device

# distinct "preempted, resumable" status: the run was stopped on request
# (SIGTERM/SIGINT) after committing a final snapshot — rerunning the same
# command line resumes it.  75 = BSD EX_TEMPFAIL ("temporary failure,
# retry"), which is exactly the contract.
EXIT_PREEMPTED = 75


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
                    choices=["auto", "batched", "sequential", "distributed",
                             "sampled"],
                    help="data plane: the cost-model planner picks per level "
                         "(auto, default; decisions recorded in per_level "
                         "and --json), one batched step per same-k "
                         "candidate group and root block (batched), the "
                         "paper's per-pattern loop (sequential oracle), "
                         "root blocks sharded over the torchrun ranks "
                         "(distributed; forces metric=mis_luby), or "
                         "a weighted root-block sample with exact "
                         "escalation (sampled; a pattern is pruned only "
                         "when its confidence interval lies below tau, "
                         "every other support is exact — see "
                         "--sample-fraction/--confidence)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to mine: the card with the CUDA kernels "
                         "(default) or the CPU with their plain versions")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "nccl", "gloo"],
                    help="torch.distributed backend under torchrun: nccl "
                         "for --device cuda and gloo for --device cpu "
                         "(auto), or gloo on the card too (several ranks "
                         "on one card)")
    ap.add_argument("--blocks-per-super", type=int, default=None,
                    help="distributed plane: logical super-block width in "
                         "root blocks (default: the world size; sessions "
                         "pin 8) — runs with one width agree field for "
                         "field at any world size but for dispatches")
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
    ap.add_argument("--checkpoint-dir", default=None,
                    help="run as a resumable session: snapshot the full "
                         "mining state into this directory (atomic "
                         "manifest/COMMIT protocol, see repro_torch.runtime)")
    ap.add_argument("--checkpoint-every", type=int, default=1,
                    help="snapshot cadence in carried-state updates (root "
                         "blocks on the batched plane, super-blocks on the "
                         "distributed plane, sample groups on the sampled "
                         "plane); 0 = level boundaries only")
    ap.add_argument("--resume", action="store_true",
                    help="require a committed snapshot in --checkpoint-dir "
                         "and continue it (without this flag a snapshot is "
                         "still picked up when present; --resume makes a "
                         "missing one an error instead of a fresh start)")
    return ap


def _say(*args, **kw) -> None:
    """print on rank 0 (every process without a group)."""
    if process_rank() == 0:
        print(*args, **kw)


def _join_group(args, device: torch.device) -> bool:
    """Join torchrun's process group when its environment is set; False
    without it (a mesh of one)."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    backend = args.backend
    if backend == "auto":
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise SystemExit("--backend nccl needs --device cuda")
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


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


class _Preemption:
    """SIGTERM/SIGINT stop a session run at its next snapshot.

    Installed before the graph is loaded, so a signal that arrives while
    the graph is built or the kernels compile still ends in one committed
    snapshot (the session's first) and exit `EXIT_PREEMPTED` — never in a
    kill mid-write."""

    def __init__(self):
        self.session = None
        self.requested = False
        self._prev: dict = {}

    def __enter__(self) -> "_Preemption":
        self._prev = {s: signal.signal(s, self._on_signal)
                      for s in (signal.SIGTERM, signal.SIGINT)}
        return self

    def __exit__(self, *exc) -> None:
        for s, h in self._prev.items():
            signal.signal(s, h)

    def _on_signal(self, signum, frame) -> None:
        _say(f"[mine] caught signal {signum}: finishing the current "
             f"snapshot, then exiting resumable", flush=True)
        self.requested = True
        if self.session is not None:
            self.session.request_preempt()

    def attach(self, session) -> None:
        self.session = session
        if self.requested:
            session.request_preempt()


def _run_session(args, g, cfg, device, preemption: _Preemption):
    """Mine as a resumable session; None when preempted (snapshot
    committed), else the `MiningResult`."""
    from repro_torch.runtime import MiningSession, PreemptedError
    from repro_torch.train import checkpoint as ckpt

    session = MiningSession(
        g, cfg, args.checkpoint_dir, device=device,
        calibration=args.calibration,
        checkpoint_every=args.checkpoint_every,
        resume="must" if args.resume else "auto",
        meta={"dataset": args.dataset, "scale": args.scale,
              "seed": args.seed})
    preemption.attach(session)
    try:
        res = session.run()
    except PreemptedError as e:
        ckpt.wait_pending(raise_errors=False)  # flush async writes
        _say(f"[mine] preempted: {e}")
        res = None
    _say(f"[mine] session: {session.snapshots_written} snapshots "
         f"written under {args.checkpoint_dir}")
    return res


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume requires --checkpoint-dir")
    device = resolve_device(args.device)
    joined = _join_group(args, device)
    try:
        if args.execution == "distributed" and args.metric != "mis_luby":
            _say(f"[mine] execution=distributed forces metric=mis_luby "
                f"(was {args.metric})")
            args.metric = "mis_luby"
        if not args.checkpoint_dir:
            return _mine(args, device, None)
        with _Preemption() as preemption:
            return _mine(args, device, preemption)
    finally:
        if joined:
            dist.destroy_process_group()


def _mine(args, device, preemption: Optional[_Preemption]) -> int:
    t0 = time.monotonic()
    g = paper_dataset(args.dataset, scale=args.scale, seed=args.seed)
    _say(f"[mine] {args.dataset}×{args.scale}: |V|={g.n} |E|={g.n_edges} "
         f"labels={g.n_labels} (load {time.monotonic() - t0:.1f}s)")

    cfg = MiningConfig(
        sigma=args.sigma, lam=args.lam, metric=args.metric,
        generation=args.generation, max_pattern_size=args.max_size,
        time_limit_s=args.time_limit, execution=args.execution,
        root_order=args.root_order,
        sample_fraction=args.sample_fraction, confidence=args.confidence,
        sample_seed=args.sample_seed, sample_rounds=args.sample_rounds,
        blocks_per_super=args.blocks_per_super,
        match=dataclasses.replace(
            MatchConfig.for_graph(g, cap=args.cap),
            **({"root_block": args.root_block}
               if args.root_block is not None else {})),
    )
    if preemption is not None:
        res = _run_session(args, g, cfg, device, preemption)
        if res is None:
            return EXIT_PREEMPTED
    else:
        res = mine(g, cfg, device=device, calibration=args.calibration)

    _say(f"[mine] done in {res.elapsed_s:.2f}s on {device}"
         f"{' (TIMED OUT)' if res.timed_out else ''}")
    _say(f"[mine] frequent patterns: {len(res.frequent)}  "
         f"searched: {res.searched}  peak device bytes: "
         f"{res.peak_device_bytes / 2**20:.1f} MiB")
    if res.health.degraded:
        _say(f"[mine] health: {res.health.to_dict()['counts']} — results "
             f"are exact; see --json health.events for detail")
    for lvl, st in res.per_level.items():
        pretty = {k: (round(v, 3) if isinstance(v, float) else v)
                  for k, v in st.items()
                  if k != "block_peaks"}  # long per-block list; JSON only
        _say(f"[mine]   level {lvl}: {pretty}")
    for pat, sup in res.frequent[:10]:
        tau = tau_threshold(args.sigma, args.lam, pat.k)
        _say(f"[mine]   k={pat.k} sup={sup} (tau={tau}) "
             f"labels={pat.labels.tolist()} edges={pat.edges()}")
    if len(res.frequent) > 10:
        _say(f"[mine]   … and {len(res.frequent) - 10} more")

    # warm-start future pricing: fold the measured escalation fraction of
    # this run's sampled levels into the calibration file (schema 3)
    samp = [v["sampled"] for v in res.per_level.values()
            if isinstance(v.get("sampled"), dict)
            and not v["sampled"].get("exact", False)]
    decided = sum(int(d.get("escalated", 0)) + int(d.get("pruned", 0))
                  for d in samp)
    if decided > 0 and not res.timed_out and process_rank() == 0:
        measured = sum(int(d.get("escalated", 0)) for d in samp) / decided
        where = persist_escalation_fraction(measured, path=args.calibration)
        if where:
            _say(f"[mine] calibration: measured escalation fraction "
                 f"{measured:.3f} folded into {where}")

    if args.json and process_rank() == 0:
        with open(args.json, "w") as f:
            json.dump(result_json(args, res), f, indent=2, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
