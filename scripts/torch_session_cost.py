"""What checkpointing costs a mining run, on the card.

    PYTHONPATH=src python scripts/torch_session_cost.py --dataset mico \\
        --scale 1.0 --sigma 784 --lam 0.0 --cap 131072 \\
        [--execution auto] [--every 1 0] [--max-s 300] [--live]

Runs ``repro_torch.core.mine`` once to build the kernels and once plain
(the baseline), then once as a `MiningSession` per ``--every`` cadence, each
into a fresh checkpoint directory under ``--out``, and prints for each:
the wall against the plain run, the carried-state updates (the snapshot
points of cadence 1) and the snapshots written, by level and kind, the bytes
of a snapshot on disk (median, max, total), the seconds the mining thread
spent in snapshots and the seconds of the writes themselves
(`testing.session_meter.SnapshotMeter`).  A session still running after
``--max-s`` seconds is asked to stop (`request_preempt`): it commits one
more snapshot and the line says ``preempted``.  ``--live`` prints each
snapshot as it lands.  The planner reads the built-in calibration written
to a file under ``--out``.  The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

from repro_torch.core import MatchConfig, MiningConfig, mine
from repro_torch.core.planner import CostModel
from repro_torch.data.synthetic import PAPER_DATASETS, paper_dataset
from repro_torch.runtime import MiningSession, PreemptedError
from repro_torch.testing.session_meter import SnapshotMeter


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="mico", choices=sorted(PAPER_DATASETS))
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--sigma", type=int, default=784)
    ap.add_argument("--lam", type=float, default=0.0)
    ap.add_argument("--max-size", type=int, default=3)
    ap.add_argument("--cap", type=int, default=131072)
    ap.add_argument("--execution", default="auto",
                    choices=["auto", "batched", "sampled"])
    ap.add_argument("--every", type=int, nargs="+", default=[1, 0],
                    help="checkpoint cadences to measure (0 = level "
                         "boundaries only)")
    ap.add_argument("--max-s", type=float, default=300.0,
                    help="ask a session to stop after this many seconds")
    ap.add_argument("--out", default="build/session_cost")
    ap.add_argument("--live", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)

    out = Path(args.out)
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    cal = out / "calibration.json"
    g = paper_dataset(args.dataset, scale=args.scale)
    cfg = MiningConfig(
        sigma=args.sigma, lam=args.lam, metric="mis",
        execution=args.execution, max_pattern_size=args.max_size,
        match=MatchConfig.for_graph(g, cap=args.cap))

    cal.write_text(json.dumps(CostModel().to_dict()))
    mine(g, cfg, device="cuda", calibration=str(cal))   # warm-up: build
    t0 = time.monotonic()
    plain = mine(g, cfg, device="cuda", calibration=str(cal))
    torch.cuda.synchronize()
    plain_wall = time.monotonic() - t0
    print(f"plain: wall {plain_wall:.3f} s, levels "
          f"{[round(v['wall_s'], 3) for v in plain.per_level.values()]}",
          flush=True)

    rows = []
    for every in args.every:
        cal.write_text(json.dumps(CostModel().to_dict()))
        sess = MiningSession(g, cfg, out / f"every{every}", device="cuda",
                             calibration=str(cal), checkpoint_every=every)
        timer = threading.Timer(args.max_s, sess.request_preempt)
        preempted = False
        with SnapshotMeter(live=args.live) as meter:
            timer.start()
            t0 = time.monotonic()
            try:
                res = sess.run()
            except PreemptedError:
                preempted = True
                res = None
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            timer.cancel()
        same = (res is not None
                and [(p.key(), s) for p, s in res.frequent]
                == [(p.key(), s) for p, s in plain.frequent])
        row = {"every": every, "wall_s": wall, "plain_wall_s": plain_wall,
               "preempted": preempted, "same_frequent": same,
               **meter.summary(),
               "by_level": {lvl: meter.summary(lvl)
                            for lvl in sorted({s["level"]
                                               for s in meter.snapshots})}}
        rows.append(row)
        print(f"every {every}: {json.dumps(row)}", flush=True)
        shutil.rmtree(out / f"every{every}", ignore_errors=True)
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
