"""Where one mining run's time goes, on the card.

    PYTHONPATH=src python scripts/torch_profile_mine.py --dataset mico \\
        --scale 1.0 --sigma 784 --lam 0.0 --max-size 3 [--cap 131072] \\
        [--execution batched|auto|sampled|distributed] [--metric mis_luby]

Runs ``repro_torch.core.mine`` once to warm up (kernel build, CUDA context),
then once under ``torch.profiler`` (CPU + CUDA activities), and prints:

  * the run's wall time and its per-level ``wall_s``;
  * the host time of the control plane outside the levels (graph upload,
    the initial candidates, candidate generation and canonical dedupe);
  * device time by kernel name (``key_averages``), the sum of all kernel
    time, and the device busy share = kernel time / wall time (one stream,
    so kernels do not overlap);
  * the card's name and power limit.

``--execution distributed`` (metric ``mis_luby``) joins a process group of
one NCCL rank (``tcp://localhost``, a free port) so that the plane's
collectives run, and splits the device time into the frontier kernel, the
collectives (NCCL kernels) and the rest (the Luby rounds' glue: scatter,
gather, compare, scan), beside the host's waits on the card (CPU time in
synchronizing calls: the per-round reads) and the plane's counters
(dispatches, Luby rounds, all_reduce calls and bytes).

``--trace PATH`` also writes the chrome-format trace.  With
``--checkpoint-dir`` the profiled run is a fresh `MiningSession` into that
directory (``--checkpoint-every`` snapshots), so the trace holds the copies
of the metric state to the host and the snapshots' host time.
"""
from __future__ import annotations

import argparse
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import MatchConfig, MiningConfig, mine
from repro_torch.core import distributed as distributed_lib
from repro_torch.core.flexis import initial_candidates
from repro_torch.data.synthetic import PAPER_DATASETS, paper_dataset
from repro_torch.kernels._build import kernel_source
from repro_torch.runtime import MiningSession


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="mico", choices=sorted(PAPER_DATASETS))
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--sigma", type=int, default=784)
    ap.add_argument("--lam", type=float, default=0.0)
    ap.add_argument("--max-size", type=int, default=3)
    ap.add_argument("--cap", type=int, default=131072,
                    help="frontier capacity (131072: no level of the mico "
                         "x1.0 main cell overflows)")
    ap.add_argument("--execution", default="batched",
                    choices=["batched", "auto", "sampled", "distributed"],
                    help="the plane (auto and sampled at the built-in "
                         "calibration and sample fraction; distributed on "
                         "one NCCL rank, metric mis_luby)")
    ap.add_argument("--metric", default="mis", choices=["mis", "mis_luby"])
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace", default=None, help="write the chrome trace here")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="profile a fresh session writing snapshots here")
    ap.add_argument("--checkpoint-every", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())

    if args.execution == "distributed":
        args.metric = "mis_luby"
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1)
    g = paper_dataset(args.dataset, scale=args.scale)
    cfg = MiningConfig(
        sigma=args.sigma, lam=args.lam, metric=args.metric,
        execution=args.execution,
        max_pattern_size=args.max_size,
        match=MatchConfig.for_graph(g, cap=args.cap))
    t0 = time.monotonic()
    initial_candidates(g)
    print(f"initial_candidates: {time.monotonic() - t0:.3f} s (host)")

    mine(g, cfg, device="cuda")                   # warm-up: build, context
    torch.cuda.synchronize()
    distributed_lib.reset_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        if args.checkpoint_dir:
            res = MiningSession(g, cfg, args.checkpoint_dir, device="cuda",
                                checkpoint_every=args.checkpoint_every,
                                resume="never").run()
        else:
            res = mine(g, cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    levels = sum(v["wall_s"] for v in res.per_level.values())
    print(f"run: wall {wall:.3f} s, levels {levels:.3f} s, outside the "
          f"levels {wall - levels:.3f} s; n_frequent {len(res.frequent)}, "
          f"searched {res.searched}")
    for lvl, v in res.per_level.items():
        print(f"  level {lvl}: wall_s {v['wall_s']:.3f}, candidates "
              f"{v['candidates']}, dispatches {v['dispatches']}")

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:   # kernels and copies only
            continue
        dev_us = ev.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    total_us = sum(r[0] for r in rows)
    print(f"device time {total_us / 1e6:.3f} s over {wall:.3f} s wall: busy "
          f"share {total_us / 1e6 / wall:.3f}")
    if args.execution == "distributed":
        frontier = sum(r[0] for r in rows
                       if kernel_source(r[2]) == "frontier_expand")
        nccl = sum(r[0] for r in rows if "nccl" in r[2].lower())
        waits = sum(ev.self_cpu_time_total for ev in prof.key_averages()
                    if ev.device_type == DeviceType.CPU and ev.key in (
                        "cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaMemcpyAsync", "cudaEventSynchronize"))
        c = distributed_lib.COUNTERS
        print(f"distributed: frontier kernel {frontier / 1e6:.3f} s, "
              f"collectives (NCCL kernels) {nccl / 1e6:.3f} s, Luby glue "
              f"and the rest {(total_us - frontier - nccl) / 1e6:.3f} s of "
              f"device time; host waits on the card {waits / 1e6:.3f} s; "
              f"dispatches {c['dispatches']}, Luby rounds "
              f"{c['luby_rounds']}, all_reduce {c['all_reduce']} calls of "
              f"{c['all_reduce_bytes']} bytes")
    for dev_us, count, key in rows[:args.top]:
        print(f"  {dev_us / 1e3:10.1f} ms  {count:7d}x  {key[:90]}")
    # a port kernel may be several CUDA kernels (the frontier's passes):
    # its device time is the sum over its source's kernels
    for src in ("frontier_expand", "mis_bitmap"):
        own = [r for r in rows if kernel_source(r[2]) == src]
        print(f"  by source: {src}.cu {sum(r[0] for r in own) / 1e6:.3f} s "
              f"in {sum(r[1] for r in own)} kernels")
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
