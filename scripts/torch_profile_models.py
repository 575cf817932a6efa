"""Where one DLRM and one GraphSAGE forward's time goes, on the card.

    PYTHONPATH=src python scripts/torch_profile_models.py [--seed 0] \\
        [--graph-edges N] [--top 15] [--trace-dir DIR]

Builds dlrm-rm2 at full width (26 tables of 1 000 000 × 64, random from
``--seed``) and graphsage-reddit's minibatch_lg block 0 (the R-MAT stand-in
graph with ``--graph-edges`` directed edges requested, Reddit's 114 615 892
by default; the port's sampler; features and labels from ``--seed``), as
``chip_smoke.py`` does, warms each forward up once, then profiles with
``torch.profiler`` (CPU + CUDA activities), separately:

  * one serve_bulk forward (batch 262 144: ``serve_step``, sigmoid of the
    logits);
  * one minibatch_lg forward loss (``sage_loss`` on the block).

For each it prints the wall time, the device time by kernel name
(``key_averages``), the sum of all kernel time, the device busy share =
kernel time / wall time (one stream, so kernels do not overlap) and the
number of kernel launches; then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.registry import get_arch
from repro_torch.data.sampler import block_graph_batch


def _report(name: str, prof, wall: float, top: int) -> None:
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:   # kernels and copies only
            continue
        if ev.self_device_time_total > 0:
            rows.append((ev.self_device_time_total, ev.count, ev.key))
    rows.sort(reverse=True)
    total_us = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    print(f"{name}: wall {wall * 1e3:.3f} ms, device time "
          f"{total_us / 1e3:.3f} ms in {launches} kernels, busy share "
          f"{total_us / 1e6 / wall:.3f}")
    for dev_us, count, key in rows[:top]:
        print(f"  {dev_us / 1e3:9.3f} ms  {count:6d}x  {key[:100]}")


def _profile(name: str, fn, top: int, trace_dir) -> None:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(name, prof, wall, top)
    if trace_dir:
        Path(trace_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(trace_dir) / f"{name}.json"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--graph-edges", type=int, default=None,
                    help="directed edges requested for the GNN graph "
                         "(default: the shape's, Reddit's)")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace-dir", default=None,
                    help="write each forward's chrome trace here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")

    recsys = get_arch("dlrm-rm2")
    model = recsys.init(torch.Generator(device=dev).manual_seed(args.seed),
                        device=dev)
    x = recsys.inputs("serve_bulk", seed=args.seed, device=dev)
    step = recsys.step_fn("serve_bulk")
    _profile("dlrm-rm2 serve_bulk forward",
             lambda: step(model, x["dense"], x["sparse_idx"]), args.top,
             args.trace_dir)
    del model, x
    torch.cuda.empty_cache()

    gnn = get_arch("graphsage-reddit")
    shape = "minibatch_lg"
    t0 = time.perf_counter()
    g = gnn.graph(shape, seed=args.seed, n_edges=args.graph_edges)
    blk = gnn.sampler(g, shape, seed=args.seed).sample(0)
    feats, labels = gnn.node_data(shape, g.n, seed=args.seed, device=dev)
    gb = block_graph_batch(blk, feats, labels)
    print(f"graph {g.n} vertices, {g.n_edges} directed edges; block 0: "
          f"{blk.n_real_nodes} real nodes, {blk.n_real_edges} real edges; "
          f"built and sampled in {time.perf_counter() - t0:.1f} s")
    sage = gnn.init(shape, torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    loss_fn = gnn.loss_fn(shape)
    _profile("graphsage-reddit minibatch_lg forward",
             lambda: loss_fn(sage, gb), args.top, args.trace_dir)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
