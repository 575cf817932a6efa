"""Where one train step's time goes, on the card, for each family.

    PYTHONPATH=src python scripts/torch_profile_train.py [--seed 0] \\
        [--lm-layers 28] [--top 12] [--trace-dir DIR] [--only lm dlrm gnn] \\
        [--arch graphsage-reddit schnet nequip graphcast] \\
        [--shape minibatch_lg|full_graph_sm|molecule] [--layers N]

Builds, as ``chip_smoke.py``'s training phases do, each model with f32
masters (``train=True``) and its AdamW state, warms its train step up
twice, then profiles one step with ``torch.profiler`` (CPU + CUDA
activities):

  * lm: qwen3-1.7b at full width (``--lm-layers`` of its 28), batch 4 ×
    1 024 tokens of the Zipf stream;
  * dlrm: dlrm-rm2 at full width, one train_batch of 65 536;
  * gnn: each ``--arch`` (default graphsage-reddit) at ``--shape``
    (default minibatch_lg: block 0 of the sampler on the Reddit-sized
    R-MAT stand-in, built once for all the archs, positions from the
    seed; full_graph_sm and molecule: the arch's ``inputs``), at full
    width, ``--layers`` cutting graphcast's depth.

For each it prints the step's wall time, the device time by kernel
(``key_averages``), the device time of each port kernel (summed over its
source's kernels, ``kernels._build.kernel_source``), of cuBLAS / CUTLASS
products, of indexing (``index_add_`` and the other scatters, gathers and
their backward) and of everything else (glue), the busy share (kernel
time / wall; one stream) and the number of launches; then the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.gnn_arch import PORTED_SHAPES
from repro_torch.configs.registry import get_arch, list_archs
from repro_torch.data.sampler import block_graph_batch
from repro_torch.data.synthetic import token_stream
from repro_torch.kernels._build import kernel_source
from repro_torch.models.gnn.graphcast import graphcast_init
from repro_torch.train.step import init_opt_state

GEMM_WORDS = ("gemm", "gemv", "cutlass", "xmma", "sm90_", "cublas",
              "nvjet")
INDEX_WORDS = ("index", "scatter", "gather")


def _report(name: str, prof, wall: float, top: int) -> None:
    rows = []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            rows.append((ev.self_device_time_total, ev.count, ev.key))
    rows.sort(reverse=True)
    total_us = sum(r[0] for r in rows)
    groups = {}
    for us, count, key in rows:
        src = kernel_source(key)
        if src is None:
            low = key.lower()
            if any(w in low for w in GEMM_WORDS):
                src = "cuBLAS/CUTLASS products"
            elif any(w in low for w in INDEX_WORDS):
                src = "indexing (index_add_, scatters, gathers)"
            else:
                src = "other (glue)"
        t, c = groups.get(src, (0.0, 0))
        groups[src] = (t + us, c + count)
    print(f"{name}: wall {wall * 1e3:.3f} ms, device time "
          f"{total_us / 1e3:.3f} ms in {sum(r[1] for r in rows)} kernels, "
          f"busy share {total_us / 1e6 / wall:.3f}")
    for src, (us, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  group {src}: {us / 1e3:.3f} ms in {count} launches "
              f"({us / max(total_us, 1e-9):.3f} of device time)")
    for us, count, key in rows[:top]:
        print(f"  {us / 1e3:9.3f} ms  {count:6d}x  {key[:100]}")


def _profile(name: str, fn, top: int, trace_dir) -> None:
    for _ in range(2):
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


def profile_lm(dev, args) -> None:
    from repro_torch.configs import qwen3_1_7b

    arch = dataclasses.replace(qwen3_1_7b.ARCH, cfg=dataclasses.replace(
        qwen3_1_7b.CONFIG, n_layers=args.lm_layers))
    model = arch.init(torch.Generator(device=dev).manual_seed(args.seed),
                      device=dev, train=True)
    state = init_opt_state(model)
    tokens, targets = (torch.as_tensor(a).to(dev) for a in next(
        token_stream(arch.cfg.vocab, 4, 1024, seed=args.seed)))
    step = arch.step_fn("train_4k")
    _profile(f"qwen3-1.7b ({args.lm_layers} layers) train step, batch 4 x "
             f"1024", lambda: step(model, state, tokens, targets), args.top,
             args.trace_dir)
    del model, state
    torch.cuda.empty_cache()


def profile_dlrm(dev, args) -> None:
    arch = get_arch("dlrm-rm2")
    model = arch.init(torch.Generator(device=dev).manual_seed(args.seed),
                      device=dev, train=True)
    state = init_opt_state(model)
    x = arch.inputs("train_batch", seed=args.seed, device=dev)
    step = arch.step_fn("train_batch")
    _profile("dlrm-rm2 train_batch step (65 536)",
             lambda: step(model, state, x["dense"], x["sparse_idx"],
                          x["labels"]), args.top, args.trace_dir)
    del model, state
    torch.cuda.empty_cache()


def profile_gnn(dev, args) -> None:
    shape = args.shape
    block = None
    if shape == "minibatch_lg":
        sage = get_arch("graphsage-reddit")
        t0 = time.perf_counter()
        g = sage.graph(shape, seed=args.seed)
        blk = sage.sampler(g, shape, seed=args.seed).sample(0)
        feats, labels = sage.node_data(shape, g.n, seed=args.seed,
                                       device=dev)
        pos = sage.node_pos(g.n, seed=args.seed, device=dev)
        block = (blk, feats, labels, pos)
        print(f"graph {g.n} vertices, {g.n_edges} directed edges; block 0 "
              f"built and sampled in {time.perf_counter() - t0:.1f} s")
    for name in args.arch:
        arch = get_arch(name)
        if block is None:
            gb = arch.inputs(shape, seed=args.seed, device=dev)
        else:
            blk, feats, labels, pos = block
            gb = block_graph_batch(blk, feats, labels,
                                   pos if arch.needs_positions else None)
        cfg = arch.config(shape)
        gen = torch.Generator(device=dev).manual_seed(0)
        if args.layers and name == "graphcast":
            cfg = dataclasses.replace(cfg, n_layers=args.layers)
            model = graphcast_init(cfg, gen, device=dev, train=True)
        else:
            model = arch.init(shape, gen, device=dev, train=True)
        state = init_opt_state(model)
        step = arch.step_fn(shape)
        torch.cuda.reset_peak_memory_stats()
        _profile(f"{name} {shape} train step ({cfg})",
                 lambda: step(model, state, gb), args.top, args.trace_dir)
        print(f"  max_memory_allocated {torch.cuda.max_memory_allocated()}")
        del model, state, gb
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lm-layers", type=int, default=28)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace-dir", default=None,
                    help="write each step's chrome trace here")
    ap.add_argument("--only", nargs="*", default=["lm", "dlrm", "gnn"],
                    choices=["lm", "dlrm", "gnn"])
    ap.add_argument("--arch", nargs="+", default=["graphsage-reddit"],
                    choices=list_archs("gnn"), help="gnn: the archs")
    ap.add_argument("--shape", default="minibatch_lg",
                    choices=list(PORTED_SHAPES), help="gnn: the shape")
    ap.add_argument("--layers", type=int, default=0,
                    help="gnn: graphcast's depth (0: the config's)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    for name in args.only:
        {"lm": profile_lm, "dlrm": profile_dlrm, "gnn": profile_gnn}[name](
            dev, args)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
