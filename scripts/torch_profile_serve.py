"""Where one serving request batch's time goes, on the card.

    PYTHONPATH=src python scripts/torch_profile_serve.py [--arch qwen3-1.7b] \\
        [--layers N] [--batch 4] [--prompt-len 1024] [--decode-steps 8] \\
        [--trace PATH]

Builds the model at full width from ``--seed`` (as ``repro_torch.launch.serve``
does; ``--layers`` cuts its depth, as ``chip_smoke.py`` serves mixtral-8x7b
at 16 of its 32 layers), warms up one prefill and one decode step, then profiles with
``torch.profiler`` (CPU + CUDA activities), separately:

  * one prefill (``transformer_apply`` + the last-position argmax);
  * ``--decode-steps`` decode steps against a cache holding the prompt
    length (filled with zeros: the work per step does not depend on the
    values).

For each it prints the wall time, the device time by kernel name
(``key_averages``), the sum of all kernel time and the device busy share =
kernel time / wall time (one stream, so kernels do not overlap), and the
number of kernel launches; then the card's name and power limit.
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

from repro_torch.configs.registry import get_arch, list_archs
from repro_torch.kernels._build import kernel_source
from repro_torch.launch.serve import make_prompts
from repro_torch.models.transformer import (
    init_decode_cache, transformer_apply, transformer_decode, transformer_init,
)


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
    flash = [r for r in rows if kernel_source(r[2]) == "flash_attention"]
    print(f"  by source: flash_attention.cu {sum(r[0] for r in flash) / 1e3:.3f}"
          f" ms in {sum(r[1] for r in flash)} kernels")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list_archs("lm"))
    ap.add_argument("--layers", type=int, default=None,
                    help="serve the first N layers (default: all)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace", default=None,
                    help="write the prefill's chrome trace here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = get_arch(args.arch).cfg
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = transformer_init(cfg, torch.Generator(device=dev)
                             .manual_seed(args.seed), device=dev)
    B, P = args.batch, args.prompt_len
    prompts = make_prompts(cfg.vocab, B, P, args.seed, dev)
    cache = init_decode_cache(cfg, B, P + args.decode_steps, device=dev)
    tok = prompts[:, :1]

    def prefill():
        logits, _ = transformer_apply(model, prompts)
        return logits[:, -1].float().argmax(-1)

    def decode(steps):
        for i in range(steps):
            pos = torch.full((B,), P + i, dtype=torch.long, device=dev)
            transformer_decode(model, cache, tok, pos)

    prefill()
    decode(1)
    torch.cuda.synchronize()
    for name, fn in (("prefill", prefill),
                     (f"decode x{args.decode_steps}",
                      lambda: decode(args.decode_steps))):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _report(name, prof, wall, args.top)
        if args.trace and name == "prefill":
            Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(args.trace)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
