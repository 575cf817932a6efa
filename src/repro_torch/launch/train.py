"""Training launcher (``repro.launch.train`` on PyTorch).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --steps 200 --batch 8 --seq 128 --reduced --device cpu \\
        --ckpt-dir /tmp/ckpt

The reference's flow on one device: model (f32 masters) → AdamW state →
the step-indexed Zipf token stream → loss + grad + AdamW each step →
async checkpoints every ``--ckpt-every`` steps, a heartbeat, a straggler
guard (``--step-budget-s``: a step past its budget saves the last
finished step and exits 75, the conventional tempfail) and auto-resume
from the latest committed checkpoint.  The reference's flags and log
lines, plus ``--device {cuda,cpu}`` (``cuda`` by default, which raises
without a card) and two closing lines of measurements: the steps' median
wall time (each step ends in a host read of its loss, so the device has
finished it) and tokens/s after the first step, the device's peak
memory, and the final save's seconds and bytes.  ``--model-parallel`` other than 1 raises: sharding is
not ported.  Non-LM archs exit with the reference's message.

The checkpoint is the port's own tree, ``(params, AdamWState)`` with the
parameters keyed by their module names (``train.step.trainable_params``),
in the reference's on-disk format (``train/checkpoint.py``); the reference
cannot read it, nor the port the reference's.

A step updates parameters and moments in place, so a straggler cut must
not land inside the update: the update runs with SIGALRM held back
(``train.elastic.uninterruptible``), and the cut reads the optimizer's
step counter, which the update increments in place, to know whether the
step it interrupted finished (then it saves that step).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

from ..configs.registry import get_arch
from ..data.synthetic import token_stream
from ..device import resolve_device
from ..runtime import faults
from ..train import checkpoint as ckpt
from ..train.elastic import HeartbeatFile, StepGuard, StragglerTimeout
from ..train.optimizer import AdamWState
from ..train.step import init_opt_state, trainable_params

EXIT_STRAGGLER = 75


def state_tree(model, opt_state: AdamWState):
    """The checkpoint tree: (parameters by name, AdamW state)."""
    return (trainable_params(model), opt_state)


def restore_into(model, ckpt_dir, device):
    """Load the latest committed checkpoint into ``model`` (in place);
    returns (opt_state, extra, step)."""
    like = state_tree(model, init_opt_state_like(model))
    (params, opt), extra, step = ckpt.restore(ckpt_dir, like, device=device)
    with torch.no_grad():
        for name, p in trainable_params(model).items():
            p.copy_(params[name])
    return AdamWState(*opt), extra, step


def init_opt_state_like(model) -> AdamWState:
    """Shapes of the AdamW state, without allocating the moments."""
    like = {name: ckpt.LeafSpec(tuple(p.shape), p.dtype)
            for name, p in trainable_params(model).items()}
    return AdamWState(step=ckpt.LeafSpec(()), mu=like, nu=like)


def train_lm(arch, args) -> int:
    dev = resolve_device(args.device)
    opt_cfg = dataclasses.replace(arch.opt, total_steps=args.steps,
                                  warmup_steps=max(args.steps // 20, 1))
    train_step = arch.step_fn("train_4k", opt=opt_cfg)
    ckpt_dir = Path(args.ckpt_dir)
    hb = HeartbeatFile(ckpt_dir / "heartbeat")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = arch.init(gen, reduced=args.reduced, device=dev, train=True)
    cfg = model.cfg
    start_step = 0
    extra = {}
    latest = ckpt.latest_step(ckpt_dir)
    if latest is not None:
        opt_state, extra, got = restore_into(model, ckpt_dir, dev)
        start_step = got + 1
        print(f"[train] resumed from step {got}")
    else:
        opt_state = init_opt_state(model)

    stream = token_stream(cfg.vocab, args.batch, args.seq, seed=args.seed,
                          start_step=int(extra.get("data_step", start_step)))
    t0 = time.monotonic()
    losses, step_s = [], []
    for step in range(start_step, args.steps):
        t_step = time.monotonic()
        tokens, targets = next(stream)
        tokens = torch.as_tensor(tokens).to(dev)
        targets = torch.as_tensor(targets).to(dev)
        done = int(opt_state.step)
        try:
            with StepGuard(args.step_budget_s):
                faults.fire("train.step", step=step)
                loss, model, opt_state = train_step(model, opt_state, tokens,
                                                    targets)
                loss = float(loss)
        except StragglerTimeout:
            # the update is all or nothing: the moments' step says which
            last = step if int(opt_state.step) > done else step - 1
            print(f"[train] step {step} straggled; checkpoint-restart")
            ckpt.wait_pending()
            ckpt.save(ckpt_dir, last, state_tree(model, opt_state),
                      extra={"data_step": last + 1})
            return EXIT_STRAGGLER
        step_s.append(time.monotonic() - t_step)
        losses.append(loss)
        hb.beat(step)
        if step % args.ckpt_every == args.ckpt_every - 1:
            ckpt.save_async(ckpt_dir, step, state_tree(model, opt_state),
                            extra={"data_step": step + 1})
        if step % args.log_every == 0:
            dt = time.monotonic() - t0
            print(f"[train] step={step} loss={loss:.4f} "
                  f"({dt / max(step - start_step + 1, 1):.2f}s/step)",
                  flush=True)
    ckpt.wait_pending()
    t_save = time.monotonic()
    final = ckpt.save(ckpt_dir, args.steps - 1, state_tree(model, opt_state),
                      extra={"data_step": args.steps})
    save_s = time.monotonic() - t_save
    if losses:
        print(f"[train] done: first loss {losses[0]:.4f} → last "
              f"{losses[-1]:.4f}")
        steady = sorted(step_s[1:] or step_s)
        med = steady[len(steady) // 2]
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else None)
        print(f"[train] steady: step_s median={med:.4f} first={step_s[0]:.3f} "
              f"tokens_per_s={args.batch * args.seq / med:.1f} "
              f"max_memory_allocated={peak}", flush=True)
    nbytes = sum(f.stat().st_size for f in final.iterdir())
    print(f"[train] saved step {args.steps - 1}: {nbytes} bytes in "
          f"{save_s:.2f} s", flush=True)
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                    "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--step-budget-s", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model trains (default cuda; raises "
                         "without a card)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.model_parallel != 1:
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel}: sharding is not ported "
            f"yet (ROADMAP.md); the port trains on one device")
    arch = get_arch(args.arch)
    if arch.family != "lm":
        raise SystemExit("train.py drives LM archs; see examples/ for GNN/recsys")
    return train_lm(arch, args)


if __name__ == "__main__":
    sys.exit(main())
