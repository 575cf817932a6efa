"""Training launcher (``repro.launch.train`` on PyTorch).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --steps 200 --batch 8 --seq 128 --reduced --device cpu \\
        --ckpt-dir /tmp/ckpt
    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.train --device cpu --reduced --model-parallel 2

The reference's flow: mesh → sharded parameters and AdamW state → the
step-indexed Zipf token stream → loss + grad + AdamW each step → async
checkpoints every ``--ckpt-every`` steps, a heartbeat, a straggler guard
(``--step-budget-s``: a step past its budget saves the last finished step
and exits 75, the conventional tempfail) and auto-resume from the latest
committed checkpoint.  The reference's flags and log lines, plus
``--device {cuda,cpu}`` (``cuda`` by default, which raises without a
card), ``--backend`` and two closing lines of measurements: the steps'
median wall time (each step ends in a host read of its loss, so the
device has finished it) and tokens/s after the first step, the device's
peak memory, and the final save's seconds and bytes.  Non-LM archs exit
with the reference's message.

Under torchrun (or in a process group a caller has joined) the mesh is
``launch.mesh.make_mesh_for_devices(world, --model-parallel)``: NCCL on
the card, gloo for ``--device cpu`` (``--backend gloo`` on the card lets
two ranks share it).  Parameters follow the arch's ``param_pspecs``, the
moments ZeRO-1 (``train.step.MeshPlan``), and each data rank takes its
rows of the same seeded global batch, so the run computes the global
batch's step.  Rank 0 alone logs, beats the heartbeat and writes
checkpoints, which hold whole leaves: every rank gathers them, whatever
the mesh, and a run resumes onto any mesh.  Without a process group the
trainer runs on one device, unsharded; ``--model-parallel`` other than 1
then fails the mesh's assertion, as the reference's does on one device.

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
import torch.distributed as dist

from ..configs.registry import get_arch
from ..core.distributed import process_rank
from ..data.synthetic import token_stream
from ..device import resolve_device
from ..models.sharding import NamedSharding, P, _axis_size, axis_index
from ..runtime import faults
from ..train import checkpoint as ckpt
from ..train.elastic import HeartbeatFile, StepGuard, StragglerTimeout
from ..train.optimizer import AdamWState
from ..train.step import MeshPlan, init_opt_state, trainable_params
from .mesh import join_torchrun_group, make_mesh_for_devices, world_size

EXIT_STRAGGLER = 75


def state_tree(model, opt_state: AdamWState, plan=None):
    """The checkpoint tree: (parameters by name, AdamW state); under
    ``plan`` every leaf whole (a collective: every rank calls it), a
    gathered leaf moved to the host as soon as it is whole."""
    params = trainable_params(model)
    if plan is None:
        return (params, opt_state)

    def whole(tree, moment):
        out = {}
        for n, t in tree.items():
            w = plan.sharding(n, moment).unshard(t)
            out[n] = t if w is t else w.cpu()
        return out

    return (whole(params, False),
            AdamWState(step=opt_state.step, mu=whole(opt_state.mu, True),
                       nu=whole(opt_state.nu, True)))


def restore_into(model, ckpt_dir, device, plan=None):
    """Load the latest committed checkpoint into ``model`` (in place;
    under ``plan`` each rank keeps its shards of the whole leaves);
    returns (opt_state, extra, step)."""
    like = state_tree_like(model, plan)
    shardings = None
    if plan is not None:
        names = trainable_params(model)
        shardings = ({n: plan.sharding(n) for n in names},
                     AdamWState(step=NamedSharding(plan.mesh, P()),
                                mu={n: plan.sharding(n, True) for n in names},
                                nu={n: plan.sharding(n, True) for n in names}))
    (params, opt), extra, step = ckpt.restore(ckpt_dir, like, device=device,
                                              shardings=shardings)
    with torch.no_grad():
        for name, p in trainable_params(model).items():
            p.copy_(params[name])
    return AdamWState(*opt), extra, step


def state_tree_like(model, plan=None):
    """Shapes of the checkpoint tree (whole leaves), allocating nothing."""
    def spec(name, p):
        shape = (tuple(p.shape) if plan is None else
                 plan.sharding(name).global_shape(p.shape))
        return ckpt.LeafSpec(shape, p.dtype)

    like = {n: spec(n, p) for n, p in trainable_params(model).items()}
    return (like, AdamWState(step=ckpt.LeafSpec(()), mu=like, nu=like))


def _mesh(args, dev):
    """The (data, model) mesh over the process group's ranks, or None for
    a process of its own at ``--model-parallel 1``."""
    if not dist.is_initialized() and args.model_parallel == 1:
        return None
    return make_mesh_for_devices(world_size(), args.model_parallel,
                                 device_type=dev.type)


def _local_rows(t: torch.Tensor, plan) -> torch.Tensor:
    """This data rank's rows of a global batch."""
    if plan is None:
        return t
    data = ("pod", "data")
    n = _axis_size(plan.mesh, data)
    if t.shape[0] % n:
        raise ValueError(f"--batch {t.shape[0]} does not split over "
                         f"{n} data ranks")
    rows = t.shape[0] // n
    return t[axis_index(plan.mesh, data) * rows:][:rows]


def train_lm(arch, args) -> int:
    """The trainer in a process group it joins itself (torchrun's), left
    when the run ends, or in the caller's."""
    dev = resolve_device(args.device)
    joined = (not dist.is_initialized()
              and join_torchrun_group(args.backend, dev))
    try:
        return _train_lm(arch, args, dev)
    finally:
        if joined:
            dist.destroy_process_group()


def _train_lm(arch, args, dev) -> int:
    mesh = _mesh(args, dev)
    plan = (None if mesh is None else
            MeshPlan.for_arch(arch, mesh, reduced=args.reduced))
    if mesh is not None and args.seq % args.model_parallel:
        raise ValueError(f"--seq {args.seq}: the residual stream splits the "
                         f"sequence over --model-parallel "
                         f"{args.model_parallel}")
    lead = process_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    opt_cfg = dataclasses.replace(arch.opt, total_steps=args.steps,
                                  warmup_steps=max(args.steps // 20, 1))
    train_step = arch.step_fn("train_4k", opt=opt_cfg, plan=plan)
    ckpt_dir = Path(args.ckpt_dir)
    hb = HeartbeatFile(ckpt_dir / "heartbeat") if lead else None

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = arch.init(gen, reduced=args.reduced, device=dev, train=True,
                      plan=plan)
    cfg = model.cfg
    start_step = 0
    extra = {}
    latest = ckpt.latest_step(ckpt_dir)
    if latest is not None:
        opt_state, extra, got = restore_into(model, ckpt_dir, dev, plan)
        start_step = got + 1
        say(f"[train] resumed from step {got}")
    else:
        opt_state = init_opt_state(model, plan)

    def save(step, sync):
        tree = state_tree(model, opt_state, plan)
        if lead:
            (ckpt.save if sync else ckpt.save_async)(
                ckpt_dir, step, tree, extra={"data_step": step + 1})
        if sync and mesh is not None:
            dist.barrier()      # no rank leaves before the step commits

    stream = token_stream(cfg.vocab, args.batch, args.seq, seed=args.seed,
                          start_step=int(extra.get("data_step", start_step)))
    t0 = time.monotonic()
    losses, step_s = [], []
    for step in range(start_step, args.steps):
        t_step = time.monotonic()
        tokens, targets = next(stream)
        tokens = _local_rows(torch.as_tensor(tokens), plan).to(dev)
        targets = _local_rows(torch.as_tensor(targets), plan).to(dev)
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
            say(f"[train] step {step} straggled; checkpoint-restart")
            ckpt.wait_pending()
            save(last, sync=True)
            return EXIT_STRAGGLER
        step_s.append(time.monotonic() - t_step)
        losses.append(loss)
        if lead:
            hb.beat(step)
        if step % args.ckpt_every == args.ckpt_every - 1:
            save(step, sync=False)
        if step % args.log_every == 0:
            dt = time.monotonic() - t0
            say(f"[train] step={step} loss={loss:.4f} "
                f"({dt / max(step - start_step + 1, 1):.2f}s/step)",
                flush=True)
    ckpt.wait_pending()
    t_save = time.monotonic()
    save(args.steps - 1, sync=True)
    save_s = time.monotonic() - t_save
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    if losses:
        say(f"[train] done: first loss {losses[0]:.4f} → last "
            f"{losses[-1]:.4f}")
        steady = sorted(step_s[1:] or step_s)
        med = steady[len(steady) // 2]
        say(f"[train] steady: step_s median={med:.4f} first={step_s[0]:.3f} "
            f"tokens_per_s={args.batch * args.seq / med:.1f} "
            f"max_memory_allocated={peak}", flush=True)
    if mesh is not None:
        peaks = torch.zeros(world_size(), dtype=torch.int64, device=dev)
        peaks[process_rank()] = peak or 0
        dist.all_reduce(peaks)
        say(f"[train] mesh (data, model)={tuple(mesh.shape)} "
            f"max_memory_allocated by rank {peaks.tolist()}", flush=True)
    if lead:
        final = ckpt_dir / f"step_{args.steps - 1:08d}"
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
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "nccl", "gloo"],
                    help="torch.distributed backend under torchrun: nccl "
                         "for --device cuda and gloo for --device cpu "
                         "(auto), or gloo on the card too (several ranks "
                         "on one card)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    arch = get_arch(args.arch)
    if arch.family != "lm":
        raise SystemExit("train.py drives LM archs; see examples/ for GNN/recsys")
    return train_lm(arch, args)


if __name__ == "__main__":
    sys.exit(main())
