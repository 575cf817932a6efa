"""The gloo ranks of ``test_torch_sharding.py``: a module of its own,
without JAX, that ``torch.multiprocessing.spawn`` imports in each rank.

Every rank of a world size runs the same work and rank 0 pickles what it
got to ``ws<n>.pkl`` in the shared directory: the reduced train cases at
each mesh of the world size (the unsharded port too, at world size 1;
the sequence-parallel attention too, at model-parallel 2), the native and
emulated collectives on each mesh, `compressed_psum` of seeded per-rank
gradients, and the trainer CLI runs
(world size 2: ``--model-parallel`` 2 and 3; world size 1: the
uninterrupted run, then, with no process group left, world size 2's
``--model-parallel 2`` checkpoint of step 3 resumed at
``--model-parallel 1``).  A second pair of ranks at world size 2, started
beside the first, runs the CLI cut by a stalled step and resumed, and
pickles that to ``ws2cut.pkl``.
"""
import contextlib
import io
import json
import os
import pickle
import shutil
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import interop
from repro_torch.configs.registry import get_arch
from repro_torch.models import sharding as t_sh
from repro_torch.runtime import faults
from repro_torch.train import compression as t_comp

WORLD_MESHES = {1: (1,), 2: (2, 1), 4: (4,)}   # model-parallel sizes
STALL_AT = 5        # the fault's call count: the CLI's step 4
ARCHS = ("qwen3-1.7b", "qwen3-moe-30b-a3b")
SPAWN_TIMEOUT_S = 240
# the trainer CLI's flags (test_torch_train.CLI), run from a seeded
# step -1 checkpoint
CLI = ["--arch", "qwen3-1.7b", "--reduced", "--steps", "6", "--batch", "2",
       "--seq", "16", "--log-every", "1", "--ckpt-every", "4", "--seed", "0"]


def grads_for(rank):
    """Rank ``rank``'s gradients for the compression case."""
    rng = np.random.default_rng(100 + rank)
    return {"a": np.asarray(rng.normal(size=(40,)), np.float32),
            "b": np.asarray(rng.normal(size=(3, 5)) * 1e-3, np.float32)}


def _whole(plan, tree, moment=False):
    return {n: (t if plan is None else plan.sharding(n, moment).unshard(t))
            .detach().numpy().copy() for n, t in tree.items()}


def train_case(arch_name, inputs, plan):
    """One reduced step of ``arch_name`` on ``plan``'s mesh (None: the
    unsharded port): the loss and gradients of the global batch, then a
    step from a fresh AdamW state; every leaf whole."""
    from repro_torch.models.sharding import shard_parameters_, use_rules
    from repro_torch.models.transformer import lm_loss
    from repro_torch.train.step import (init_opt_state, make_train_step,
                                        trainable_params)

    arch = get_arch(arch_name)
    d = inputs[arch_name]
    if "tree" in d:
        model = interop.transformer_params_from_numpy(
            d["tree"], arch.config(True), train=True)
    else:
        model = arch.init(torch.Generator().manual_seed(d["seed"]),
                          reduced=True, device="cpu", train=True)
    tok, tgt = (torch.as_tensor(d[k]).long() for k in ("tokens", "targets"))
    if plan is not None:
        shard_parameters_(model, plan.params, plan.mesh)
        n = t_sh._axis_size(plan.mesh, ("pod", "data"))
        rows = tok.shape[0] // n
        lo = t_sh.axis_index(plan.mesh, ("pod", "data")) * rows
        tok, tgt = tok[lo:lo + rows], tgt[lo:lo + rows]
    params = trainable_params(model)
    ctx = (contextlib.nullcontext() if plan is None
           else use_rules(plan.mesh))
    with ctx:
        loss = lm_loss(model, tok, tgt)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    if plan is not None:
        plan.sum_grads(grads)
        loss = plan.sum_over_data(loss.detach())
    out = {"loss": float(loss), "grads": _whole(plan, grads)}
    state = init_opt_state(model, plan)
    step = make_train_step(lm_loss, d["opt"], plan)
    step_loss, model, state = step(model, state, tok, tgt)
    params = trainable_params(model)
    out.update(step_loss=float(step_loss), step=int(state.step),
               params=_whole(plan, params), mu=_whole(plan, state.mu, True),
               shapes={n: (tuple(p.shape), tuple(state.mu[n].shape))
                       for n, p in params.items()})
    return out


def sequence_parallel_case(inputs, mesh):
    """`train_case` of the first arch under ``REPRO_ATTN_MODE=sp``, and
    the set of what `attention._tp_attention` answered meanwhile."""
    from repro_torch.models import attention
    from repro_torch.train.step import MeshPlan

    tp, seen = attention._tp_attention, set()

    def recorded(n_heads):
        seen.add(tp(n_heads))
        return tp(n_heads)

    os.environ["REPRO_ATTN_MODE"] = "sp"
    attention._tp_attention = recorded
    try:
        plan = MeshPlan.for_arch(get_arch(ARCHS[0]), mesh, reduced=True)
        return train_case(ARCHS[0], inputs, plan), seen
    finally:
        attention._tp_attention = tp
        del os.environ["REPRO_ATTN_MODE"]


def cli(argv):
    """The port's trainer CLI in this rank: (exit code, or the name of
    the assertion it failed; rank 0's stdout)."""
    from repro_torch.launch import train as t_train_cli

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = t_train_cli.main(argv + ["--device", "cpu"])
    except AssertionError:
        rc = "AssertionError"
    return rc, buf.getvalue()


def collective_input(rank: int) -> torch.Tensor:
    """Rank ``rank``'s tensor for the collectives case: whole numbers, so
    that every order of summation gives the same bits."""
    g = torch.Generator().manual_seed(500 + rank)
    return torch.randint(-8, 9, (4, 8, 6), generator=g).float()


def collectives_case(mesh) -> int:
    """All-gather and reduce-scatter over each axis of ``mesh`` that has
    more than one rank, along each dimension: the backend's own (native)
    and the ``all_reduce`` emulation against each other and against the
    concatenation or sum of the ranks' inputs.  The number of cases, or
    -1 where any rank found a mismatch."""
    bad, n_cases = 0, 0
    for axis in mesh.mesh_dim_names:
        n = t_sh._axis_size(mesh, axis)
        if n == 1:
            continue
        peers = [collective_input(r) for r in
                 dist.get_process_group_ranks(mesh.get_group(axis))]
        mine = peers[t_sh.axis_index(mesh, axis)]
        for dim in range(mine.dim()):
            want = torch.cat(peers, dim)
            got = [t_sh._gather_raw(mine, dim, mesh, axis, native=v)
                   for v in (True, False)]
            bad += sum(not torch.equal(g, want) for g in got)
            n_cases += 1
            if mine.shape[dim] % n:
                continue
            size = mine.shape[dim] // n
            want = sum(peers).narrow(dim, t_sh.axis_index(mesh, axis) * size,
                                     size)
            got = [t_sh._reduce_scatter_raw(mine, dim, mesh, axis, native=v)
                   for v in (True, False)]
            bad += sum(not torch.equal(g, want) for g in got)
            n_cases += 1
    flag = torch.tensor([bad])
    dist.all_reduce(flag)
    return -1 if int(flag) else n_cases


def _wait_for(path: Path, timeout_s: float = 120.0) -> None:
    """Wait until the spawning process has written ``path``."""
    deadline = time.monotonic() + timeout_s
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.05)


def cut_main(tmp: Path, mp2: list) -> dict:
    """Every rank's step 4 stalls past the budget: exit 75 with step 3
    saved, then the same command resumes to the final checkpoint."""
    _wait_for(tmp / "seeded")       # the CLI runs start from it
    faults.install(faults.FaultPlan([faults.FaultSpec(
        "train.step", "stall", at=STALL_AT, stall_s=60.0)]))
    try:
        out = {"cut": cli(mp2 + ["--ckpt-dir", str(tmp / "cut"),
                                 "--step-budget-s", "2"])}
    finally:
        faults.clear()
    out["cut_resumed"] = cli(mp2 + ["--ckpt-dir", str(tmp / "cut")])
    m = json.loads((tmp / "cut" / "step_00000005" / "manifest.json")
                   .read_text())
    out["cut_final"] = (m["treedef"], m["leaves"])
    return out


def rank_main(rank: int, ws: int, tmp: str, role: str = "") -> None:
    from repro_torch.launch.mesh import make_mesh_for_devices
    from repro_torch.train.step import MeshPlan

    torch.set_num_threads(1)
    tmp = Path(tmp)
    dist.init_process_group("gloo",
                            init_method=f"file://{tmp}/store{ws}{role}",
                            rank=rank, world_size=ws)
    mp2 = CLI + ["--model-parallel", "2"]
    if role == "cut":
        out = cut_main(tmp, mp2)
        dist.destroy_process_group()
        if rank == 0:
            (tmp / "ws2cut.pkl").write_bytes(pickle.dumps(out))
        return
    _wait_for(tmp / "inputs.pkl")
    inputs = pickle.loads((tmp / "inputs.pkl").read_bytes())
    out = {"train": {}, "collectives": {}}
    if ws == 1:
        for a in ARCHS:
            out["train"][(a, 0, 0)] = train_case(a, inputs, None)
    for mp_size in WORLD_MESHES[ws]:
        mesh = make_mesh_for_devices(ws, mp_size, device_type="cpu")
        for a in ARCHS:
            plan = MeshPlan.for_arch(get_arch(a), mesh, reduced=True)
            out["train"][(a, ws // mp_size, mp_size)] = train_case(
                a, inputs, plan)
        if mp_size == 2:        # the sequence-parallel attention
            out["train"][(ARCHS[0], 1, 2, "sp")], out["sp_modes"] = \
                sequence_parallel_case(inputs, mesh)
        if ws > 1:
            out["collectives"][mp_size] = collectives_case(mesh)
    got, _ = t_comp.compressed_psum(
        {k: torch.from_numpy(v) for k, v in grads_for(rank).items()})
    out["psum"] = {k: v.numpy() for k, v in got.items()}
    _wait_for(tmp / "seeded")       # the CLI runs start from it
    if ws == 2:
        out["mp2"] = cli(mp2 + ["--ckpt-dir", str(tmp / "mp2")])
        out["mp3"] = cli(CLI + ["--ckpt-dir", str(tmp / "mp3"),
                                 "--model-parallel", "3"])[0]
        if rank == 0:
            m = json.loads((tmp / "mp2" / "step_00000005" / "manifest.json")
                           .read_text())
            out["mp2_final"] = (m["treedef"], m["leaves"])
    if ws == 1:
        out["mp1"] = cli(CLI + ["--ckpt-dir", str(tmp / "mp1")])
    dist.destroy_process_group()
    if ws == 1:     # once world size 2's run has committed its last step
        _wait_for(tmp / "mp2" / "step_00000005" / "COMMIT")
        shutil.copytree(tmp / "mp2", tmp / "resumed",
                        ignore=shutil.ignore_patterns("step_00000005"))
        out["resumed"] = cli(CLI + ["--ckpt-dir", str(tmp / "resumed")])
    if rank == 0:
        (tmp / f"ws{ws}.pkl").write_bytes(pickle.dumps(out))


def spawn(ws: int, tmp: Path, role: str = ""):
    """Start the ``ws`` ranks (``role`` "cut": the straggler cut's pair);
    (their context, the deadline to join by)."""
    ctx = mp.spawn(rank_main, args=(ws, str(tmp), role), nprocs=ws,
                   join=False)
    return ctx, time.monotonic() + SPAWN_TIMEOUT_S


def join(ctx, deadline) -> None:
    """Wait for the ranks until ``deadline``; kill what is left."""
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError("sharded ranks did not finish in "
                                   f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
