"""Compare checkouts of the port on one card, in turns.

    python scripts/torch_ab.py [--only main|train|agg] PARENT_DIR . . PARENT_DIR

Each argument is the root of a checkout (for example the parent commit
unpacked by ``git archive`` into a directory that ``.gitignore`` lists).
For each, in the order given and each in a process of its own, runs that
checkout's ``chip_smoke.py`` phases.  ``main``: the build, the mico main
run (``mine_wall_s`` and the levels' wall), the qwen3-1.7b serve run
(``ttft_s``, decode step), the dlrm-rm2 recsys phase (each shape's
``forward_ms``; the embedding bag at serve_bulk's bags against its bound
and ``F.embedding_bag``), the flash kernel at the serve shape against SDPA
and the mining kernels at the hub block.  ``train``: the qwen3-1.7b
trainer at the smoke's train-lm flags (its median ``step_s``), the flash
backward at the trainer's per-layer shape against SDPA's backward, the
train-gnn steps (``step_ms``) and the aggregate transpose at layer 1 of
block 0 (ms, ``torch.sparse.mm``, and a SHA-256 of its output, which two
checkouts must share where the kernel's bytes are meant to be equal).
Both by default.  ``agg`` (only when asked for): the gather-aggregate
over CSR segments at ogb_products, F 100 and 128 bf16 mean, beside
``torch.sparse.mm`` on the same CSR, and at layer 0 of sage-minibatch's
block 0 (F 602, padded and CSR), with a SHA-256 of the outputs.  Prints
one line ``AB <dir> {json}`` per checkout, or ``AB <dir> FAILED``, and
exits 1 if any failed.  Alternate the checkouts (A B B A) so that a drift
of the card's clock shows as a difference between the two readings of
one checkout.

A checkout written ``DIR:NAME=VALUE[,NAME=VALUE...]`` is a copy of DIR
(under ``build/ab_trees/``) in which each ``constexpr int NAME = ...;``
of ``src/repro_torch/csrc/*.cu`` is set to VALUE: one kernel constant
timed beside the choice without a build option for it.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

CODE = r'''
import contextlib, io, json, re, sys, time, torch
from pathlib import Path
sys.path[:0] = [".", "src"]
import chip_smoke as cs
dev = torch.device("cuda")
cs.phase_build()
out = Path("build/smoke"); out.mkdir(parents=True, exist_ok=True)
t0 = time.monotonic(); cs.phase_main(out, cs.MICO_SIGMA); wall = time.monotonic() - t0
mico = json.loads((out / "smoke_mico.json").read_text())
cs.phase_serve(out)
serve = json.loads((out / "smoke_serve.json").read_text())
log = io.StringIO()
with contextlib.redirect_stdout(log):
    _, bag = cs.phase_recsys(dev)
sys.stdout.write(log.getvalue())
forward_ms = {m.group(1): float(m.group(2)) for m in re.finditer(
    r"recsys: (\w+) batch=\d+ forward_ms=([\d.]+)", log.getvalue())}
f = cs.phase_flash_kernel(dev)
rows = cs.phase_kernels(dev, {"frontier_expand": 0, "mis_bitmap": 0},
                        {"frontier_expand": 0, "mis_bitmap": 0}, cs.MICO_SIGMA)
print("RESULT " + json.dumps({
    "mine_wall_s": wall, "elapsed_s": mico["elapsed_s"],
    "levels_s": sum(v["wall_s"] for v in mico["per_level"].values()),
    "n_frequent": mico["n_frequent"], "ttft_s": serve["ttft_s"],
    "decode_step_ms_median": serve["decode_step_ms_median"],
    "flash_ms": f["ms"], "sdpa_ms": f["library_ms"], "flash_err": f["max_abs_err"],
    "frontier_ms": rows[0]["ms"], "mis_ms": rows[1]["ms"],
    "bag_ms": bag["ms"], "bag_bound_ms": bag["bound_ms"],
    "embedding_bag_lib_ms": bag["library_ms"], "recsys_forward_ms": forward_ms}))
'''

TRAIN_CODE = r'''
import contextlib, hashlib, io, json, re, shutil, sys, torch
from pathlib import Path
sys.path[:0] = [".", "src"]
import chip_smoke as cs
dev = torch.device("cuda")
cs.phase_build()
out = Path("build/smoke"); out.mkdir(parents=True, exist_ok=True)
ck = out / "ab_train_lm"
shutil.rmtree(ck, ignore_errors=True)
rc, text = cs._train_cli(cs.TRAIN_FLAGS + ["--ckpt-dir", str(ck)],
                         out / "ab_train_lm.log")
shutil.rmtree(ck, ignore_errors=True)
assert rc == 0, rc
step_s = float(re.search(r"step_s median=([\d.]+)", text).group(1))
torch.cuda.empty_cache()
fb = cs._flash_bwd_row(dev)
_, _, gnn = cs.phase_gnn(dev)
log = io.StringIO()
with contextlib.redirect_stdout(log):
    _, aggt = cs.phase_train_gnn(dev, gnn)
sys.stdout.write(log.getvalue())
gnn_ms = [float(x) for x in re.search(
    r"train-gnn: .* step_ms=\[([^\]]*)\]", log.getvalue()).group(1).split(",")]
# the transpose's output at layer 1 of block 0, at the phase's own inputs
from repro_torch.configs.registry import get_arch
from repro_torch.data.sampler import block_graph_batch
from repro_torch.kernels.gather_aggregate.kernel import gather_aggregate_t_nf
from repro_torch.kernels.gather_aggregate.ops import (
    in_neighbor_table, out_neighbor_csr)
gb = block_graph_batch(gnn["sampler"].sample(0), gnn["feats"], gnn["labels"])
nbrs = in_neighbor_table(gb.edge_src, gb.edge_dst, gb.edge_mask, gb.x.shape[0])
Fd = get_arch("graphsage-reddit").config("minibatch_lg").d_hidden
d_out = torch.randn((nbrs.shape[0], Fd), generator=torch.Generator(device=dev)
                    .manual_seed(5), device=dev).to(torch.bfloat16)
indptr, dst, deg = out_neighbor_csr(nbrs)[:3]
got = gather_aggregate_t_nf(d_out, indptr, dst, deg)
digest = hashlib.sha256(got.cpu().view(torch.uint8).numpy().tobytes()).hexdigest()
print("RESULT " + json.dumps({
    "train_lm_step_s_median": step_s,
    "flash_bwd_ms": fb["ms"], "sdpa_bwd_ms": fb["library_ms"],
    "flash_bwd_err": fb["max_abs_err"], "flash_bwd_bound_ms": fb["bound_ms"],
    "train_gnn_step_ms": gnn_ms,
    "train_gnn_step_ms_median": sorted(gnn_ms[1:])[len(gnn_ms[1:]) // 2],
    "aggt_ms": aggt["ms"], "aggt_sparse_mm_ms": aggt["library_ms"],
    "aggt_bound_ms": aggt["bound_ms"], "aggt_err": aggt["max_abs_err"],
    "aggt_sha256": digest}))
'''

AGG_CODE = r'''
import hashlib, json, sys, torch
sys.path[:0] = [".", "src"]
import chip_smoke as cs
from repro_torch.configs.registry import get_arch
from repro_torch.data.sampler import block_graph_batch
from repro_torch.kernels.gather_aggregate.kernel import (
    gather_aggregate_csr_nf, gather_aggregate_nf)
from repro_torch.kernels.gather_aggregate.ops import in_csr, in_neighbor_table
dev = torch.device("cuda")
arch = get_arch("graphsage-reddit")
gen = torch.Generator(device=dev).manual_seed(7)
digest = hashlib.sha256()
res = {"card": cs.phase_card()}
gb = arch.inputs("ogb_products", seed=cs.SAGE_SEED, device=dev)
N = gb.x.shape[0]
indptr, src = in_csr(gb.edge_src, gb.edge_dst, gb.edge_mask, N)
del gb
deg = torch.diff(indptr)
vals = (1.0 / deg.clamp(min=1).float()).repeat_interleave(deg)
adj = torch.sparse_csr_tensor(indptr.long(), src.long(), vals.to(torch.bfloat16),
                              (N, N), check_invariants=False)
for F in (100, 128):
    h = torch.randn((N, F), generator=gen, device=dev).to(torch.bfloat16)
    fn = lambda: gather_aggregate_csr_nf(h, indptr, src, mean=True)
    digest.update(cs._sha256(fn()).encode())
    res[f"ogb_f{F}_ms"] = cs._time_ms(fn, reps=5)
    res[f"ogb_f{F}_sparse_mm_ms"] = cs._time_ms(lambda: torch.sparse.mm(adj, h),
                                                reps=5)
del adj, h, indptr, src
torch.cuda.empty_cache()
shape = "minibatch_lg"
g = arch.graph(shape, seed=cs.SAGE_SEED)
blk = arch.sampler(g, shape, seed=cs.SAGE_SEED).sample(0)
feats, labels = arch.node_data(shape, g.n, seed=cs.SAGE_SEED, device=dev)
b0 = block_graph_batch(blk, feats, labels)
h0 = b0.x.to(torch.bfloat16)
nbrs = in_neighbor_table(b0.edge_src, b0.edge_dst, b0.edge_mask, h0.shape[0])
ip0, src0 = in_csr(b0.edge_src, b0.edge_dst, b0.edge_mask, h0.shape[0])
digest.update(cs._sha256(gather_aggregate_nf(h0, nbrs, mean=True)).encode())
digest.update(cs._sha256(gather_aggregate_csr_nf(h0, ip0, src0, mean=True))
              .encode())
res["block0_padded_ms"] = cs._time_ms(
    lambda: gather_aggregate_nf(h0, nbrs, mean=True), reps=20)
res["block0_csr_ms"] = cs._time_ms(
    lambda: gather_aggregate_csr_nf(h0, ip0, src0, mean=True), reps=20)
res["agg_sha256"] = digest.hexdigest()
print("RESULT " + json.dumps(res))
'''


def tree_copy(spec: str) -> str:
    """The checkout ``spec`` names: a directory as it is, or for
    ``DIR:NAME=VALUE[,...]`` a copy of DIR with those kernel constants."""
    if ":" not in spec:
        return spec
    base, sets = spec.split(":", 1)
    tag = sets.replace(",", "-").replace("=", "")
    dst = Path("build") / "ab_trees" / tag
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(base, dst, ignore=shutil.ignore_patterns(
        "build", "chiprun_out", ".git"))
    for item in sets.split(","):
        name, value = item.split("=")
        pattern = re.compile(rf"(constexpr int {name} = )[^;]+;")
        hits = 0
        for cu in (dst / "src" / "repro_torch" / "csrc").glob("*.cu"):
            text, n = pattern.subn(rf"\g<1>{value};", cu.read_text())
            if n:
                cu.write_text(text)
                hits += n
        if hits != 1:
            raise SystemExit(f"torch_ab: {name} is defined {hits} times")
    return str(dst)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=["main", "train", "agg"],
                    help="run one group of readings (default: main and "
                         "train)")
    ap.add_argument("trees", nargs="*", help="checkout roots, in turn")
    args = ap.parse_args(argv)
    if not args.trees:
        print(__doc__, file=sys.stderr)
        return 2
    codes = {"main": CODE, "train": TRAIN_CODE, "agg": AGG_CODE}
    groups = [args.only] if args.only else ["main", "train"]
    failed = False
    for spec in args.trees:
        tree = tree_copy(spec)
        result = {}
        for group in groups:
            out = subprocess.run([sys.executable, "-c", codes[group]],
                                 cwd=tree, capture_output=True, text=True)
            sys.stdout.write(out.stdout)
            sys.stderr.write(out.stderr[-4000:])
            line = [ln for ln in out.stdout.splitlines()
                    if ln.startswith("RESULT ")]
            if out.returncode != 0 or not line:
                failed = True
                result = None
                break
            result.update(json.loads(line[0][7:]))
        print(f"AB {spec} " + (json.dumps(result) if result is not None
                               else "FAILED"), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
