"""Compare checkouts of the port on one card, in turns.

    python scripts/torch_ab.py [--only main|train] PARENT_DIR . . PARENT_DIR

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
Both by default.  Prints one line ``AB <dir> {json}`` per checkout, or
``AB <dir> FAILED``, and exits 1 if any failed.  Alternate the checkouts
(A B B A) so that a drift of the card's clock shows as a difference
between the two readings of one checkout.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=["main", "train"],
                    help="run one group of readings (default: both)")
    ap.add_argument("trees", nargs="*", help="checkout roots, in turn")
    args = ap.parse_args(argv)
    if not args.trees:
        print(__doc__, file=sys.stderr)
        return 2
    codes = {"main": CODE, "train": TRAIN_CODE}
    groups = [args.only] if args.only else list(codes)
    failed = False
    for tree in args.trees:
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
        print(f"AB {tree} " + (json.dumps(result) if result is not None
                               else "FAILED"), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
