"""Compare checkouts of the port on one card, in turns.

    python scripts/torch_ab.py PARENT_DIR . . PARENT_DIR

Each argument is the root of a checkout (for example the parent commit
unpacked by ``git archive`` into a directory that ``.gitignore`` lists).
For each, in the order given and each in a process of its own, runs that
checkout's ``chip_smoke.py`` phases: the build, the mico main run
(``mine_wall_s`` and the levels' wall), the qwen3-1.7b serve run
(``ttft_s``, decode step), the dlrm-rm2 recsys phase (each shape's
``forward_ms``; the embedding bag at serve_bulk's bags against its bound
and ``F.embedding_bag``), the flash kernel at the serve shape against SDPA
and the mining kernels at the hub block.  Prints one line
``AB <dir> {json}`` per checkout, or ``AB <dir> FAILED``, and exits 1 if any
failed.  Alternate the checkouts (A B B A) so that a drift of the card's
clock shows as a difference between the two readings of one checkout.
"""
from __future__ import annotations

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


def main(argv=None) -> int:
    trees = sys.argv[1:] if argv is None else argv
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    failed = False
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", CODE], cwd=tree,
                             capture_output=True, text=True)
        sys.stdout.write(out.stdout)
        sys.stderr.write(out.stderr[-4000:])
        line = [ln for ln in out.stdout.splitlines()
                if ln.startswith("RESULT ")]
        if out.returncode != 0 or not line:
            failed = True
        print(f"AB {tree} " + (line[0][7:] if line else "FAILED"), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
