"""Plant a gradient-sum fault in the sharded trainer and show whether
``chip_smoke.py``'s train-lm-sharded (b) check catches it.

    python scripts/torch_sharded_fault.py

Runs (b)'s two configurations as the smoke does (qwen3-1.7b at full width
and ``SHARDED_LAYERS`` layers, ``SHARDED_FLAGS``, no final checkpoint):
one NCCL rank at ``--model-parallel 1``, sound, then two gloo ranks on the
one card at ``--model-parallel 2`` with `MeshPlan.sum_grads` patched at
run time to skip the leaves that no mesh axis splits (the norms lose
their model-axis sum).  Prints each run's tail, then one JSON line with
both runs' losses, their relative gaps and the verdict of
``chip_smoke.sharded_loss_gaps``, the phase's own check.  Nothing in the
checkout changes.  Needs one card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke as cs  # noqa: E402


def plant_fault() -> None:
    """`MeshPlan.sum_grads` without the leaves no axis splits."""
    from repro_torch.train import step

    whole = step.MeshPlan.sum_grads

    def sum_grads(self, grads):
        whole(self, {n: g for n, g in grads.items()
                     if any(p is not None for p in self.params[n])})

    step.MeshPlan.sum_grads = sum_grads


def run(tag: str, ws: int, fault: bool) -> list:
    """(b)'s trainer at world size ``ws`` under torchrun; its losses."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={ws}", str(Path(__file__).resolve()), "--rank",
           *cs.SHARDED_FLAGS, "--model-parallel", str(ws), "--device",
           "cuda", "--ckpt-dir", str(cs.OUT / f"fault_{tag}")]
    if ws > 1:
        cmd += ["--backend", "gloo"]
    env = dict(os.environ, SMOKE_DIST_TAG=tag,
               SMOKE_TRAIN_LAYERS=str(cs.SHARDED_LAYERS),
               SMOKE_TRAIN_NO_SAVE="1", SHARDED_FAULT=str(int(fault)))
    p = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    print(f"--- {tag} rc={p.returncode}\n{p.stdout[-2500:]}", flush=True)
    if p.returncode != 0:
        raise SystemExit(f"{tag} failed:\n{p.stderr[-3000:]}")
    return cs._losses(p.stdout)


def main() -> int:
    if sys.argv[1:2] == ["--rank"]:
        if os.environ.get("SHARDED_FAULT") == "1":
            plant_fault()
        return cs.main(["--phase", "train-rank", "--"] + sys.argv[2:])
    cs.OUT.mkdir(parents=True, exist_ok=True)
    one = run("ws1", 1, False)
    two = run("ws2-fault", 2, True)
    try:
        cs.sharded_loss_gaps(two, one)
        verdict = "passed: the fault was not caught"
    except AssertionError as e:
        verdict = f"failed: the fault was caught ({e})"
    print(json.dumps({"ws1": one, "ws2_fault": two,
                      "rel": [abs(a - b) / abs(b) for a, b in zip(two, one)],
                      "tol": cs.SHARDED_TOL, "phase_check": verdict}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
