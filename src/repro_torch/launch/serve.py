"""Serve a decoder-only LM with batched requests: prefill + KV-cache decode.

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch qwen3-1.7b] \\
        [--reduced] [--batch 4] [--prompt-len 1024] [--gen-len 32] \\
        [--replay-len N] [--seed 0] [--device cuda|cpu] [--json out.json]

The port's counterpart of ``examples/serve_lm.py``, in the same order:

  1. prefill the prompts with `transformer_apply`, which also fills the KV
     cache, and take the last-position logits (time to first token);
  2. replay the first ``--replay-len`` prompt tokens (default: all, and
     for a MoE arch at most the prefill's expert capacity, see below) into
     a fresh cache through `transformer_decode`, one token at a time, and
     compare the replay's last logits with the prefill's at that position:
     on the card that holds the flash-attention kernel's path against the
     plain decode path (the reference's ``test_decode_matches_forward``
     property; tolerances below);
  3. decode ``--gen-len`` tokens greedily from the prefill's cache, timing
     every step.

The example fills the cache by the replay itself; here the prefill fills
it, as a server does, so the replay is only a check and may be shorter
than the prompt (an eager decode step costs the same at any position).

A MoE layer keeps at most ``C = capacity(moe_cfg, P)`` assignments an
expert in a row of P tokens and drops the rest; a decode step (one token,
``top_k <= 8 <= C``) never drops.  The dispatch ranks an expert's
assignments in token order, so a token at position t < C is never dropped,
and attention is causal: the prefill's logits at a position below C
depend on no dropped assignment, and only there does the replay check the
same computation.  So for a MoE arch the replay defaults to ``min(P, C)``
tokens and a longer one raises; the run reports ``moe_capacity`` (C) and
``moe_dropped``, the assignments the timed prefill dropped over all
layers.

Weights are random, drawn from ``--seed`` with a generator on the run's
device (``transformer_init``); the prompts are drawn from the same seed with
numpy, so they are the same on every device.  Runs on the card by default;
``--device cpu`` runs the plain versions.  One untimed warm-up prefill and
decode step come first.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.registry import get_arch, list_archs
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd
from repro_torch.models.common import count_params
from repro_torch.models.moe import capacity
from repro_torch.models.transformer import (
    Transformer,
    init_decode_cache,
    transformer_apply,
    transformer_decode,
    transformer_init,
)

# The prompt replay's last logits against the prefill's at that position.  The reference
# holds decode to its dense forward elementwise (atol 0.15, rtol 0.1,
# tests/models/test_transformer.py::test_decode_matches_forward): there both
# sides round scores and probabilities to bf16 alike.  On the card the
# prefill's flash kernel keeps them in f32 while decode rounds them, so the
# two are two attention algorithms that round differently, which the
# reference bounds by the logit scale (test_chunked_equals_dense_end_to_end):
# max|replay − prefill| ≤ GAP_SCALE · max|prefill| + GAP_FLOOR.  Both are
# reported; `prompt_gap_ok` is the bound that holds on every device.  With a
# final softcap (gemma2's 30) both are taken on the logits before it: the
# cap is 1-Lipschitz, so it never widens the gap, but it caps the scale the
# bound is relative to (at gemma2-27b's width random weights give
# pre-cap logits in the thousands, and the two roundings of 46 layers
# differ by a few units there, as qwen3's uncapped ones do); the capped
# logits' gap is reported beside it.
GAP_ATOL = 0.15
GAP_RTOL = 0.1
GAP_SCALE = 0.02
GAP_FLOOR = 0.05


def make_prompts(vocab: int, batch: int, prompt_len: int, seed: int,
                 device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, vocab, (batch, prompt_len)),
                           dtype=torch.long).to(device)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _positions(batch: int, pos: int, dev) -> torch.Tensor:
    return torch.full((batch,), pos, dtype=torch.long, device=dev)


@torch.inference_mode()
def serve(model: Transformer, prompts: torch.Tensor, gen_len: int, *,
          replay_len: Optional[int] = None, warmup: int = 1) -> dict:
    """Prefill, replay and greedy decode of ``prompts`` (B, P); returns the
    measurements and the generated ids (see the module docstring).  Runs
    under ``torch.inference_mode()``: no autograd state is kept."""
    cfg = model.cfg
    dev = prompts.device
    B, P = prompts.shape
    C = None if cfg.moe_cfg is None else capacity(cfg.moe_cfg, P)
    R_max = P if C is None else min(P, C)
    R = R_max if replay_len is None else replay_len
    if B < 1 or P < 1 or gen_len < 1 or not 1 <= R <= P:
        raise ValueError(f"need batch, prompt length and gen_len >= 1 and "
                         f"1 <= replay_len <= prompt length, got {B}, {P}, "
                         f"{gen_len}, {R}")
    if R > R_max:
        raise ValueError(
            f"replay_len {R} > the prefill's expert capacity {C}: the "
            f"prefill drops assignments of tokens at positions >= {C}, "
            f"which decode never drops, so the replay would check another "
            f"computation")
    max_seq = P + gen_len
    for _ in range(warmup):
        warm = init_decode_cache(cfg, B, max_seq, device=dev)
        transformer_apply(model, prompts, warm)
        transformer_decode(model, warm, prompts[:, :1], _positions(B, P, dev))
        del warm
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # the final norm's output: the logits before a final softcap
    hidden = {}
    hook = None if cfg.final_softcap is None else \
        model.ln_final.register_forward_hook(
            lambda mod, args, out: hidden.__setitem__("x", out))

    def uncapped(capped, row):
        if hook is None:
            return capped
        return torch.einsum("bd,vd->bv", hidden["x"][:, row],
                            model.embed.to(cfg.dtype)).float()

    # 1. prefill (fills the cache) → first token
    cache = init_decode_cache(cfg, B, max_seq, device=dev)
    launches0 = flash_attention_bhsd.launches
    t0 = time.perf_counter()
    logits, _ = transformer_apply(model, prompts, cache)
    last = logits[:, -1].float()
    capped_at_replay = logits[:, R - 1].float()
    del logits
    next_tok = last.argmax(-1)
    _sync(dev)
    ttft = time.perf_counter() - t0
    prefill_launches = flash_attention_bhsd.launches - launches0
    dropped = None if C is None else int(sum(
        blk.moe.last_dropped for blk in model.layers))
    at_replay = uncapped(capped_at_replay, R - 1)

    # 2. replay R prompt tokens into a fresh cache, against the prefill
    replay_cache = init_decode_cache(cfg, B, R, device=dev)
    t0 = time.perf_counter()
    for i in range(R):
        replay, replay_cache = transformer_decode(
            model, replay_cache, prompts[:, i:i + 1], _positions(B, i, dev))
    _sync(dev)
    replay_s = time.perf_counter() - t0
    del replay_cache
    capped_gap = float((replay[:, 0].float() - capped_at_replay).abs().max())
    replay = uncapped(replay[:, 0].float(), 0)
    if hook is not None:
        hook.remove()
        del hidden["x"]
    diff = (replay - at_replay).abs()
    allclose_ratio = (diff / (GAP_ATOL + GAP_RTOL * at_replay.abs())).max()
    gap_bound = GAP_SCALE * at_replay.abs().max() + GAP_FLOOR

    # 3. greedy decode from the prefill's cache
    toks = [next_tok]
    times = []
    for step in range(gen_len):
        t0 = time.perf_counter()
        step_logits, cache = transformer_decode(
            model, cache, toks[-1][:, None], _positions(B, P + step, dev))
        toks.append(step_logits[:, 0].float().argmax(-1))
        _sync(dev)
        times.append(time.perf_counter() - t0)
    finite = bool(torch.isfinite(last).all() and torch.isfinite(replay).all()
                  and torch.isfinite(step_logits).all())
    ms = np.asarray(times) * 1e3
    return {
        "config": cfg.name,
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "batch": B, "prompt_len": P, "gen_len": gen_len, "replay_len": R,
        "n_params": count_params(model),
        "ttft_s": ttft,
        "prefill_flash_launches": prefill_launches,
        "moe_capacity": C,
        "moe_dropped": dropped,
        "replay_s": replay_s,
        "decode_step_ms_median": float(np.median(ms)),
        "decode_step_ms_p90": float(np.percentile(ms, 90)),
        "decode_tokens_per_s": B * gen_len / (ms.sum() / 1e3),
        "prompt_gap": float(diff.max()),
        "prompt_gap_bound": float(gap_bound),
        "prompt_gap_ok": bool(diff.max() <= gap_bound),
        "prompt_gap_capped": None if hook is None else capped_gap,
        "prompt_allclose_ratio": float(allclose_ratio),
        "logits_finite": finite,
        "tokens": torch.stack(toks, dim=1).cpu().tolist(),
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list_archs("lm"))
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced configuration")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--replay-len", type=int, default=None,
                    help="prompt tokens replayed through decode to check "
                         "the prefill (default: the whole prompt; for a "
                         "MoE arch at most the prefill's expert capacity)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights and the prompts")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card with the flash-attention kernel "
                         "(default) or the CPU with the plain versions")
    ap.add_argument("--json", default=None, help="write the results here")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    arch = get_arch(args.arch)
    cfg = arch.reduced_cfg if args.reduced else arch.cfg
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = transformer_init(cfg, gen, device=dev)
    prompts = make_prompts(cfg.vocab, args.batch, args.prompt_len, args.seed,
                           dev)
    res = {"arch": args.arch, "reduced": args.reduced, "seed": args.seed,
           **serve(model, prompts, args.gen_len,
                   replay_len=args.replay_len)}
    print(f"{res['config']} on {res['device_name']}: batch {res['batch']}, "
          f"prompt {res['prompt_len']}, gen {res['gen_len']}: "
          f"ttft {res['ttft_s'] * 1e3:.1f} ms, decode step median "
          f"{res['decode_step_ms_median']:.2f} ms (p90 "
          f"{res['decode_step_ms_p90']:.2f}), "
          f"{res['decode_tokens_per_s']:.1f} tok/s, "
          f"prompt gap {res['prompt_gap']:.4g} (bound "
          f"{res['prompt_gap_bound']:.4g}; elementwise ratio "
          f"{res['prompt_allclose_ratio']:.3g}), peak "
          f"{res['max_memory_allocated']} B"
          + ("" if res["moe_capacity"] is None else
             f", MoE capacity {res['moe_capacity']}, dropped "
             f"{res['moe_dropped']} assignments"), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
