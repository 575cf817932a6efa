"""The port's serving entry point and LM configs, on the CPU.

``python -m repro_torch.launch.serve --device cpu --reduced`` runs the
reference's ``examples/serve_lm.py`` sequence (prefill, prompt replay into
the KV cache, greedy decode) and writes its ``--json``; the replay's last
logits must equal the prefill's within the reference's decode-vs-forward
tolerance (atol 0.15, rtol 0.1): on the CPU both sides round alike.  The port's qwen3-1.7b configs, shapes
and FLOP counts equal the reference's.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import lm as j_lm
from repro.configs import qwen3_1_7b as j_qwen3

from repro_torch.configs import lm as t_lm
from repro_torch.configs import qwen3_1_7b as t_qwen3
from repro_torch.configs.registry import get_arch, list_archs
from repro_torch.interop import transformer_config_from
from repro_torch.launch import serve as t_serve
from repro_torch.models.transformer import transformer_init

REPO = Path(__file__).resolve().parents[1]


def test_serve_cli_cpu_reduced(tmp_path):
    out = tmp_path / "serve.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--reduced", "--batch", "2", "--prompt-len", "24", "--gen-len", "5",
         "--replay-len", "16", "--seed", "3", "--json", str(out)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(out.read_text())
    assert (res["arch"], res["config"], res["device"]) == \
        ("qwen3-1.7b", "qwen3-1.7b-reduced", "cpu")
    assert (res["batch"], res["prompt_len"], res["gen_len"],
            res["replay_len"]) == (2, 24, 5, 16)
    assert res["logits_finite"]
    # on the CPU prefill and decode round alike: the reference's own
    # elementwise tolerance holds, and so does the logit-scale bound
    assert res["prompt_allclose_ratio"] <= 1.0, res["prompt_gap"]
    assert res["prompt_gap_ok"] and res["prompt_gap_bound"] >= 0.05
    assert res["prefill_flash_launches"] == 0        # the CPU takes ref.py
    assert res["max_memory_allocated"] is None
    toks = np.asarray(res["tokens"])
    assert toks.shape == (2, 6) and (0 <= toks).all() and (toks < 512).all()
    assert res["ttft_s"] > 0 and res["decode_step_ms_median"] > 0
    assert res["decode_step_ms_p90"] >= res["decode_step_ms_median"]


def test_serve_is_deterministic_and_greedy():
    cfg = t_qwen3.REDUCED
    model = transformer_init(cfg, torch.Generator().manual_seed(0))
    prompts = t_serve.make_prompts(cfg.vocab, 2, 10, seed=0, device="cpu")
    a = t_serve.serve(model, prompts, 4, warmup=0)
    b = t_serve.serve(model, prompts, 4, warmup=0)
    assert a["tokens"] == b["tokens"]
    assert a["prompt_gap"] == b["prompt_gap"]
    # the first token is the prefill's argmax at the last prompt position
    from repro_torch.models.transformer import transformer_apply
    logits, _ = transformer_apply(model, prompts)
    assert [t[0] for t in a["tokens"]] == logits[:, -1].float().argmax(-1).tolist()


def test_serve_decodes_as_the_example_does():
    # examples/serve_lm.py decodes from the cache its replay filled; serve()
    # decodes from the cache its prefill filled: the same tokens
    from repro_torch.models.transformer import (
        init_decode_cache, transformer_decode,
    )
    cfg = t_qwen3.REDUCED
    model = transformer_init(cfg, torch.Generator().manual_seed(4))
    B, P, gen = 2, 12, 5
    prompts = t_serve.make_prompts(cfg.vocab, B, P, seed=4, device="cpu")
    got = t_serve.serve(model, prompts, gen, warmup=0)
    assert got["replay_len"] == P and got["prompt_allclose_ratio"] <= 1.0
    cache = init_decode_cache(cfg, B, P + gen)
    for i in range(P):
        logits, cache = transformer_decode(model, cache, prompts[:, i:i + 1],
                                           torch.full((B,), i))
    toks = [logits[:, 0].float().argmax(-1)]
    for step in range(gen):
        logits, cache = transformer_decode(model, cache, toks[-1][:, None],
                                           torch.full((B,), P + step))
        toks.append(logits[:, 0].float().argmax(-1))
    assert got["tokens"] == torch.stack(toks, 1).tolist()


@pytest.mark.parametrize("replay_len", [0, 13])
def test_serve_rejects_bad_replay_len(replay_len):
    cfg = t_qwen3.REDUCED
    model = transformer_init(cfg, torch.Generator().manual_seed(0))
    prompts = t_serve.make_prompts(cfg.vocab, 1, 12, seed=0, device="cpu")
    with pytest.raises(ValueError, match="replay_len"):
        t_serve.serve(model, prompts, 2, replay_len=replay_len, warmup=0)


def test_serve_defaults_to_cuda_and_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        t_serve.main(["--reduced"])


@pytest.mark.parametrize("name", ["CONFIG", "REDUCED"])
def test_qwen3_configs_equal_reference(name):
    want = transformer_config_from(getattr(j_qwen3, name))
    assert getattr(t_qwen3, name) == want
    assert not hasattr(getattr(t_qwen3, name), "use_flash")


def test_registry():
    arch = get_arch("qwen3-1.7b")
    assert arch.name == "qwen3-1.7b" and arch.cfg is t_qwen3.CONFIG
    assert get_arch("dlrm-rm2").name == "dlrm-rm2"
    assert get_arch("graphsage-reddit").name == "graphsage-reddit"
    assert list_archs("lm") == ["qwen3-1.7b"]
    assert list_archs("recsys") == ["dlrm-rm2"]
    assert list_archs("gnn") == ["graphsage-reddit"]
    for other in ("mixtral-8x7b", "qwen3-moe-30b-a3b", "gemma2-27b",
                  "minitron-4b", "schnet"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_arch(other)
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


@pytest.mark.parametrize("shape", list(j_lm.LM_SHAPES))
def test_shapes_and_model_flops_equal_reference(shape):
    j_arch, t_arch = j_qwen3.ARCH, t_qwen3.ARCH
    assert dataclasses.asdict(t_lm.LM_SHAPES[shape]) == \
        dataclasses.asdict(j_lm.LM_SHAPES[shape])
    assert t_arch.model_flops(shape) == j_arch.model_flops(shape)
    assert t_arch.skip_reason(shape) is None or \
        j_arch.skip_reason(shape) is not None
    assert callable(t_arch.step_fn(shape))


def test_prefill_and_decode_steps():
    cfg = t_qwen3.REDUCED
    model = transformer_init(cfg, torch.Generator().manual_seed(1))
    toks = t_serve.make_prompts(cfg.vocab, 2, 8, seed=1, device="cpu")
    last = t_lm.prefill_step(model, toks)
    assert last.shape == (2, cfg.vocab)
    from repro_torch.models.transformer import init_decode_cache
    cache = init_decode_cache(cfg, 2, 8)
    for i in range(8):
        logits, cache = t_lm.decode_step(model, cache, toks[:, i:i + 1],
                                         torch.full((2,), i))
    assert np.allclose(logits[:, 0].float().numpy(), last.float().numpy(),
                       atol=0.15, rtol=0.1)
