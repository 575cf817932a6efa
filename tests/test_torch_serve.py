"""The port's serving entry point and LM configs, on the CPU.

``python -m repro_torch.launch.serve --device cpu --reduced`` runs the
reference's ``examples/serve_lm.py`` sequence (prefill, prompt replay into
the KV cache, greedy decode) and writes its ``--json``; the replay's last
logits must equal the prefill's within the reference's decode-vs-forward
tolerance (atol 0.15, rtol 0.1): on the CPU both sides round alike.  The
port's LM configs (qwen3-1.7b, minitron-4b, gemma2-27b, qwen3-moe-30b-a3b,
mixtral-8x7b), their parameter counts, shapes and FLOP counts equal the
reference's; a MoE arch's replay stops at the prefill's expert capacity.
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

from repro.configs import gemma2_27b as j_gemma2
from repro.configs import lm as j_lm
from repro.configs import minitron_4b as j_minitron
from repro.configs import mixtral_8x7b as j_mixtral
from repro.configs import qwen3_1_7b as j_qwen3
from repro.configs import qwen3_moe_30b_a3b as j_qwen3_moe

from repro_torch.configs import lm as t_lm
from repro_torch.configs import qwen3_1_7b as t_qwen3
from repro_torch.configs.registry import get_arch, list_archs
from repro_torch.interop import transformer_config_from
from repro_torch.launch import serve as t_serve
from repro_torch.models.moe import capacity
from repro_torch.models.transformer import transformer_apply, transformer_init

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


LM_ARCHS = {"qwen3-1.7b": j_qwen3, "minitron-4b": j_minitron,
            "gemma2-27b": j_gemma2, "qwen3-moe-30b-a3b": j_qwen3_moe,
            "mixtral-8x7b": j_mixtral}


def test_registry():
    arch = get_arch("qwen3-1.7b")
    assert arch.name == "qwen3-1.7b" and arch.cfg is t_qwen3.CONFIG
    assert get_arch("dlrm-rm2").name == "dlrm-rm2"
    assert get_arch("graphsage-reddit").name == "graphsage-reddit"
    assert sorted(list_archs("lm")) == sorted(LM_ARCHS)
    for name in LM_ARCHS:
        assert get_arch(name).name == name and get_arch(name).family == "lm"
    assert list_archs("recsys") == ["dlrm-rm2"]
    assert list_archs("gnn") == ["graphsage-reddit", "schnet", "nequip",
                                 "graphcast"]
    for other in ("schnet", "nequip", "graphcast"):
        assert get_arch(other).name == other
        assert get_arch(other).family == "gnn"
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


@pytest.mark.parametrize("name", [n for n in LM_ARCHS if n != "qwen3-1.7b"])
def test_lm_arch_configs_and_counts_equal_reference(name):
    j_arch, t_arch = LM_ARCHS[name].ARCH, get_arch(name)
    for j_cfg, t_cfg in ((j_arch.cfg, t_arch.cfg),
                         (j_arch.reduced_cfg, t_arch.reduced_cfg)):
        assert t_cfg == transformer_config_from(j_cfg)
        assert not hasattr(t_cfg, "use_flash")
        assert t_cfg.param_count() == j_cfg.param_count()
        assert t_cfg.active_param_count() == j_cfg.active_param_count()
        if j_cfg.n_experts:
            assert dataclasses.asdict(t_cfg.moe_cfg) == \
                dataclasses.asdict(j_cfg.moe_cfg)
    assert t_arch.sub_quadratic == j_arch.sub_quadratic
    for shape in j_lm.LM_SHAPES:
        assert t_arch.model_flops(shape) == j_arch.model_flops(shape)
        assert (t_arch.skip_reason(shape) is None) == \
            (j_arch.skip_reason(shape) is None)


def test_serve_moe_replays_up_to_capacity(tmp_path):
    """qwen3-moe reduced at a 48-token prompt: capacity 16 of an average
    load of 12 assignments an expert, and seed 3 drops some."""
    flags = ["--arch", "qwen3-moe-30b-a3b", "--reduced", "--device", "cpu",
             "--batch", "2", "--prompt-len", "48", "--gen-len", "3",
             "--seed", "3"]
    out = tmp_path / "moe.json"
    assert t_serve.main(flags + ["--json", str(out)]) == 0
    res = json.loads(out.read_text())
    cfg = get_arch("qwen3-moe-30b-a3b").reduced_cfg
    C = capacity(cfg.moe_cfg, 48)
    assert res["moe_capacity"] == C == 16
    assert res["replay_len"] == min(48, C)
    assert res["prompt_gap_ok"] and res["logits_finite"]
    # the dropped assignments, recounted from the prefill's routing: an
    # expert keeps C of the assignments routed to it in a row
    model = transformer_init(cfg, torch.Generator().manual_seed(3))
    prompts = t_serve.make_prompts(cfg.vocab, 2, 48, seed=3, device="cpu")
    routes = []
    for blk in model.layers:
        blk.moe.register_forward_hook(
            lambda mod, args, out: routes.append(mod.route(args[0])))
    transformer_apply(model, prompts)
    dropped = sum(int((r.counts - C).clamp(min=0).sum()) for r in routes)
    assert res["moe_dropped"] == dropped > 0
    with pytest.raises(ValueError, match="expert capacity 16"):
        t_serve.main(flags + ["--replay-len", "17"])
    # a dense arch reports no capacity
    dense = t_serve.serve(transformer_init(t_qwen3.REDUCED,
                                           torch.Generator().manual_seed(0)),
                          prompts, 2, warmup=0)
    assert dense["moe_capacity"] is None and dense["moe_dropped"] is None


def test_serve_gap_is_taken_before_the_final_softcap():
    """gemma2's final softcap (30) bounds its logits; the replay check
    compares the logits before it (the cap is 1-Lipschitz: the capped
    gap is never larger)."""
    cfg = get_arch("gemma2-27b").reduced_cfg
    model = transformer_init(cfg, torch.Generator().manual_seed(2))
    prompts = t_serve.make_prompts(cfg.vocab, 2, 20, seed=2, device="cpu")
    res = t_serve.serve(model, prompts, 2, replay_len=20, warmup=0)
    logits, _ = transformer_apply(model, prompts)
    assert res["prompt_gap_bound"] > 0.02 * float(logits.float().abs().max())
    assert res["prompt_gap_capped"] <= res["prompt_gap"] + 1e-6
    assert res["prompt_gap_ok"] and res["prompt_allclose_ratio"] <= 1.0
    dense = t_serve.serve(transformer_init(t_qwen3.REDUCED,
                                           torch.Generator().manual_seed(0)),
                          prompts, 2, warmup=0)
    assert dense["prompt_gap_capped"] is None


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
