"""The port's CUDA kernels against their plain torch versions, on the card,
and the serving, DLRM and GraphSAGE paths on the card against the same
runs on the CPU.

Marked ``gpu``: each test asks the ``cuda`` fixture for a device and skips
where ``torch.cuda.is_available()`` is false.  On the card run them with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py`` (the
shared conftest imports JAX, which the card's machine does not have; this
file needs neither JAX nor ``repro``).
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import MatchConfig, MiningConfig, build_graph, mine
from repro_torch.core.graph import DeviceGraph
from repro_torch.core.matcher import _init_roots
from repro_torch.core.mis import bitmap_words
from repro_torch.core.plan import make_plan, stack_plans
from repro_torch.data.synthetic import rmat_graph
from repro_torch.kernels.frontier_expand.kernel import frontier_expand
from repro_torch.kernels.frontier_expand.ops import frontier_expand_level
from repro_torch.kernels.mis_bitmap.kernel import (
    mis_bitmap_select, uses_shared_memory,
)
from repro_torch.configs.qwen3_1_7b import REDUCED as QWEN3_REDUCED
from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd
from repro_torch.launch import serve as t_serve
from repro_torch.models.transformer import transformer_apply, transformer_init
from repro_torch.configs.registry import get_arch
from repro_torch.kernels.embedding_bag.kernel import embedding_bag_tbh
from repro_torch.kernels.gather_aggregate.kernel import gather_aggregate_nf
from repro_torch.models.gnn.graphsage import sage_apply
from repro_torch.testing.parity import (
    AGG_CASES, BAG_CASES, FLASH_CASES, MIS_EDGE_CASES, agg_case, bag_case,
    flash_case, frontier_case, mis_case, mis_edge_case, patterns_by_k,
    random_graph,
)

pytestmark = pytest.mark.gpu

INT32_MAX = np.iinfo(np.int32).max


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _cfg(g, cap=256, root_block=128, chunk=64):
    return dataclasses.replace(
        MatchConfig.for_graph(g, cap=cap, root_block=root_block, chunk=chunk),
        two_phase=False)


@pytest.mark.parametrize("undirected", [True, False])
def test_frontier_levels_k2_to_k5(cuda, undirected):
    g = random_graph(300, 3, 3, seed=1, undirected=undirected)
    cfg = _cfg(g)
    by_k = patterns_by_k(g, 5)
    assert max(by_k) == 5
    for k, pats in by_k.items():
        for bs in (0, cfg.root_block):
            assert frontier_case(g, pats, cfg, cuda, block_start=bs) == 0


def test_frontier_stacked_bucket_multi_chunk(cuda):
    # chunk 4 < max degree: several chunks, so order is chunk-major
    g = random_graph(200, 4, 2, seed=3)
    cfg = _cfg(g, cap=512, chunk=4)
    assert cfg.max_chunks > 1
    for k, pats in patterns_by_k(g, 4, per_level=8).items():
        assert frontier_case(g, pats, cfg, cuda) == 0


@pytest.mark.parametrize("cap", [1000, 16384])
def test_frontier_skewed_degrees(cuda, cap):
    # R-MAT hubs: rows with many chunks beside rows with one; cap 1000 ends
    # inside a row tile, 16384 spans many tiles
    g = rmat_graph(3000, 30000, n_labels=2, seed=4)
    cfg = _cfg(g, cap=cap, root_block=1024, chunk=16)
    assert cfg.max_chunks > 4
    for k, pats in patterns_by_k(g, 3, per_level=8).items():
        assert frontier_case(g, pats, cfg, cuda) == 0


def test_frontier_chunk_above_64_raises(cuda):
    g = random_graph(100, 3, 2, seed=2)
    cfg = _cfg(g, chunk=64)
    with pytest.raises(ValueError, match="chunk"):
        frontier_case(g, patterns_by_k(g, 2)[2],
                      dataclasses.replace(cfg, chunk=128), cuda)


def test_frontier_overflow(cuda):
    g = random_graph(200, 6, 1, seed=5)
    cfg = _cfg(g, cap=64, root_block=128)
    for k, pats in patterns_by_k(g, 3).items():
        assert frontier_case(g, pats, cfg, cuda) == 0


def test_frontier_edgeless(cuda):
    n = 32
    g = build_graph(n, np.zeros((0, 2), np.int64), np.zeros(n, np.int32))
    from repro_torch.core import Pattern
    pat = Pattern(np.array([[False, True], [False, False]]),
                  np.zeros(2, np.int32))
    assert frontier_case(g, [pat], _cfg(g, cap=64, root_block=32), cuda) == 0


def _hub_graph(hub_deg, n=600, seed=0):
    """Directed: vertex 0 points at vertices 1..hub_deg, every other vertex
    at 1-3 random vertices; one label, so every lane's label test passes."""
    rng = np.random.default_rng(seed)
    src = [np.zeros(hub_deg, np.int64)]
    dst = [np.arange(1, hub_deg + 1)]
    outs = rng.integers(1, 4, n - 1)
    src.append(np.repeat(np.arange(1, n), outs))
    dst.append(rng.integers(1, n, int(outs.sum())))
    edges = np.stack([np.concatenate(src), np.concatenate(dst)], 1)
    return build_graph(n, edges, np.zeros(n, np.int32), undirected=False)


@pytest.mark.parametrize("hub_deg,chunk", [(300, 16), (64, 16), (128, 64)])
def test_frontier_hub_row_among_small_rows(cuda, hub_deg, chunk):
    # one hub row (row 0 of the block) in a 256-row tile of rows of degree
    # 1-3: the candidate split spreads it, the order holds; 64 and 128 are
    # exact multiples of the chunk
    g = _hub_graph(hub_deg)
    cfg = _cfg(g, cap=4096, root_block=512, chunk=chunk)
    assert cfg.max_chunks == -(-hub_deg // chunk) > 1
    for k, pats in patterns_by_k(g, 3, per_level=8).items():
        assert frontier_case(g, pats, cfg, cuda) == 0


@pytest.mark.parametrize("cap", [8, 13, 50])
def test_frontier_cap_cut_inside_a_mask(cuda, cap):
    # the hub's first chunk alone holds 16 survivors at level 1, so cap 8
    # and 13 end inside one (row, chunk) mask; found stays uncapped
    g = _hub_graph(300)
    cfg = _cfg(g, cap=cap, root_block=512, chunk=16)
    pats = patterns_by_k(g, 3, per_level=8)
    for k, ps in pats.items():
        assert frontier_case(g, ps, cfg, cuda) == 0
    dg = DeviceGraph.from_host(g, cuda)
    plans = stack_plans([make_plan(p, g) for p in pats[2]], cuda)
    emb, cnt = _init_roots(dg, plans, 0, cfg)
    _, out_count, found, ovf = frontier_expand_level(dg, plans, emb, cnt, 1,
                                                     cfg)
    assert bool(ovf.any()) and int(found.max()) > cap
    assert int(out_count.max()) == cap


def test_frontier_max_chunks_truncates_the_hub(cuda):
    # max_chunks below the hub's 19 chunks: its candidates are cut at
    # max_chunks · chunk, in the kernel as in the plain version
    g = _hub_graph(300)
    cfg = dataclasses.replace(_cfg(g, cap=4096, root_block=512, chunk=16),
                              max_chunks=3)
    for k, pats in patterns_by_k(g, 3, per_level=8).items():
        assert frontier_case(g, pats, cfg, cuda) == 0


def test_mis_tau_cut_and_carry(cuda):
    # P = 4: one τ cut mid-table, one never reached, two in between
    assert mis_case(5000, 4, 1024, 3, 3, seed=7, device=cuda,
                    taus=[50, INT32_MAX, 200, 1], calls=2) == 0


def test_mis_global_bitmap_large_graph(cuda):
    # above the shared-memory limit: the global-memory branch, with a τ cut
    n = 2_000_000
    assert not uses_shared_memory(bitmap_words(n), cuda)
    assert mis_case(n, 3, 4096, 5, 4, seed=11, device=cuda,
                    taus=[INT32_MAX, 300, 1], calls=2) == 0


def test_mis_shared_bitmap_above_48k(cuda):
    n = 1_000_000   # 125 KB of words: the opt-in shared-memory branch
    assert uses_shared_memory(bitmap_words(n), cuda)
    assert mis_case(n, 3, 4096, 3, 3, seed=13, device=cuda,
                    taus=[INT32_MAX, 100, 2000], calls=2) == 0


# a bitmap of 2 M vertices' words lies above the shared-memory limit
GLOBAL_WORDS = bitmap_words(2_000_000)


@pytest.mark.parametrize("bitmap", ["shared", "global"])
@pytest.mark.parametrize("name", MIS_EDGE_CASES)
def test_mis_edge_cases(cuda, name, bitmap):
    words = GLOBAL_WORDS if bitmap == "global" else 0
    assert not uses_shared_memory(GLOBAL_WORDS, cuda)
    assert mis_edge_case(name, cuda, words) == 0


def test_mis_stats_count_rows(cuda):
    # the optional per-pattern stats: rows tested, passed, decided, ns
    n, P, cap, k = 5000, 3, 4096, 3
    rng = np.random.default_rng(3)
    emb = torch.as_tensor(rng.integers(0, n, (P, cap, k)).astype(np.int32),
                          device=cuda)
    nv = torch.tensor([cap, 1000, 0], dtype=torch.int32, device=cuda)
    tau = torch.full((P,), INT32_MAX, dtype=torch.int32, device=cuda)
    stats = torch.zeros((P, 4), dtype=torch.int64, device=cuda)
    mis_bitmap_select(torch.zeros((P, bitmap_words(n)), dtype=torch.int32,
                                  device=cuda),
                      torch.zeros(P, dtype=torch.int32, device=cuda), emb, nv,
                      tau, k=k, stats=stats)
    st = stats.cpu()
    assert st[:, 0].tolist() == [cap, 1000, 0]
    assert (st[:, 1] <= st[:, 0]).all() and (st[:, 2] <= st[:, 1]).all()
    assert st[2].tolist()[:3] == [0, 0, 0] and (st[:2, 3] > 0).all()


@pytest.mark.parametrize("metric", ["mis", "mis_luby", "mni", "frac"])
def test_mine_cuda_equals_cpu(cuda, metric):
    g = random_graph(400, 3, 3, seed=17)
    match = MatchConfig.for_graph(g, cap=2048, root_block=128, chunk=8)
    res = {}
    for dev in ("cpu", "cuda"):
        cfg = MiningConfig(sigma=6, metric=metric, max_pattern_size=4,
                           execution="batched", match=match)
        r = mine(g, cfg, device=dev)
        res[dev] = ([(p.key(), s) for p, s in r.frequent],
                    [(s.support, s.embeddings_found, s.blocks_run,
                      s.overflowed) for s in r.stats])
    assert res["cpu"] == res["cuda"]


@pytest.mark.parametrize("execution", ["batched", "sequential"])
def test_mine_defaults_launch_both_kernels(cuda, execution):
    # the Python API with default settings (device "cuda", default
    # MatchConfig) must reach both kernels, not the plain versions
    g = random_graph(400, 3, 3, seed=19)
    frontier_expand.launches = 0
    mis_bitmap_select.launches = 0
    r = mine(g, MiningConfig(sigma=6, max_pattern_size=3,
                             execution=execution))
    assert r.frequent
    assert frontier_expand.launches > 0
    assert mis_bitmap_select.launches > 0


def _mine_summary(r):
    per_level = {lvl: {k: v for k, v in st.items() if k != "wall_s"}
                 for lvl, st in r.per_level.items()}
    return ([(p.key(), s) for p, s in r.frequent],
            [(s.support, s.embeddings_found, s.blocks_run, s.overflowed,
              s.max_count, s.estimated) for s in r.stats],
            per_level, r.health.to_dict())


@pytest.mark.parametrize("execution", ["auto", "sampled"])
def test_mine_auto_sampled_cuda_equals_cpu(cuda, execution):
    # the planner's decisions, the sample draws, the capture/replay tables
    # and the overflow escalation give the same run on the card as on the
    # CPU (derived caps down to the floor, 13 root blocks to sample)
    g = random_graph(400, 3, 3, seed=17)
    match = MatchConfig.for_graph(g, cap=4096, root_block=32, chunk=8)
    res = {}
    for dev in ("cpu", "cuda"):
        cfg = MiningConfig(sigma=6, max_pattern_size=3, execution=execution,
                           sample_fraction=0.5, match=match)
        res[dev] = _mine_summary(mine(g, cfg, device=dev))
    assert res["cpu"] == res["cuda"]
    assert res["cuda"][0]


def test_sampled_replay_launches_mis_bitmap(cuda):
    # escalation replays the sampled blocks through the mis_bitmap kernel:
    # one launch per matched or replayed step, no block run twice
    from repro_torch.core.batched import evaluate_level_batched
    from repro_torch.core.flexis import initial_candidates
    from repro_torch.core.planner import ExecutionPlanner
    from repro_torch.core.sampled import evaluate_level_sampled

    g = random_graph(400, 3, 3, seed=17)
    match = MatchConfig.for_graph(g, cap=4096, root_block=32, chunk=8)
    cfg = MiningConfig(sigma=6, execution="sampled", sample_fraction=0.5,
                       match=match)
    pats = initial_candidates(g)
    plan = ExecutionPlanner(g, cfg).plan_level(1, pats, [3] * len(pats))
    dev_g = DeviceGraph.from_host(g, "cuda")
    exact, _, _ = evaluate_level_batched(g, dev_g, pats, [1] * len(pats),
                                         "mis", match, complete=True)
    taus = [o.support + 1 for o in exact]    # no early exit in escalation
    counters = {}
    mis_bitmap_select.launches = 0
    outs, timed, tel = evaluate_level_sampled(
        g, dev_g, pats, taus, "mis", match, sample=plan.sample,
        max_batch=64, sample_rounds=1, counters=counters)
    assert not timed and tel.sampled["escalated"] >= 1
    assert counters["replay_blocks"] >= 1
    assert mis_bitmap_select.launches == tel.dispatches
    m = -(-g.n // match.root_block)
    assert counters["replay_blocks"] + counters["match_blocks"] == m
    for o, e in zip(outs, exact):
        if not o.estimated:
            assert (o.support, o.embeddings_found) == (e.support,
                                                       e.embeddings_found)


@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_attention_matches_plain(cuda, case):
    # reference test shapes × {f32, bf16}, MQA, window × softcap, the
    # serving shape, hd 128 window + softcap, non-causal, ragged S
    flash_case(case, cuda)


# bf16 on the tensor cores: S not a multiple of the 128-row query tile or
# the 64-row key tile, every head dim, G = 1, 2, 8, windows that cross a
# tile edge, softcap with a window, non-causal; and the f32 kernel
_F32, _BF16 = torch.float32, torch.bfloat16
FLASH_EDGE_CASES = [
    *[(f"S{S}-hd{hd}-G{G}-bf16", 1, S, 8, 8 // G, hd, _BF16, True, None, None)
      for (S, hd, G) in ((100, 16, 1), (1000, 32, 2), (1100, 64, 8),
                         (100, 128, 2), (1000, 128, 1), (1100, 128, 8),
                         (1000, 16, 8), (1100, 32, 1), (100, 64, 2),
                         (1000, 64, 1), (1100, 16, 2), (100, 32, 8))],
    ("window100-hd64-bf16", 2, 1000, 4, 2, 64, _BF16, True, 100, None),
    ("window100-softcap30-hd128-bf16", 1, 1100, 8, 2, 128, _BF16, True, 100,
     30.0),
    ("window200-softcap20-hd32-bf16", 1, 700, 4, 4, 32, _BF16, True, 200,
     20.0),
    ("non-causal-window60-hd128-bf16", 1, 300, 4, 1, 128, _BF16, False, 60,
     None),
    ("non-causal-hd16-bf16", 2, 260, 2, 2, 16, _BF16, False, None, None),
    ("S1100-hd128-G2-f32", 1, 1100, 4, 2, 128, _F32, True, None, None),
    ("S100-hd16-G8-window30-f32", 1, 100, 8, 1, 16, _F32, True, 30, 30.0),
]


@pytest.mark.parametrize("case", FLASH_EDGE_CASES,
                         ids=[c[0] for c in FLASH_EDGE_CASES])
def test_flash_attention_edge_cases(cuda, case):
    flash_case(case, cuda)


def test_flash_attention_unsupported_head_dim_raises(cuda):
    q = torch.zeros(2, 64, 8, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_bhsd(q, q, q)


def test_cuda_prefill_launches_flash_once_per_layer(cuda):
    cfg = QWEN3_REDUCED
    model = transformer_init(cfg, torch.Generator(device=cuda).manual_seed(0),
                             device=cuda)
    toks = t_serve.make_prompts(cfg.vocab, 2, 40, seed=0, device=cuda)
    before = flash_attention_bhsd.launches
    logits, _ = transformer_apply(model, toks)
    torch.cuda.synchronize()
    assert flash_attention_bhsd.launches - before == cfg.n_layers
    assert torch.isfinite(logits.float()).all()


def test_reduced_serve_cuda_matches_cpu(cuda):
    cfg = QWEN3_REDUCED
    cpu_model = transformer_init(cfg, torch.Generator().manual_seed(0))
    cuda_model = copy.deepcopy(cpu_model).to(cuda)
    prompts = t_serve.make_prompts(cfg.vocab, 4, 64, seed=0, device="cpu")
    want, _ = transformer_apply(cpu_model, prompts)
    got, _ = transformer_apply(cuda_model, prompts.to(cuda))
    got, want = got.float().cpu(), want.float()
    # flash (f32 scores) on the card, dense (bf16 scores) on the CPU: the
    # reference's bound for two bf16 runs that round differently
    assert (got - want).abs().max() <= 0.02 * want.abs().max() + 0.05
    res_cpu = t_serve.serve(cpu_model, prompts, 8)
    res_cuda = t_serve.serve(cuda_model, prompts.to(cuda), 8)
    for res in (res_cpu, res_cuda):
        assert res["logits_finite"]
        assert res["prompt_gap_ok"], (res["prompt_gap"], res["prompt_gap_bound"])
    # on the CPU prefill and decode round alike: the reference's own
    # elementwise decode-vs-forward tolerance holds
    assert res_cpu["prompt_allclose_ratio"] <= 1.0
    assert res_cuda["prefill_flash_launches"] == cfg.n_layers
    assert res_cuda["max_memory_allocated"] > 0
    assert res_cuda["tokens"][0][0] == got[0, -1].argmax().item()


@pytest.mark.parametrize("case", BAG_CASES, ids=[c[0] for c in BAG_CASES])
def test_embedding_bag_matches_plain(cuda, case):
    # f32 / bf16, sum / mean, H 1 (exact) and 4 with pads, T 1 and 26,
    # weights, an odd D
    bag_case(case, cuda)


@pytest.mark.parametrize("case", AGG_CASES, ids=[c[0] for c in AGG_CASES])
def test_gather_aggregate_matches_plain(cuda, case):
    # f32 / bf16, sum / mean, Dmax 1, 15, 40, F 7, 8, 128, 602, ragged N
    agg_case(case, cuda)


def test_bag_and_aggregate_kernels_reject_bad_inputs(cuda):
    tables = torch.zeros(2, 10, 8, device=cuda)
    with pytest.raises(ValueError, match="ids"):
        embedding_bag_tbh(tables, torch.zeros(3, 2, 1, dtype=torch.int64,
                                              device=cuda))
    with pytest.raises(ValueError, match="tables"):
        embedding_bag_tbh(tables, torch.zeros(3, 3, 1, dtype=torch.int32,
                                              device=cuda))
    with pytest.raises(ValueError, match="features"):
        gather_aggregate_nf(torch.zeros(4, 8, dtype=torch.float16,
                                        device=cuda),
                            torch.zeros(4, 2, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("shape", ["serve_p99", "retrieval_cand"])
def test_reduced_dlrm_cuda_matches_cpu(cuda, shape):
    arch = get_arch("dlrm-rm2")
    cpu_model = arch.init(torch.Generator().manual_seed(0), reduced=True,
                          device="cpu")
    cuda_model = copy.deepcopy(cpu_model).to(cuda)
    x = arch.inputs(shape, reduced=True, seed=1, device="cpu")
    step = arch.step_fn(shape)
    args = [x["dense"], x["sparse_idx"]] + (
        [x["candidates"]] if "candidates" in x else [])
    want = step(cpu_model, *args)
    before = embedding_bag_tbh.launches
    got = step(cuda_model, *[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    assert embedding_bag_tbh.launches - before == 1
    if shape == "serve_p99":
        # the bags are exact; cuBLAS and the CPU's bf16 products may round
        # apart: the reference's bf16 tolerance
        torch.testing.assert_close(got.float().cpu(), want.float(),
                                   atol=2e-2, rtol=2e-2)
    else:
        torch.testing.assert_close(got[0].cpu(), want[0], atol=2e-2,
                                   rtol=2e-2)


def test_reduced_sage_cuda_matches_cpu(cuda):
    arch = get_arch("graphsage-reddit")
    cpu_model = arch.init("minibatch_lg", torch.Generator().manual_seed(0),
                          reduced=True, device="cpu")
    cuda_model = copy.deepcopy(cpu_model).to(cuda)
    gb = arch.reduced_inputs("minibatch_lg", device="cpu")
    gb_cuda = arch.reduced_inputs("minibatch_lg", device=cuda)
    want = sage_apply(cpu_model, gb)
    before = gather_aggregate_nf.launches
    got = sage_apply(cuda_model, gb_cuda)
    torch.cuda.synchronize()
    assert gather_aggregate_nf.launches - before == cpu_model.cfg.n_layers
    torch.testing.assert_close(got.float().cpu(), want.float(), atol=2e-2,
                               rtol=2e-2)
    loss = arch.loss_fn("minibatch_lg", reduced=True)(cuda_model, gb_cuda)
    assert torch.isfinite(loss)
