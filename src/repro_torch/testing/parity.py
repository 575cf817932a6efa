"""Kernel-vs-plain parity cases, shared by the card tests and ``chip_smoke.py``.

Every case is built from a numpy seed, runs the CUDA kernel and its plain
torch version on the same device tensors, and compares every output.  The
mining kernels compute integers and bits, so their tolerance is zero; so
is the gather-aggregate's, whose kernel adds the plain version's f32
terms in its order; the flash-attention and embedding-bag kernels are held
to `FLASH_TOL` and `BAG_TOL` (the reference's own kernel tests'
tolerances; an embedding bag of one id per bag is held to zero).  The
training path's backward kernels (flash attention's backward, the bag's
and the aggregate's transposes) are held to autograd of the plain
forward on f32 copies of the inputs, within `FLASH_BWD_TOL`, `BAG_BWD_TOL`
and `AGG_T_TOL`, and must give the same bytes on a second launch.  Each
``*_case`` function returns the largest absolute difference it saw and
raises ``AssertionError`` on any mismatch.  The GNN archs launch no
kernel of their own; `gnn_card_against_cpu` holds a model on the card to
a CPU copy of it.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core.flexis import initial_candidates
from ..core.generation import generate_new_patterns
from ..core.graph import DataGraph, DeviceGraph, build_graph
from ..core.matcher import MatchConfig, _init_roots, edge_exists
from ..core.mis import bitmap_words, mis_greedy_update
from ..core.pattern import Pattern
from ..core.plan import make_plan, stack_plans
from ..kernels.embedding_bag.ops import embedding_bag
from ..kernels.embedding_bag.ref import embedding_bag_ref
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.flash_attention.ref import flash_attention_ref
from ..kernels.frontier_expand.ops import frontier_expand_level
from ..kernels.frontier_expand.ref import frontier_expand_ref
from ..kernels.gather_aggregate.kernel import LONG_ROW
from ..kernels.gather_aggregate.ops import (gather_aggregate,
                                            gather_aggregate_csr,
                                            padded_to_csr)
from ..kernels.gather_aggregate.ref import (gather_aggregate_csr_ref,
                                            gather_aggregate_ref)
from ..kernels.mis_bitmap.kernel import mis_bitmap_select

__all__ = ["random_graph", "patterns_by_k", "frontier_case", "mis_case",
           "MIS_EDGE_CASES", "mis_edge_inputs", "mis_edge_case",
           "max_abs_diff", "frontier_work", "mis_rows_scanned",
           "FLASH_CASES", "FLASH_TOL", "flash_inputs", "flash_case",
           "BAG_CASES", "BAG_TOL", "bag_case", "AGG_CASES", "AGG_TOL",
           "agg_case", "AGG_CSR_CASES", "AGG_CSR_T_CASES", "LONG_GEOMETRIES",
           "agg_long_inputs",
           "agg_csr_case", "agg_csr_t_case",
           "FLASH_BWD_CASES", "FLASH_BWD_TOL", "flash_bwd_case",
           "BAG_BWD_CASES", "BAG_BWD_TOL", "bag_bwd_case", "AGG_T_CASES",
           "AGG_T_TOL", "agg_t_case", "grads_close", "ADAMW_CASES",
           "adamw_case", "GNN_OUT_TOL", "gnn_card_against_cpu"]


def random_graph(n: int, deg: int, n_labels: int, seed: int,
                 undirected: bool = True) -> DataGraph:
    """``deg`` random out-edges per vertex, random labels (numpy seed)."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, n * deg)
    labels = rng.integers(0, n_labels, n)
    return build_graph(n, np.stack([src, dst], 1), labels,
                       undirected=undirected)


def patterns_by_k(g: DataGraph, max_k: int, per_level: int = 6) -> dict:
    """Connected candidate patterns of each size 2..max_k, grown by merge
    from the graph's edge patterns (no support filter)."""
    out = {2: initial_candidates(g)[:per_level]}
    for k in range(3, max_k + 1):
        nxt = generate_new_patterns(out[k - 1])[:per_level]
        if not nxt:
            break
        out[k] = nxt
    return out


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def frontier_case(g: DataGraph, patterns: Sequence[Pattern], cfg: MatchConfig,
                  device, block_start: int = 0) -> int:
    """Expand one bucket through every level with the kernel and the plain
    version, feeding both the plain version's frontier; compare each level.
    ``patterns`` share one k.  Returns the max abs difference (0)."""
    dev_g = DeviceGraph.from_host(g, device)
    plans = stack_plans([make_plan(p, g) for p in patterns], dev_g.device)
    emb, count = _init_roots(dev_g, plans, block_start, cfg)
    worst = 0
    for level in range(1, plans.k):
        got = frontier_expand_level(dev_g, plans, emb, count, level, cfg)
        ref = frontier_expand_ref(dev_g, plans, emb, count, level, cfg)
        torch.cuda.synchronize()
        for name, a, b in zip(("emb", "count", "found", "ovf"), got, ref):
            d = max_abs_diff(a, b)
            if d:
                raise AssertionError(
                    f"frontier_expand level {level} (k={plans.k}, "
                    f"P={len(patterns)}): {name} differs by {d}")
            worst = max(worst, d)
        emb, count = ref[0], ref[1]
    return worst


def mis_case(n: int, P: int, cap: int, K: int, k: int, seed: int, device,
             taus: List[int], fill: float = 0.8, calls: int = 2) -> int:
    """Greedy mIS kernel vs plain version over ``calls`` chained calls
    (bitmap and count carried), on random rows of distinct vertices.
    Returns the max abs difference (0)."""
    rng = np.random.default_rng(seed)
    Nw = bitmap_words(n)
    bm_k = bm_r = torch.zeros((P, Nw), dtype=torch.int32, device=device)
    cnt_k = cnt_r = torch.zeros(P, dtype=torch.int32, device=device)
    tau = torch.tensor(taus, dtype=torch.int32, device=device)
    worst = 0
    for _ in range(calls):
        emb = np.full((P, cap, K), -1, np.int32)
        nv = rng.integers(int(cap * fill) // 2, int(cap * fill) + 1, P)
        for p in range(P):
            # k distinct vertices per row, drawn from a window so rows collide
            base = rng.integers(0, max(1, n - 4 * cap), nv[p])[:, None]
            off = np.argsort(rng.random((nv[p], 4 * k)), 1)[:, :k]
            emb[p, :nv[p], :k] = np.minimum(base + off * (cap // 8 + 1), n - 1)
        emb_t = torch.as_tensor(emb, device=device)
        nv_t = torch.as_tensor(nv.astype(np.int32), device=device)
        bm_k, cnt_k = mis_bitmap_select(bm_k, cnt_k, emb_t, nv_t, tau, k=k)
        bm_r, cnt_r = mis_greedy_update(bm_r, cnt_r, emb_t, nv_t, tau, k)
        torch.cuda.synchronize()
        for name, a, b in (("bitmap", bm_k, bm_r), ("count", cnt_k, cnt_r)):
            d = max_abs_diff(a, b)
            if d:
                raise AssertionError(
                    f"mis_bitmap (n={n}, P={P}, cap={cap}): {name} "
                    f"differs by {d}")
            worst = max(worst, d)
    return worst


INT32_MAX = 2**31 - 1
# Adversarial greedy-mIS inputs (`mis_edge_inputs`): conflict chains
# thousands of rows long, every row on one vertex, duplicate vertices in a
# row (−1 among a valid row's first k columns, whole rows of −1), τ cuts
# that fall inside a batch of 32 rows, count ≥ τ at entry, n_valid ≤ 0 and
# > cap, k = 1 and k = 16.
MIS_EDGE_CASES = ["chain", "one-vertex", "duplicates", "tau-in-batch",
                  "count-at-tau", "n-valid-edges", "k1", "k16"]


def _distinct_rows(rng, rows: int, n: int, k: int) -> np.ndarray:
    """``rows`` rows of k distinct vertices of [0, n)."""
    return np.stack([rng.choice(n, k, replace=False) for _ in range(rows)])


def mis_edge_inputs(name: str, seed: int = 0) -> dict:
    """One of `MIS_EDGE_CASES` as numpy arrays: ``n``, ``k``, ``emb`` (P,
    cap, K) int32 (−1 past n_valid and past column k), ``n_valid``,
    ``tau``, ``count`` (P,) int32, ``bitmap`` (P, ⌈n/32⌉) int32 words and
    ``distinct`` (every valid row holds k distinct vertices, as the
    reference's scan assumes)."""
    rng = np.random.default_rng(seed)
    distinct = True
    bits = {}
    if name == "chain":
        # row i shares a vertex with rows i − 1 and i + 1; pattern 1 walks
        # the chain backwards
        k, K, cap = 2, 3, 6144
        n = cap + 1
        i = np.arange(cap)
        emb = np.full((2, cap, K), -1, np.int32)
        emb[0, :, 0], emb[0, :, 1] = i, i + 1
        emb[1, :, 0], emb[1, :, 1] = cap - i, cap - 1 - i
        nv, tau, cnt = [cap, cap - 7], [INT32_MAX, 1000], [0, 0]
    elif name == "one-vertex":
        # every row holds vertex 7, in a random column
        k, K, cap, n = 3, 3, 4096, 5000
        emb = np.zeros((3, cap, K), np.int32)
        for p in range(3):
            others = _distinct_rows(rng, cap, n - 8, 2) + 8
            emb[p] = np.concatenate([np.full((cap, 1), 7), others], 1)
            emb[p] = np.take_along_axis(
                emb[p], np.argsort(rng.random((cap, K)), 1), 1)
        nv, tau, cnt = [cap, cap, 3000], [INT32_MAX, 1, INT32_MAX], [0, 0, 5]
        bits[2] = [7]
    elif name == "duplicates":
        # vertices drawn with replacement from a small window, 15 % of the
        # first k columns −1 (clipped to 0), some valid rows all −1
        distinct = False
        k, K, cap, n = 4, 5, 2048, 300
        emb = np.full((3, cap, K), -1, np.int32)
        emb[:, :, :k] = rng.integers(0, n, (3, cap, k))
        emb[:, :, :k][rng.random((3, cap, k)) < 0.15] = -1
        emb[:, rng.integers(0, cap, 40), :k] = -1
        nv, tau, cnt = [cap, 1500, 2000], [INT32_MAX, 10, INT32_MAX], [0, 0, 0]
    elif name == "tau-in-batch":
        # rows of a large graph hardly collide: the τ-th take falls inside
        # a batch of 32 rows
        k, K, cap, n = 3, 3, 1024, 200_000
        emb = np.stack([_distinct_rows(rng, cap, n, k) for _ in range(6)]
                       ).astype(np.int32)
        nv = [cap] * 6
        tau, cnt = [1, 17, 31, 32, 33, 95], [0, 0, 0, 0, 0, 3]
    elif name == "count-at-tau":
        k, K, cap, n = 3, 3, 512, 1000
        emb = np.stack([_distinct_rows(rng, cap, n, k) for _ in range(4)]
                       ).astype(np.int32)
        nv, tau, cnt = [cap] * 4, [5, 3, 0, -1], [5, 9, 0, 2]
    elif name == "n-valid-edges":
        k, K, cap, n = 3, 3, 512, 1000
        emb = np.stack([_distinct_rows(rng, cap, n, k) for _ in range(4)]
                       ).astype(np.int32)
        nv, tau, cnt = [0, -5, cap + 100, INT32_MAX], [INT32_MAX] * 4, [0] * 4
    elif name == "k1":
        k, K, cap, n = 1, 1, 2048, 500
        emb = rng.integers(0, n, (2, cap, K)).astype(np.int32)
        nv, tau, cnt = [cap, 2000], [INT32_MAX, 100], [0, 0]
    elif name == "k16":
        k, K, cap, n = 16, 16, 1024, 3000
        emb = np.stack([_distinct_rows(rng, cap, n, k) for _ in range(2)]
                       ).astype(np.int32)
        nv, tau, cnt = [cap, 1000], [INT32_MAX, 20], [0, 0]
    else:
        raise ValueError(f"unknown mIS edge case {name!r}")
    P, cap = emb.shape[:2]
    for p in range(P):
        emb[p, max(min(nv[p], cap), 0):] = -1
    words = np.zeros((P, bitmap_words(n)), np.uint32)
    for p, vs in bits.items():
        for v in vs:
            words[p, v >> 5] |= np.uint32(1 << (v & 31))
    i32 = lambda a: np.asarray(a, np.int64).astype(np.int32)
    return {"n": n, "k": k, "emb": emb.astype(np.int32), "n_valid": i32(nv),
            "tau": i32(tau), "count": i32(cnt), "bitmap": words.view(np.int32),
            "distinct": distinct}


def mis_edge_case(name: str, device, words: int = 0) -> int:
    """Greedy mIS kernel vs plain version on `mis_edge_inputs(name)`, the
    bitmap widened to ``words`` words if that is more (a global-memory
    bitmap above the shared-memory limit).  Returns the max abs
    difference (0)."""
    c = mis_edge_inputs(name)
    bm = np.zeros((c["bitmap"].shape[0], max(words, c["bitmap"].shape[1])),
                  np.int32)
    bm[:, :c["bitmap"].shape[1]] = c["bitmap"]
    args = [torch.as_tensor(a, device=device)
            for a in (bm, c["count"], c["emb"], c["n_valid"], c["tau"])]
    got = mis_bitmap_select(*args, k=c["k"])
    want = mis_greedy_update(*args, c["k"])
    torch.cuda.synchronize()
    for what, a, b in (("bitmap", got[0], want[0]), ("count", got[1], want[1])):
        d = max_abs_diff(a, b)
        if d:
            raise AssertionError(f"mis_bitmap edge case {name} ({bm.shape[1]} "
                                 f"words): {what} differs by {d}")
    return 0


def frontier_work(g: DeviceGraph, plans, emb, count, level: int,
                  cfg: MatchConfig) -> Tuple[int, int, int]:
    """(live lanes, bisection steps, random loads) one expansion level needs
    on these inputs.  Live lanes: each valid row's anchor neighbours, up to
    max_chunks · chunk of them.  Bisection steps: for each lane that passes
    the label, degree and injectivity filters, ``bisect_iters + 1`` steps
    per edge check, up to the first check that fails (the kernel's order:
    out-check then in-check of each earlier column).  Random loads: the 4-byte
    graph reads at data-dependent addresses, in the kernel's order with its
    early exits: a lane's candidate id and label, four indptr words past the
    label test, two indptr words and the steps of each edge check run."""
    P, cap, k = emb.shape
    dev, n, C, i = emb.device, g.n, cfg.chunk, level
    indices_cat = torch.cat([g.out_indices, g.in_indices])
    last = indices_cat.shape[0] - 1
    out_deg = g.out_indptr[1:] - g.out_indptr[:-1]
    in_deg = g.in_indptr[1:] - g.in_indptr[:-1]
    a = emb.gather(2, plans.anchor_pos[:, i].long().view(P, 1, 1)
                   .expand(P, cap, 1))[..., 0].clamp(0, n - 1).long()
    use_out = plans.anchor_out[:, i][:, None]
    start = torch.where(use_out, g.out_indptr[a],
                        g.in_indptr[a] + g.out_indices.shape[0])
    deg = torch.where(use_out, out_deg[a], in_deg[a])
    valid = torch.arange(cap, device=dev)[None] < count[:, None]
    lanes = steps = loads = 0
    for c in range(cfg.max_chunks):
        off = c * C + torch.arange(C, device=dev)
        p, r, lane = (valid[..., None] & (off < deg[..., None])).nonzero(
            as_tuple=True)
        if p.numel() == 0:
            break           # degrees only run out as chunks advance
        lanes += p.numel()
        cand = indices_cat[(start[p, r] + off[lane]).clamp(0, last).long()]
        cs = cand.clamp(0, n - 1).long()
        label_ok = g.labels[cs] == plans.cand_label[p, i]
        loads += 2 * p.numel() + 4 * int(label_ok.sum())
        m = (label_ok
             & (out_deg[cs] >= plans.min_out[p, i])
             & (in_deg[cs] >= plans.min_in[p, i]))
        for j in range(i):
            m &= cand != emb[p, r, j]
        p, r, cs = p[m], r[m], cs[m].to(torch.int32)
        alive = torch.ones_like(p, dtype=torch.bool)
        for j in range(i):
            prev = emb[p, r, j].clamp(0, n - 1)
            for need, u, v in ((plans.check_out[p, i, j], cs, prev),
                               (plans.check_in[p, i, j], prev, cs)):
                run = int((alive & need).sum())
                steps += run * (cfg.bisect_iters + 1)
                loads += run * (cfg.bisect_iters + 1 + 2)
                alive &= ~need | edge_exists(g.out_indptr, g.out_indices, u,
                                             v, cfg.bisect_iters)
    return lanes, steps, loads


def mis_rows_scanned(emb, n_valid, tau, k: int) -> int:
    """Rows a greedy-mIS update from an empty bitmap reads on these inputs:
    each pattern's valid rows up to the one that brings its count to τ."""
    rows = emb[:, :, :k].clamp(min=0).cpu().numpy()
    total = 0
    for p, (nv, t) in enumerate(zip(n_valid.tolist(), tau.tolist())):
        used, cnt, r = set(), 0, 0
        while r < min(max(nv, 0), rows.shape[1]) and cnt < t:
            vs = rows[p, r].tolist()
            if used.isdisjoint(vs):
                used.update(vs)
                cnt += 1
            r += 1
        total += r
    return total


# flash attention: (name, B, S, H, KV, hd, dtype, causal, window, softcap).
# The reference's kernel-test cases (tests/kernels/test_kernels.py), the
# serving path's qwen3-1.7b shape, a windowed and soft-capped hd 128 case,
# a non-causal one and ragged sequence lengths (not a multiple of 64).
_F32, _BF16 = torch.float32, torch.bfloat16
FLASH_CASES = [
    *[(f"B{B}-S{S}-H{H}-KV{KV}-hd{hd}-{str(dt)[6:]}", B, S, H, KV, hd, dt,
       True, None, None)
      for B, S, H, KV, hd in ((1, 64, 2, 2, 16), (2, 128, 4, 2, 32),
                              (1, 256, 8, 4, 16), (2, 64, 4, 1, 64))
      for dt in (_F32, _BF16)],
    *[(f"window{w}-softcap{c}", 2, 128, 4, 2, 32, _F32, True, w, c)
      for w in (16, 64) for c in (None, 30.0)],
    ("qwen3-1.7b", 1, 1024, 16, 8, 128, _BF16, True, None, None),
    ("window512-softcap50", 1, 2048, 16, 8, 128, _BF16, True, 512, 50.0),
    ("non-causal", 2, 192, 4, 2, 64, _F32, False, None, None),
    ("ragged", 2, 1000, 4, 2, 64, _F32, True, None, None),
    ("ragged-window-softcap", 1, 100, 2, 1, 16, _BF16, True, 16, 30.0),
]
# bf16: the output's own rounding; f32: summation order
FLASH_TOL = {_F32: 1e-5, _BF16: 2e-2}


def flash_inputs(B, S, H, KV, hd, dtype, device, seed=0):
    """q (B, S, H, hd), k / v (B, S, KV, hd): N(0, 1) from a numpy seed."""
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)
                 .to(device=device, dtype=dtype)
                 for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))


def flash_case(case, device, seed=0) -> float:
    """`flash_attention` against its plain version on ``device``; returns
    the largest absolute difference, raises past `FLASH_TOL`."""
    name, B, S, H, KV, hd, dtype, causal, window, softcap = case
    q, k, v = flash_inputs(B, S, H, KV, hd, dtype, device, seed)
    got = flash_attention(q, k, v, causal=causal, window=window,
                          softcap=softcap).float()
    want = flash_attention_ref(q, k, v, causal=causal, window=window,
                               softcap=softcap).float()
    tol = FLASH_TOL[dtype]
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=tol, rtol=tol):
        raise AssertionError(f"flash_attention {name}: max abs err {err} "
                             f"past atol = rtol = {tol}")
    return err


def _close_or_raise(name: str, got: torch.Tensor, want: torch.Tensor,
                    tol: float) -> float:
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    ok = torch.equal(got, want) if tol == 0 else \
        torch.allclose(got, want, atol=tol, rtol=tol)
    if not ok:
        raise AssertionError(f"{name}: max abs err {err} past atol = rtol = "
                             f"{tol}")
    return err


# embedding bag: (name, T, R, D, B, H, dtype, mean, weighted, over,
# offset).  Ids are drawn from [-1, R), or from [-1, R + R/4) where
# ``over`` (ids ≥ R are skipped like pads), so bags hold pads; H = 1 and
# H = 4, one table, three and DLRM's 26, both combiners, with and without
# weights; DLRM's D = 64 and D = 8, 72, 128 on the 16-byte path (one, nine
# and sixteen 16-byte chunks in bf16), an odd D = 9 on the narrow path; B·T
# of 183 and 1 586, not a multiple of the bags a warp serves at once; and
# the tables as a view ``offset`` elements into their storage, which is
# not 16-byte aligned and takes the narrow path.
def _bag(T, D, B, H, dt, mean, w, over=False, offset=0):
    return (f"T{T}-H{H}-D{D}{f'-B{B}' if B != 64 else ''}-{str(dt)[6:]}-"
            f"{'mean' if mean else 'sum'}"
            f"{'-weighted' if w else ''}{'-over' if over else ''}"
            f"{f'-offset{offset}' if offset else ''}",
            T, 1000, D, B, H, dt, mean, w, over, offset)


BAG_CASES = [
    *[_bag(T, D, 64, H, dt, mean, w)
      for T in (1, 26) for H in (1, 4) for dt in (_F32, _BF16)
      for mean in (False, True) for w in (False, True) for D in (64, 9)
      if D == 64 or (T == 1 and not w)],
    *[c for D in (8, 72, 128) for dt in (_F32, _BF16)
      for c in (_bag(3, D, 61, 1, dt, False, False),
                _bag(3, D, 61, 4, dt, True, True, over=True))],
    *[_bag(26, 64, 61, 4, dt, False, True, over=True) for dt in (_F32, _BF16)],
    *[_bag(3, 9, 61, 4, dt, True, False, over=True) for dt in (_F32, _BF16)],
    *[_bag(2, 64, 61, H, dt, False, H == 4, offset=1)
      for H in (1, 4) for dt in (_F32, _BF16)],
]
# bf16: the output's rounding; f32: summation order; one id per bag: exact
BAG_TOL = {_F32: 1e-6, _BF16: 2e-2}


def bag_inputs(T, R, D, B, H, dtype, weighted, device, seed=0, over=False,
               offset=0):
    """tables (T, R, D) N(0, 1), a view ``offset`` elements into its
    storage; ids (B, T, H) in [-1, R) (in [-1, R + R/4) where ``over``);
    weights (B, T, H) N(0, 1) or None; from a numpy seed."""
    rng = np.random.default_rng(seed)
    tables = torch.as_tensor(rng.normal(size=(T, R, D)), dtype=torch.float32)
    hi = R + R // 4 if over else R
    ids = torch.as_tensor(rng.integers(-1, hi, (B, T, H)), dtype=torch.int32)
    w = (torch.as_tensor(rng.normal(size=(B, T, H)), dtype=torch.float32)
         .to(device=device, dtype=dtype) if weighted else None)
    store = torch.empty(offset + T * R * D, dtype=dtype, device=device)
    view = store[offset:].view(T, R, D)
    view.copy_(tables)
    return view, ids.to(device), w


def bag_case(case, device, seed=0) -> float:
    """`embedding_bag` against its plain version on ``device``; returns the
    largest absolute difference, raises past `BAG_TOL` (zero at H = 1)."""
    name, T, R, D, B, H, dtype, mean, weighted, over, offset = case
    tables, ids, w = bag_inputs(T, R, D, B, H, dtype, weighted, device, seed,
                                over, offset)
    combiner = "mean" if mean else "sum"
    got = embedding_bag(tables, ids, w, combiner=combiner)
    want = embedding_bag_ref(tables, ids, w, mean=mean)
    return _close_or_raise(f"embedding_bag {name}", got, want,
                           0.0 if H == 1 else BAG_TOL[dtype])


# gather-aggregate: (name, N, F, Dmax, dtype, mean).  Ragged N (not a
# multiple of the 8 nodes of a block), Dmax 1, 15 and 40 (two ballots of
# ids), F 8, 128 and GraphSAGE-reddit's 602 (4-byte aligned bf16 rows) and
# an odd F; a third of the rows all pad, the rest with pads drawn in.  The
# kernel, the plain version and the CSR layout add the same f32 terms in
# the same order: every case is held to the plain version's bytes.
AGG_CASES = [
    (f"N{N}-F{F}-D{Dm}-{str(dt)[6:]}-{'mean' if mean else 'sum'}",
     N, F, Dm, dt, mean)
    for dt in (_F32, _BF16) for mean in (False, True)
    for N, F, Dm in ((1001, 8, 1), (1001, 128, 15), (1001, 602, 15),
                     (203, 602, 1), (333, 7, 40))
]
# the GNN archs' pooled logits (cuBLAS beside the CPU's products)
AGG_TOL = {_F32: 1e-5, _BF16: 2e-2}


def agg_inputs(N, F, Dmax, dtype, device, seed=0):
    """features (N, F) N(0, 1); nbrs (N, Dmax) in [-1, N), a third of the
    rows all −1; from a numpy seed."""
    rng = np.random.default_rng(seed)
    feats = torch.as_tensor(rng.normal(size=(N, F)), dtype=torch.float32)
    nbrs = rng.integers(-1, N, (N, Dmax)).astype(np.int32)
    nbrs[rng.random(N) < 1 / 3] = -1
    return feats.to(device=device, dtype=dtype), torch.as_tensor(nbrs).to(device)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _equal_or_raise(name: str, got: torch.Tensor, want: torch.Tensor,
                    what: str) -> None:
    if got.shape != want.shape or not torch.equal(_bits(got), _bits(want)):
        err = (float((got.float() - want.float()).abs().max())
               if got.shape == want.shape and got.numel() else "shape")
        raise AssertionError(f"{name}: differs from {what} by up to {err}")


def agg_case(case, device, seed=0) -> float:
    """`gather_aggregate` against its plain version on ``device``: equal
    byte for byte; returns 0.0."""
    name, N, F, Dmax, dtype, mean = case
    feats, nbrs = agg_inputs(N, F, Dmax, dtype, device, seed)
    got = gather_aggregate(feats, nbrs, mean=mean)
    want = gather_aggregate_ref(feats, nbrs, mean=mean)
    _equal_or_raise(f"gather_aggregate {name}", got, want,
                    "the plain version's bytes")
    return 0.0


# the aggregate over CSR segments: (name, N, F, Dmax, dtype, mean[,
# variant]).  AGG_CASES' geometry and the GNN path's widths (16, 100, 128,
# 1 433), each padded table read as its rows' valid ids (`padded_to_csr`:
# pads dropped, a third of the rows empty); stars ("star": row 0 takes
# Dmax ids, every other row at most 3 or none, so one hub's segment is
# ~10³ times the rest); and rows around and past `LONG_ROW` (T), built
# directly as CSR (`agg_long_inputs`; Dmax is the longest row):
#   * "rowsT": rows of T − 1, T and T + 1 ids among rows of 0–3;
#   * "star100000": one row of 100 000 ids (more than ogb_products' hub);
#   * "long400": 400 rows of 2T ids, more than the card has SMs;
#   * "one-long": one row of 5T + 3 ids among 200 000 empty rows.
# Each long geometry runs F 7, 100, 128 and 602, and f32 / bf16 × sum /
# mean in turn.
LONG_GEOMETRIES = (("rowsT", 4096, LONG_ROW + 1),
                   ("star100000", 8192, 100_000),
                   ("long400", 8192, 2 * LONG_ROW),
                   ("one-long", 200_000, 5 * LONG_ROW + 3))
_LONG_KINDS = ((_F32, False), (_BF16, True), (_BF16, False), (_F32, True))
AGG_CSR_CASES = [
    *[(f"N{N}-F{F}-D{Dm}-{str(dt)[6:]}-{'mean' if mean else 'sum'}",
       N, F, Dm, dt, mean)
      for dt in (_F32, _BF16) for mean in (False, True)
      for N, F, Dm in ((1001, 8, 1), (1001, 602, 15), (333, 7, 40),
                       (1001, 16, 15), (1001, 100, 15), (1001, 128, 15),
                       (203, 1433, 15))],
    *[(f"star{Dm}-F{F}-{str(dt)[6:]}-{'mean' if mean else 'sum'}",
       8192, F, Dm, dt, mean, "star")
      for dt in (_F32, _BF16) for mean, F in ((True, 128), (False, 100))
      for Dm in (5000,)],
    *[(f"{geo}-F{F}-{str(dt)[6:]}-{'mean' if mean else 'sum'}", N, F, Dm, dt,
       mean, geo)
      for g, (geo, N, Dm) in enumerate(LONG_GEOMETRIES)
      for i, F in enumerate((7, 100, 128, 602))
      for dt, mean in (_LONG_KINDS[(i + g) % 4],)],
]
# a padded table of a long geometry is built, and held to, below this size
AGG_PADDED_MAX_BYTES = 256 << 20
# the CSR cases the transpose is held on (`agg_csr_t_case`): all but the
# long geometries, which reach no path of the transpose that the others
# miss
AGG_CSR_T_CASES = [c for c in AGG_CSR_CASES if c[6:] in ((), ("star",))]


def agg_star_inputs(N, F, Dmax, dtype, device, seed=0):
    """features (N, F) N(0, 1); nbrs (N, Dmax): row 0 names Dmax nodes, a
    third of the other rows none, the rest up to 3 (pads drawn in)."""
    rng = np.random.default_rng(seed)
    feats = torch.as_tensor(rng.normal(size=(N, F)), dtype=torch.float32)
    nbrs = np.full((N, Dmax), -1, np.int32)
    nbrs[0] = rng.integers(0, N, Dmax)
    nbrs[1:, :3] = rng.integers(-1, N, (N - 1, 3))
    nbrs[1:][rng.random(N - 1) < 1 / 3] = -1
    return (feats.to(device=device, dtype=dtype),
            torch.as_tensor(nbrs).to(device))


def agg_long_inputs(geo, N, F, dtype, device, seed=0):
    """One of the long geometries (see `AGG_CSR_CASES`) built as CSR:
    features (N, F) N(0, 1), indptr (N + 1,) and src (nnz,) int32 (ids in
    [0, N)), and the padded table of the same rows (pad −1) where it takes
    less than `AGG_PADDED_MAX_BYTES`, else None; from a numpy seed."""
    rng = np.random.default_rng(seed)
    feats = torch.as_tensor(rng.normal(size=(N, F)), dtype=torch.float32)
    if geo == "one-long":
        deg = np.zeros(N, np.int64)
        deg[N // 2 + 7] = 5 * LONG_ROW + 3
    else:
        deg = rng.integers(0, 4, N)
        deg[rng.random(N) < 1 / 3] = 0
        if geo == "rowsT":
            deg[1:4] = (LONG_ROW - 1, LONG_ROW, LONG_ROW + 1)
        elif geo == "star100000":
            deg[0] = 100_000
        elif geo == "long400":
            deg[5:5 + 20 * 400:20] = 2 * LONG_ROW
        else:
            raise ValueError(f"unknown long geometry {geo!r}")
    indptr = np.zeros(N + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    src = rng.integers(0, N, int(indptr[-1])).astype(np.int32)
    nbrs = None
    dmax = int(deg.max())
    if N * dmax * 4 < AGG_PADDED_MAX_BYTES:
        pos = np.arange(src.size) - np.repeat(indptr[:-1], deg)
        table = np.full((N, dmax), -1, np.int32)
        table[np.repeat(np.arange(N), deg), pos] = src
        nbrs = torch.as_tensor(table).to(device)
    return (feats.to(device=device, dtype=dtype),
            torch.as_tensor(indptr.astype(np.int32)).to(device),
            torch.as_tensor(src).to(device), nbrs)


def _agg_csr_inputs(case, device, seed):
    """(features, the padded table or None, (indptr, src)) of an
    `AGG_CSR_CASES` entry."""
    name, N, F, Dmax, dtype, mean, *variant = case
    if variant and variant[0] != "star":
        feats, indptr, src, nbrs = agg_long_inputs(variant[0], N, F, dtype,
                                                   device, seed)
        return feats, nbrs, (indptr, src)
    make = agg_star_inputs if variant == ["star"] else agg_inputs
    feats, nbrs = make(N, F, Dmax, dtype, device, seed)
    return feats, nbrs, padded_to_csr(nbrs)


def agg_csr_case(case, device, seed=0) -> float:
    """`gather_aggregate_csr` on the case's CSR: equal byte for byte to its
    plain version and, where the case has one, to `gather_aggregate` on the
    padded table of the same rows (the one order of f32 adds); a long
    geometry launched twice gives the same bytes.  Returns 0.0."""
    name, dtype, mean = case[0], case[4], case[5]
    feats, nbrs, (indptr, src) = _agg_csr_inputs(case, device, seed)
    got = gather_aggregate_csr(feats, indptr, src, mean=mean)
    name = f"gather_aggregate_csr {name}"
    if nbrs is not None:
        _equal_or_raise(name, got, gather_aggregate(feats, nbrs, mean=mean),
                        "the padded layout's bytes")
    if len(case) > 6 and case[6] != "star":
        _equal_or_raise(name, gather_aggregate_csr(feats, indptr, src,
                                                   mean=mean), got,
                        "its first launch")
    _equal_or_raise(name, got, gather_aggregate_csr_ref(feats, indptr, src,
                                                        mean=mean),
                    "the plain version's bytes")
    return 0.0


# ---------------------------------------------------------------------------
# backward kernels: each against autograd of its plain forward on f32 copies
# ---------------------------------------------------------------------------

def grads_close(name: str, got: torch.Tensor, want: torch.Tensor, *,
                scaled: float = 0.0, rtol: float = 0.0,
                atol: float = 0.0) -> float:
    """|got − want| ≤ atol + rtol·|want| + scaled·max|want| elementwise;
    returns the largest absolute difference, raises past the bound."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    diff = (got - want).abs()
    scale = float(want.abs().max()) if want.numel() else 0.0
    bound = atol + rtol * want.abs() + scaled * scale
    err = float(diff.max()) if diff.numel() else 0.0
    if (diff > bound).any():
        worst = float((diff - bound).max())
        raise AssertionError(f"{name}: max abs err {err} (max |want| "
                             f"{scale:.4g}) past atol {atol} + rtol {rtol}"
                             f"·|want| + {scaled}·max|want| by {worst:.3g}")
    return err


def _same_bytes(name: str, a, b) -> None:
    for x, y in zip(a, b):
        if not torch.equal(x, y):
            raise AssertionError(f"{name}: a second launch gave other bytes")


# flash backward: FLASH_CASES' geometry plus the training shape of
# qwen3-1.7b (B 1 of the trainer's 4; hd 128, GQA 16 / 8) and its train_4k
# length (S 4 096: 256 work items, more than the card holds at once, so the
# ordered dQ adds run over many waves), ragged S with GQA, window and
# softcap in both dtypes, non-causal and hd 16; at hd 128 S 1, 65 and 129
# (one, two and three query tiles, the last one ragged) and G 4; at hd 64 a
# window with softcap (both wgmma head dims).
FLASH_BWD_CASES = [
    ("qwen3-1.7b-train", 1, 1024, 16, 8, 128, _BF16, True, None, None),
    ("qwen3-1.7b-train4k", 1, 4096, 16, 8, 128, _BF16, True, None, None),
    ("hd128-S1", 2, 1, 4, 2, 128, _BF16, True, None, None),
    ("hd128-S65", 1, 65, 4, 2, 128, _BF16, True, None, None),
    ("hd128-S129", 1, 129, 4, 2, 128, _BF16, True, None, None),
    ("hd128-gqa4", 1, 700, 8, 2, 128, _BF16, True, None, None),
    ("window100-softcap30-hd64", 2, 1000, 4, 2, 64, _BF16, True, 100, 30.0),
    ("ragged-gqa", 2, 1000, 4, 2, 64, _BF16, True, None, None),
    ("ragged-gqa-f32", 1, 333, 4, 2, 64, _F32, True, None, None),
    ("window512-softcap50", 1, 1100, 4, 2, 128, _BF16, True, 512, 50.0),
    ("window16-softcap30-f32", 2, 130, 4, 2, 32, _F32, True, 16, 30.0),
    ("non-causal", 2, 192, 4, 2, 64, _BF16, False, None, None),
    ("non-causal-window-f32", 1, 77, 2, 1, 16, _F32, False, 8, None),
    ("hd16-mqa", 2, 64, 4, 1, 16, _BF16, True, None, None),
]
# relative to the largest gradient: bf16 rounds the forward's O (which D =
# rowsum(dO ∘ O) reads) and every output; f32 sums in another order
FLASH_BWD_TOL = {_F32: 1e-4, _BF16: 2e-2}


def flash_bwd_case(case, device, seed=0) -> float:
    """`ops.FlashAttention`'s backward kernels against autograd of
    `flash_attention_ref` on f32 copies of q, k, v and dO; every gradient
    within `FLASH_BWD_TOL` of the largest, and a second backward identical
    byte for byte.  Returns the largest absolute difference."""
    from ..kernels.flash_attention.ops import FlashAttention

    name, B, S, H, KV, hd, dtype, causal, window, softcap = case
    q, k, v = flash_inputs(B, S, H, KV, hd, dtype, device, seed)
    rng = np.random.default_rng(seed + 1)
    dout = torch.as_tensor(rng.normal(size=(B, S, H, hd)),
                           dtype=torch.float32).to(device=device, dtype=dtype)

    def kernel_grads():
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = FlashAttention.apply(*leaves, causal, window, softcap)
        out.backward(dout)
        return [t.grad for t in leaves]

    got = kernel_grads()
    _same_bytes(f"flash_attention_bwd {name}", got, kernel_grads())
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    flash_attention_ref(*leaves, causal=causal, window=window,
                        softcap=softcap).backward(dout.float())
    tol = FLASH_BWD_TOL[dtype]
    largest = max(float(t.grad.abs().max()) for t in leaves)
    errs = []
    for n, g, t in zip("qkv", got, leaves):
        if float(t.grad.abs().max()) > 0:
            errs.append(grads_close(f"flash_attention_bwd {name} d{n}", g,
                                    t.grad, scaled=tol))
        else:
            # identically zero (every row attends to one key, S 1): dP and
            # D agree only up to their rounding, so the kernel's dq and dk
            # are held to the tolerance of the case's largest gradient
            errs.append(grads_close(f"flash_attention_bwd {name} d{n}", g,
                                    t.grad, atol=tol * largest))
    return max(errs)


# bag backward: (name, T, R, D, B, H, dtype, mean, weighted, over).  Few
# rows (R 50) so ids repeat across bags; pads and ids ≥ R; DLRM's T 26 and
# D 64; D 8 and an odd D 9; both combiners, weights.
BAG_BWD_CASES = [
    (f"T{T}-R{R}-D{D}-H{H}-{str(dt)[6:]}-{'mean' if mean else 'sum'}"
     f"{'-weighted' if w else ''}{'-over' if over else ''}",
     T, R, D, 64, H, dt, mean, w, over)
    for dt in (_F32, _BF16)
    for T, R, D, H, mean, w, over in (
        (26, 50, 64, 1, False, False, False),
        (26, 1000, 64, 1, False, False, False),
        (3, 50, 64, 4, True, True, True),
        (3, 50, 9, 4, False, False, True),
        (2, 20, 8, 3, True, False, False))
]
# one f32 sum a row, rounded once: half a unit in the last place of the
# result's dtype, relative (bf16 2^-9, f32 2^-24 and the order of the sum)
BAG_BWD_TOL = {_F32: (1e-5, 2e-5), _BF16: (4e-3, 1e-5)}


def bag_bwd_case(case, device, seed=0) -> float:
    """`ops.EmbeddingBag`'s backward kernel against autograd of
    `embedding_bag_ref` on f32 copies of the tables and d_out, within
    `BAG_BWD_TOL` (rtol, atol); a second backward identical byte for byte.
    Returns the largest absolute difference."""
    from ..kernels.embedding_bag.ops import EmbeddingBag

    name, T, R, D, B, H, dtype, mean, weighted, over = case
    tables, ids, w = bag_inputs(T, R, D, B, H, dtype, weighted, device, seed,
                                over)
    rng = np.random.default_rng(seed + 1)
    d_out = torch.as_tensor(rng.normal(size=(B, T, D)),
                            dtype=torch.float32).to(device=device, dtype=dtype)

    def kernel_grad():
        t = tables.detach().clone().requires_grad_()
        EmbeddingBag.apply(t, ids, w, mean).backward(d_out)
        return t.grad

    got = kernel_grad()
    _same_bytes(f"embedding_bag_bwd {name}", [got], [kernel_grad()])
    t32 = tables.detach().float().requires_grad_()
    embedding_bag_ref(t32, ids, None if w is None else w.float(),
                      mean=mean).backward(d_out.float())
    rtol, atol = BAG_BWD_TOL[dtype]
    return grads_close(f"embedding_bag_bwd {name}", got, t32.grad,
                       rtol=rtol, atol=atol)


# aggregate transpose: AGG_CASES' geometry (ragged N, Dmax 1 / 15 / 40,
# F 7, 8, 128, 602, a third of the rows all pad), and hub nodes: N 50 with
# Dmax 40 names each node ~26 times.  Variants (a seventh field): "hub",
# one node named by 5 000 rows among 8 192 nodes that mostly have no
# out-edge (the sampled block's shape, one long sum); "offset1", d_out a
# view one element off its 16-byte alignment, which takes a narrow path
# (`kernel.aggt_mode`) and must give the 16-byte path's bytes.
AGG_T_CASES = [
    *[(f"N{N}-F{F}-D{Dm}-{str(dt)[6:]}-{'mean' if mean else 'sum'}",
       N, F, Dm, dt, mean)
      for dt in (_F32, _BF16) for mean in (False, True)
      for N, F, Dm in ((1001, 128, 15), (1001, 602, 15), (203, 602, 1),
                       (333, 7, 40), (50, 8, 40))],
    ("hub5000-F128-bf16-mean", 8192, 128, 3, _BF16, True, "hub"),
    ("hub5000-F128-f32-sum", 8192, 128, 3, _F32, False, "hub"),
    ("offset1-F128-bf16-mean", 1001, 128, 15, _BF16, True, "offset1"),
    ("offset1-F128-f32-sum", 1001, 128, 15, _F32, False, "offset1"),
]
AGG_T_TOL = BAG_BWD_TOL
AGG_T_HUB = 5000


def agg_t_hub_inputs(N, F, Dmax, dtype, device, seed=0):
    """features (N, F) N(0, 1); nbrs (N, Dmax): rows below `AGG_T_HUB`
    name node 7 first, every 16th of them a random node or pad after it, the
    other rows are all pad, so node 7 has 5 000 out-edges and most nodes
    none."""
    rng = np.random.default_rng(seed)
    feats = torch.as_tensor(rng.normal(size=(N, F)), dtype=torch.float32)
    nbrs = np.full((N, Dmax), -1, np.int32)
    nbrs[:AGG_T_HUB, 0] = 7
    some = np.arange(0, AGG_T_HUB, 16)
    nbrs[some, 1:] = rng.integers(-1, N, (some.size, Dmax - 1))
    return feats.to(device=device, dtype=dtype), torch.as_tensor(nbrs).to(device)


def agg_t_case(case, device, seed=0) -> float:
    """`ops.GatherAggregate`'s transpose kernel against autograd of
    `gather_aggregate_ref` on f32 copies of the features and d_out, within
    `AGG_T_TOL` (rtol, atol); a second backward identical byte for byte.
    Returns the largest absolute difference."""
    from ..kernels.gather_aggregate.ops import GatherAggregate

    name, N, F, Dmax, dtype, mean, *variant = case
    make = agg_t_hub_inputs if variant == ["hub"] else agg_inputs
    feats, nbrs = make(N, F, Dmax, dtype, device, seed)
    rng = np.random.default_rng(seed + 1)
    d_out = torch.as_tensor(rng.normal(size=(N, F)),
                            dtype=torch.float32).to(device=device, dtype=dtype)

    def kernel_grad():
        f = feats.detach().clone().requires_grad_()
        GatherAggregate.apply(f, nbrs, mean).backward(d_out)
        return f.grad

    got = kernel_grad()
    _same_bytes(f"gather_aggregate_t {name}", [got], [kernel_grad()])
    if variant == ["offset1"]:
        from ..kernels.gather_aggregate.kernel import (
            aggt_mode, gather_aggregate_t_nf,
        )
        from ..kernels.gather_aggregate.ops import out_neighbor_csr

        store = torch.empty(N * F + 1, dtype=dtype, device=device)
        view = store[1:].view(N, F)
        view.copy_(d_out)
        mode = aggt_mode(F, view.element_size(), view.data_ptr())
        if mode == 16:
            raise AssertionError(f"gather_aggregate_t {name}: the view off "
                                 f"its alignment took the 16-byte path")
        indptr, dst, deg = out_neighbor_csr(nbrs)
        narrow = gather_aggregate_t_nf(view, indptr, dst,
                                       deg if mean else None)
        _same_bytes(f"gather_aggregate_t {name} (path {mode} against the "
                    f"16-byte path)", [narrow], [got])
    f32 = feats.detach().float().requires_grad_()
    gather_aggregate_ref(f32, nbrs, mean=mean).backward(d_out.float())
    rtol, atol = AGG_T_TOL[dtype]
    return grads_close(f"gather_aggregate_t {name}", got, f32.grad,
                       rtol=rtol, atol=atol)


def agg_csr_t_case(case, device, seed=0) -> float:
    """`ops.GatherAggregateCSR`'s backward (the transpose kernel over
    `ops.csr_transpose` of the in-CSR) against autograd of
    `gather_aggregate_csr_ref` on f32 copies, within `AGG_T_TOL`; a second
    backward identical byte for byte.  ``case``: an `AGG_CSR_T_CASES` entry.
    Returns the largest absolute difference."""
    from ..kernels.gather_aggregate.ops import GatherAggregateCSR

    name, N, F, dtype, mean = case[0], case[1], case[2], case[4], case[5]
    feats, _, (indptr, src) = _agg_csr_inputs(case, device, seed)
    rng = np.random.default_rng(seed + 1)
    d_out = torch.as_tensor(rng.normal(size=(N, F)),
                            dtype=torch.float32).to(device=device, dtype=dtype)

    def kernel_grad():
        f = feats.detach().clone().requires_grad_()
        GatherAggregateCSR.apply(f, indptr, src, mean).backward(d_out)
        return f.grad

    got = kernel_grad()
    _same_bytes(f"gather_aggregate_t (CSR) {name}", [got], [kernel_grad()])
    f32 = feats.detach().float().requires_grad_()
    gather_aggregate_csr_ref(f32, indptr, src, mean=mean).backward(
        d_out.float())
    rtol, atol = AGG_T_TOL[dtype]
    return grads_close(f"gather_aggregate_t (CSR) {name}", got, f32.grad,
                       rtol=rtol, atol=atol)


# AdamW: (name, n, offset).  A vector of 4-element groups (the 16-byte
# path), odd lengths and a view one element off its alignment (the scalar
# path), one element, and more elements than the grid's threads
ADAMW_CASES = [("n4096", 4096, 0), ("n1", 1, 0), ("n1001", 1001, 0),
               ("n4096-offset1", 4096, 1), ("n3000017", 3_000_017, 0),
               ("n4194304", 4_194_304, 0)]


def adamw_case(case, device, seed=0) -> float:
    """The fused AdamW kernel against its plain version on the same random
    parameter, gradient, moments and scalars: equal bit for bit (both
    round the same f32 operations in the same order); returns 0.0."""
    from ..kernels.adamw.kernel import adamw_fused
    from ..kernels.adamw.ref import adamw_ref
    from ..train.optimizer import AdamWConfig

    name, n, offset = case
    rng = np.random.default_rng(seed)
    cfg = AdamWConfig(lr=1e-3, weight_decay=0.1)

    def leaf(scale, positive=False):
        a = rng.normal(size=n) * scale
        store = torch.zeros(offset + n, dtype=torch.float32, device=device)
        store[offset:] = torch.as_tensor(np.abs(a) if positive else a)
        return store[offset:]

    p, g, m, v = leaf(1.0), leaf(3.0), leaf(0.1), leaf(0.01, positive=True)
    scalars = torch.tensor([0.37, 2.5e-4, 0.271, 0.0975], device=device)
    want = [t.clone() for t in (p, m, v)]
    adamw_ref(*[want[0], g, want[1], want[2]], scalars, cfg)
    adamw_fused(p, g, m, v, scalars, cfg)
    for got_t, want_t, what in zip((p, m, v), want, "pmv"):
        if not torch.equal(got_t, want_t):
            err = float((got_t - want_t).abs().max())
            raise AssertionError(f"adamw {name}: {what} differs from the "
                                 f"plain version by up to {err}")
    return 0.0


# ---------------------------------------------------------------------------
# GNN archs: the card against a CPU copy.  Their scatters (and gathers'
# backward) are ``index_add_``, which the card adds with atomics in no fixed
# order (in bf16 rounding after every add) and the CPU in order (in bf16
# summing in f32 and rounding once): outputs within the CPU parity tests'
# bounds against the reference (``tests/test_torch_gnn_archs.py``), the
# loss within 1e-3 relative for nequip (f32), and for the bf16 archs
# within ~2.7x the largest move the two roundings gave on an H100 (the
# molecule check of ``chip_smoke.py`` phase 8b at full width, the reduced
# cases of ``tests/test_torch_gpu.py``): schnet 1e-2 (read up to 3.75e-3,
# reduced molecule), graphcast 5e-3 (read up to 1.7e-3, reduced).
# ---------------------------------------------------------------------------

# arch → ((scaled, absolute) bound on the outputs: |Δ| ≤ scaled·max|out| +
# abs, relative bound on the loss)
GNN_OUT_TOL = {"nequip": ((1e-4, 0.0), 1e-3),
               "schnet": ((0.02, 0.05), 1e-2),
               "graphcast": ((0.02, 0.05), 5e-3)}


def _gnn_apply(name: str):
    from ..models.gnn.graphcast import graphcast_apply
    from ..models.gnn.nequip import nequip_apply
    from ..models.gnn.schnet import schnet_apply

    return {"schnet": schnet_apply, "nequip": nequip_apply,
            "graphcast": graphcast_apply}[name]


def gnn_card_against_cpu(arch, shape: str, model, gb) -> str:
    """``model`` (f32 masters) and batch ``gb`` on the card against copies
    of both on the CPU: outputs and loss within `GNN_OUT_TOL` (above);
    returns a line of the numbers, raises past them."""
    import copy
    import dataclasses

    apply = _gnn_apply(arch.name)
    loss_fn = arch.loss_fn(shape)
    cpu_model = copy.deepcopy(model).cpu()
    gb_cpu = dataclasses.replace(gb, **{
        f.name: getattr(gb, f.name).cpu() for f in dataclasses.fields(gb)
        if isinstance(getattr(gb, f.name), torch.Tensor)})
    with torch.no_grad():
        got = apply(model, gb).float().cpu()
        want = apply(cpu_model, gb_cpu).float()
        l_card, l_cpu = float(loss_fn(model, gb)), float(loss_fn(cpu_model,
                                                                  gb_cpu))
    (scaled, atol), rtol = GNN_OUT_TOL[arch.name]
    bound = scaled * float(want.abs().max()) + atol
    err = float((got - want).abs().max())
    rel = abs(l_card - l_cpu) / max(abs(l_cpu), 1e-30)
    msg = (f"loss card {l_card!r} cpu {l_cpu!r} (rel {rel:.3g}, bound "
           f"{rtol}); outputs max abs err {err:.4g} (bound {bound:.4g})")
    if not (math.isfinite(l_card) and err <= bound and rel <= rtol):
        raise AssertionError(f"{arch.name} {shape} on the card against the "
                             f"CPU: {msg}")
    return msg
