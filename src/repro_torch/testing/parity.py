"""Kernel-vs-plain parity cases, shared by the card tests and ``chip_smoke.py``.

Every case is built from a numpy seed, runs the CUDA kernel and its plain
torch version on the same device tensors, and compares every output
exactly (the kernels compute integers and bits, so the tolerance is zero).
Each ``*_case`` function returns the largest absolute difference it saw
(0 when they agree) and raises ``AssertionError`` on any mismatch.
"""
from __future__ import annotations

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
from ..kernels.frontier_expand.ops import frontier_expand_level
from ..kernels.frontier_expand.ref import frontier_expand_ref
from ..kernels.mis_bitmap.kernel import mis_bitmap_select

__all__ = ["random_graph", "patterns_by_k", "frontier_case", "mis_case",
           "max_abs_diff", "frontier_work", "mis_rows_scanned"]


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


def frontier_work(g: DeviceGraph, plans, emb, count, level: int,
                  cfg: MatchConfig) -> Tuple[int, int]:
    """(live lanes, bisection steps) one expansion level needs on these
    inputs.  Live lanes: each valid row's anchor neighbours, up to
    max_chunks · chunk of them.  Bisection steps: for each lane that passes
    the label, degree and injectivity filters, ``bisect_iters + 1`` steps
    per edge check, up to the first check that fails (the kernel's order:
    out-check then in-check of each earlier column)."""
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
    lanes = steps = 0
    for c in range(cfg.max_chunks):
        off = c * C + torch.arange(C, device=dev)
        p, r, lane = (valid[..., None] & (off < deg[..., None])).nonzero(
            as_tuple=True)
        if p.numel() == 0:
            break           # degrees only run out as chunks advance
        lanes += p.numel()
        cand = indices_cat[(start[p, r] + off[lane]).clamp(0, last).long()]
        cs = cand.clamp(0, n - 1).long()
        m = ((g.labels[cs] == plans.cand_label[p, i])
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
                steps += int((alive & need).sum()) * (cfg.bisect_iters + 1)
                alive &= ~need | edge_exists(g.out_indptr, g.out_indices, u,
                                             v, cfg.bisect_iters)
    return lanes, steps


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
