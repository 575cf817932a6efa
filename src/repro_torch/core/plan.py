"""Matching plans — compile a Pattern into static arrays for the matcher.

VF3-Light picks its matching order dynamically during DFS.  On the
device the matcher is a fixed dataflow program, so the order is planned here, once per
pattern, on the host:

  * root   = the pattern vertex with the rarest label in the data graph
             (tie-break: max degree) — smallest initial frontier;
  * order  = greedy connected extension, at each step choosing the vertex
             with the most edges into the ordered prefix (max constraints ⇒
             max pruning), tie-break rare label then high degree;
  * anchor = for each non-root vertex, one already-ordered neighbor whose
             adjacency list is gathered to enumerate candidates.

All plan fields are *data* (torch tensors), not static attributes, so one
matcher program (and one kernel launch per level) serves every pattern of a
size k: `stack_plans` gives the fields a leading pattern axis P, which is how
the batched plane runs a whole same-k candidate group at once.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .graph import DataGraph
from .pattern import Pattern

__all__ = ["PatternPlan", "make_plan", "stack_plans", "plan_from_numpy"]


@dataclasses.dataclass(frozen=True)
class PatternPlan:
    """Matching plan for one pattern, or a stack of P same-k plans.

    Field shapes are given for one plan; a stacked plan (`stack_plans`)
    prepends a pattern axis P to every tensor field.

    k:            pattern size (the only static field).
    root_label:   int32 scalar.
    root_min_out / root_min_in: degree filters for the root.
    anchor_pos:   (k,) int32 — position (into `order`) of the anchor for step
                  i (entry 0 unused).
    anchor_out:   (k,) bool — gather anchor's out-neighbors (else in-).
    cand_label:   (k,) int32 — required label of step-i candidate.
    min_out/min_in: (k,) int32 — degree filters per step.
    check_out:    (k, k) bool — step i must verify edge cand → emb[j].
    check_in:     (k, k) bool — step i must verify edge emb[j] → cand.
    """

    k: int
    root_label: torch.Tensor
    root_min_out: torch.Tensor
    root_min_in: torch.Tensor
    anchor_pos: torch.Tensor
    anchor_out: torch.Tensor
    cand_label: torch.Tensor
    min_out: torch.Tensor
    min_in: torch.Tensor
    check_out: torch.Tensor
    check_in: torch.Tensor
    order: tuple  # host-side: order[i] = original pattern vertex at step i


_TENSOR_FIELDS = ("root_label", "root_min_out", "root_min_in", "anchor_pos",
                  "anchor_out", "cand_label", "min_out", "min_in", "check_out",
                  "check_in")


def stack_plans(plans: Sequence[PatternPlan], device=None) -> PatternPlan:
    """Stack same-k plans into one plan with a leading pattern axis, on ``device``.

    The per-plan host-side ``order`` metadata is dropped (set to ``()``), as
    the reference does for its stacked plans.
    """
    assert len(plans) > 0, "cannot stack zero plans"
    k = plans[0].k
    assert all(p.k == k for p in plans), "plans must share pattern size"
    stacked = [torch.stack([getattr(p, f) for p in plans]).to(device)
               for f in _TENSOR_FIELDS]
    return PatternPlan(k, *stacked, order=())


def select_plans(plans: PatternPlan, rows) -> PatternPlan:
    """Rows ``rows`` of a stacked plan (a re-stacked bucket)."""
    idx = torch.as_tensor(rows, dtype=torch.long, device=plans.root_label.device)
    return PatternPlan(plans.k, *[getattr(plans, f).index_select(0, idx)
                                  for f in _TENSOR_FIELDS], order=())


def plan_from_numpy(k: int, fields, order=(), device="cpu") -> PatternPlan:
    """A plan from numpy arrays named like `PatternPlan`'s fields.

    ``fields`` maps each tensor field name to an array (a leading pattern
    axis is allowed); ints become int32 tensors and the two anchor/check
    flag fields bool, as `make_plan` builds them.
    """
    def conv(name):
        a = np.asarray(fields[name])
        dtype = torch.bool if name in ("anchor_out", "check_out", "check_in") \
            else torch.int32
        return torch.as_tensor(a.astype(bool if dtype is torch.bool
                                        else np.int32)).to(device)

    return PatternPlan(int(k), *[conv(f) for f in _TENSOR_FIELDS],
                       order=tuple(order))


def make_plan(pat: Pattern, graph: Optional[DataGraph] = None) -> PatternPlan:
    if not pat.is_connected():
        raise ValueError("can only plan connected patterns")
    k = pat.k
    und = pat.undirected_adj()
    out_deg = pat.adj.sum(axis=1).astype(np.int32)
    in_deg = pat.adj.sum(axis=0).astype(np.int32)

    if graph is not None:
        label_freq = graph.label_counts()
        rarity = label_freq[np.clip(pat.labels, 0, label_freq.shape[0] - 1)]
    else:
        rarity = np.zeros(k, dtype=np.int64)

    # --- choose order -------------------------------------------------------
    total_deg = und.sum(axis=0)
    root = int(np.lexsort((-total_deg, rarity))[0])
    order = [root]
    remaining = set(range(k)) - {root}
    while remaining:
        best, best_key = None, None
        for v in remaining:
            conn = int(sum(und[v, u] for u in order))
            if conn == 0:
                continue
            key = (-conn, int(rarity[v]), -int(total_deg[v]))
            if best_key is None or key < best_key:
                best, best_key = v, key
        assert best is not None, "pattern connected but no extension found"
        order.append(best)
        remaining.remove(best)

    pos_of = {v: i for i, v in enumerate(order)}

    # --- anchors + checks ---------------------------------------------------
    anchor_pos = np.zeros(k, dtype=np.int32)
    anchor_out = np.zeros(k, dtype=bool)
    check_out = np.zeros((k, k), dtype=bool)
    check_in = np.zeros((k, k), dtype=bool)
    for i in range(1, k):
        v = order[i]
        # candidate anchors = ordered neighbors; prefer one with a pattern
        # edge anchor→v (out-gather), tie-break earliest (smallest frontier
        # growth history)
        anchors = [j for j in range(i) if und[order[j], v]]
        outs = [j for j in anchors if pat.adj[order[j], v]]
        if outs:
            a = outs[0]
            anchor_pos[i], anchor_out[i] = a, True
        else:
            a = anchors[0]
            anchor_pos[i], anchor_out[i] = a, False
        for j in range(i):
            u = order[j]
            need_in = bool(pat.adj[u, v])   # emb[j] → cand
            need_out = bool(pat.adj[v, u])  # cand → emb[j]
            # the gather itself certifies the anchor edge in gather direction
            if j == a:
                if anchor_out[i]:
                    need_in = False  # anchor→cand guaranteed by out-gather
                else:
                    need_out = False  # cand→anchor guaranteed by in-gather
            check_in[i, j] = need_in
            check_out[i, j] = need_out

    labels_o = pat.labels[order]
    out_o = out_deg[order]
    in_o = in_deg[order]
    return plan_from_numpy(k, dict(
        root_label=labels_o[0],
        root_min_out=out_o[0],
        root_min_in=in_o[0],
        anchor_pos=anchor_pos,
        anchor_out=anchor_out,
        cand_label=labels_o,
        min_out=out_o,
        min_in=in_o,
        check_out=check_out,
        check_in=check_in,
    ), order=order)
