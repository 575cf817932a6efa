"""Resume-or-initialize over `checkpoint` (the reference's
``repro.train.elastic.resume_or_init``; its mesh helpers come with the
port's sharding)."""
from __future__ import annotations

from . import checkpoint as ckpt

__all__ = ["resume_or_init"]


def resume_or_init(ckpt_dir, init_fn, tree_like, device=None):
    """Restore the latest committed checkpoint onto ``device``, or
    initialize fresh.  Returns (state, extra, start_step)."""
    step = ckpt.latest_step(ckpt_dir)
    if step is None:
        return init_fn(), {}, 0
    state, extra, step = ckpt.restore(ckpt_dir, tree_like, step=step,
                                      device=device)
    return state, extra, step + 1
