"""Plain version of the mIS bitmap kernel = the port's greedy scan."""
from ...core.mis import mis_greedy_update


def mis_bitmap_ref(bitmap, count, emb, n_valid, tau, k):
    """Greedy lexicographic maximal-independent-set selection (row loop)."""
    return mis_greedy_update(bitmap, count, emb, n_valid, tau, k)
