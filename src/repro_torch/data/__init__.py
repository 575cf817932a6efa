"""Data sources for the port: the synthetic stand-ins for the paper's graphs,
DLRM batches, the LM token stream, and the GNN neighbour sampler."""
from .synthetic import (PAPER_DATASETS, dlrm_batches, paper_dataset, rmat_graph,
                        token_stream)

__all__ = ["PAPER_DATASETS", "dlrm_batches", "paper_dataset", "rmat_graph",
           "token_stream"]
