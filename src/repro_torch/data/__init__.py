"""Data sources for the port: the synthetic stand-ins for the paper's graphs,
DLRM batches, and the GNN neighbour sampler."""
from .synthetic import PAPER_DATASETS, dlrm_batches, paper_dataset, rmat_graph

__all__ = ["PAPER_DATASETS", "dlrm_batches", "paper_dataset", "rmat_graph"]
