"""Data sources for the port: the synthetic stand-ins for the paper's graphs."""
from .synthetic import PAPER_DATASETS, paper_dataset, rmat_graph

__all__ = ["PAPER_DATASETS", "paper_dataset", "rmat_graph"]
