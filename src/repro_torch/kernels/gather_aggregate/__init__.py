"""Padded-neighbour gather-aggregate (the GNN's SpMM): ref / kernel / ops."""
