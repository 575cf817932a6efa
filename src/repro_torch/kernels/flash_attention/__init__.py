"""Blocked flash attention (GQA, causal, window, softcap): ref / kernel / ops."""
