"""EmbeddingBag over stacked tables (sum / mean, optional weights): ref / kernel / ops."""
