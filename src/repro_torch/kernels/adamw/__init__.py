"""The fused AdamW update of one parameter tensor: ref / kernel / ops."""
