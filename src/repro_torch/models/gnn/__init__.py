"""Graph neural networks of the port (``repro.models.gnn``): so far
GraphSAGE's forward on sampled blocks."""
