"""Graph neural networks of the port (``repro.models.gnn``): GraphSAGE,
SchNet, NequIP and GraphCast, on padded graph batches."""
