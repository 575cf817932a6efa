"""Training utilities of the port: AdamW and ZeRO-1 specs (`optimizer`),
the train step (`step`), atomic checkpoints (`checkpoint`), int8 gradient
compression (`compression`), the step guard, heartbeat, `best_mesh` and
`resume_or_init` (`elastic`)."""
