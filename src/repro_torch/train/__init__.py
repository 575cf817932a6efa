"""Training utilities of the port: AdamW (`optimizer`), atomic checkpoints
(`checkpoint`), the step guard, heartbeat and `resume_or_init`
(`elastic`)."""
