"""Training utilities of the port: atomic checkpoints (`checkpoint`) and
`elastic.resume_or_init`."""
