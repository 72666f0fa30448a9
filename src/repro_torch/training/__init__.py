"""Training: AdamW with optional int8 moments, checkpoints, the loop."""
