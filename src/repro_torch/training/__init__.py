"""Training on one card: AdamW, the trainer, distillation, data, checkpoints."""
