"""The decoder (the dense tiers, RecurrentGemma) as PyTorch modules."""
