"""The dense tier decoder as PyTorch modules."""
