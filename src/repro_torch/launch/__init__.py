"""Step factories that serve a model on one card."""
