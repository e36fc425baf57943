"""Training: MAP weights and the inducing points Z."""
