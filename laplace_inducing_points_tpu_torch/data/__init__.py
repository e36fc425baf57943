"""Data: numpy datasets and loaders (image sets and their offline surrogate)."""
