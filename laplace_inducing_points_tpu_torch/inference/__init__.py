"""Posterior sampling and the scalable LLA predictive (serving path)."""
