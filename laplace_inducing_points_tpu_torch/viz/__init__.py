"""Figures: the predictive computations behind each plot, and their drawing."""
