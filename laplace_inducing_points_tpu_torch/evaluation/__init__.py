"""Calibration metrics and the dataset-level evaluation harness."""
