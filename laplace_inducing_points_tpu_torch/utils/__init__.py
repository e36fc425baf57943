"""Devices and precision policy, configs, checkpoints."""
