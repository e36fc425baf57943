"""Parallel: device meshes and example-sharded operator variants."""
