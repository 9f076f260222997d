"""Meshes and parameter sharding of the data-parallel layouts."""
