"""Serving of the port's LMs (continuous batching)."""
