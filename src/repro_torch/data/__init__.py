"""Synthetic data generators and the scenario catalogue."""
