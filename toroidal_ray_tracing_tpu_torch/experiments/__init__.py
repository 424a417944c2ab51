"""Experiment configurations (the scenario ladder)."""
