"""Closest-hit queries, shading and the wavefront bounce loop."""
