"""Render pipeline: projection, binning, kernels and render()."""
