"""Optimisation: Adam over the five parameter groups, the position LR
schedule, and the densification state."""
