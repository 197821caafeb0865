"""Utilities: synthetic scenes, GT datasets, device-memory budgeting."""
