"""Utilities: synthetic scenes."""
