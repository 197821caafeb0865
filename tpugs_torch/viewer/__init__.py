"""Offline viewer: orbit cameras and the trajectory renderer."""
