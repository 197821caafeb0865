"""Core math: cameras, transforms, SH, gaussian state and its SfM init."""
