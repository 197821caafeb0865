"""Core math: cameras, transforms, SH, gaussian parameters."""
