"""Model I/O: 3DGS PLY files."""
