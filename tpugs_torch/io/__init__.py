"""Model I/O: 3DGS PLY files and training checkpoints."""
