"""Data: the numpy COLMAP loader, image IO and the Dataset."""
