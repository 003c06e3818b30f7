"""COCO-protocol evaluation of the port (host NumPy)."""
