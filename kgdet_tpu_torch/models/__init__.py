"""Model modules of the port (NCHW activations, reference torch names)."""
