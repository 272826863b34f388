"""Model layers of the port (the dense family so far)."""
