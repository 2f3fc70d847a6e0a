"""Models of the port (the dense LM transformer so far)."""
