"""The LM stack of the port (dense attention blocks so far)."""
