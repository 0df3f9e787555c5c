"""Core helpers of the port (own copies; nothing is imported from paddle_tpu)."""
