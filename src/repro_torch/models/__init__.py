"""Dense decoder forward over a contiguous KV cache."""
