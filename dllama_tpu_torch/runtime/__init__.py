"""Weight loading, the dense KV cache and the single-sequence engine."""
