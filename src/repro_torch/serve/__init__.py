"""Model serving: continuous batching over a shared KV cache."""
