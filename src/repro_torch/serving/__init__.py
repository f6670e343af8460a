"""The Wolf-KV serving engine and its paged decoder."""
