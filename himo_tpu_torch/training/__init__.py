"""Self-supervised training of the feed-forward flow networks."""
