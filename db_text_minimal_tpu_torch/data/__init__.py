"""Training data on the host: GT label maps, batching and loading, and
synthetic scenes."""
