"""Training data on the host: GT label maps, batching and loading,
synthetic scenes and the datasets' GT parsers."""
