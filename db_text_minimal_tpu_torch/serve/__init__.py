"""Serving: the detection handler and its micro-batching REST server."""
