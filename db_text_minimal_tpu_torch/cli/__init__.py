"""Model loading shared by the entry points."""
