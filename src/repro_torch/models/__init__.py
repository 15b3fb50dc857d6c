"""Model config, layers, the paged transformer, its registry and the
weight bridge from the reference package."""
