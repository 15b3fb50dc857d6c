"""Serving layer: request API, scheduler, policies, paged KV pool and the
paged real-execution engine."""
