"""Serving layer: request API, scheduler, policies, paged KV pool and the
real-execution engine over slotted or paged KV caches."""
