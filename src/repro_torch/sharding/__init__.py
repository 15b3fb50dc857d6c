"""Sharding rules: which mesh axis each parameter, batch, cache and arena
dimension is cut over (``sharding/rules.py``)."""
