"""Architecture configs the port serves: ``qwen3_1_7b`` (``FULL``, and
``SMOKE`` for the CPU tests)."""
