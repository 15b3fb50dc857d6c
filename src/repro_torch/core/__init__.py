"""Framework-free core records the engine needs: the variant record,
the configuration graph and the power model."""
