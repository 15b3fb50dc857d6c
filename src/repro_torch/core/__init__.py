"""Framework-free core records and the Clover optimizer: the variant
record, slice feasibility, the configuration graph and its neighbourhood,
the power model, carbon-intensity traces, the objective and simulated
annealing."""
