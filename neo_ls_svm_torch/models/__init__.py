"""Model layer: the estimator, its routing policy, and the primal and dual solvers."""
