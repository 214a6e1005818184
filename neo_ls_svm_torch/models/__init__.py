"""Model layer: the estimator and the primal solver."""
