"""Host-side utilities: estimator base classes, validation, metrics, state dicts, and the
narrow host→device uploads."""
