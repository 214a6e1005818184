"""Host-side utilities: estimator base classes, validation, metrics, state dicts."""
