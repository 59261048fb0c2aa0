"""Host-side datasets feeding the estimator."""
