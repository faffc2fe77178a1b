"""Serving runtime: checkpoints, the estimator and the HTTP server."""
