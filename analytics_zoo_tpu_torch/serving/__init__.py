"""Cluster Serving: in-memory broker, queue clients and the classic engine."""
