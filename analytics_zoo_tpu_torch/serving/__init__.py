"""Cluster Serving: the in-memory broker, the queue and HTTP clients, the
classic and pipelined engine and the HTTP frontend."""
