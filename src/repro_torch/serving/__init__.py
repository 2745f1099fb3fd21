"""Serving runtimes of the port: the synchronous edge-cloud server, the
pipelined server, and the fleet server (many edges, one shared cloud) with
its trace-shaped workloads."""
