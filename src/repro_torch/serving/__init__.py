"""Serving runtimes of the port: the synchronous edge-cloud server."""
