"""Models of the port: the paper's CNN testbed behind the ``Model`` API."""
