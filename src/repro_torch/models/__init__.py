"""Models of the port behind the ``Model`` API: the paper's CNN testbed
and the dense decoder family (``transformer``, ``blocks``, ``layers``)."""
