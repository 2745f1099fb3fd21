"""Models of the port behind the ``Model`` API: the paper's CNN testbed
and the decoder families dense, ssm and hybrid (``transformer``,
``blocks``, ``layers``)."""
