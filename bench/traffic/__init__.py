"""Traffic kinds: one module a kind, each a generator and the loop that
offers its requests to the program. A traffic mix is a data file,
``<mix>.json`` beside them, that names its kind and its parameters."""
