"""Deterministic numpy data streams (shared bit for bit with the
reference's, so both packages see identical batches)."""
