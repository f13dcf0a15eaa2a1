"""The port's data pipeline: ``pipeline`` (the synthetic LM stream, numpy)."""
