"""Data pipelines of the LM port."""
