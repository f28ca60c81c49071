"""Optimisation of the LM port: AdamW, learning-rate schedules and the
gradient codecs."""
