"""The dense LM of the port: configuration, layers, attention, blocks and
the serving steps."""
