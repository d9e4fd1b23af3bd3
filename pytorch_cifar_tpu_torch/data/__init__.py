"""Data path of the port: input normalization and host staging buffers."""
