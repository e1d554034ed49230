"""Errors, dtypes and devices of the port."""
