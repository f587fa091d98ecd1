"""Utilities of the port: profiling hooks."""
