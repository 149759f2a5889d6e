"""Utilities of the port: the device-time meter (``devprof``)."""
