"""Utilities of the port: the device-time meter (``devprof``) and the
spans and counters (``trace``)."""
