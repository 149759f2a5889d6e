"""Multi-process execution of the port (counterpart of
``sage_tpu/parallel``; the multi-device mesh is not ported yet)."""
