"""Multi-device and multi-process execution of the port (counterpart of
``sage_tpu/parallel``): ``sharding`` searches on a ("data", "model")
grid of devices from one process, ``multihost`` splits a run's files
over processes."""
