"""The narrow search's share of its roofline: the least time one H100
needs for the work the window's spectra need (``roofline.narrow_work``:
operations at 67 T f32 ops/s or bytes at 3.35 TB/s, whichever is
larger), over the device time of every operation in the traced window."""

import importlib


def read(facts, cell):
    tr = facts.get("trace")
    work = facts.get("narrow_work")
    if not tr or not work or tr["device_s"] <= 0:
        return None
    roofline = importlib.import_module("benchmark.roofline")
    least, _ = roofline.least_seconds(work)
    return 100.0 * least / tr["device_s"]
