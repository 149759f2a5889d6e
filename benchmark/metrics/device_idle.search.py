"""Share of the traced window in which no operation ran on the device
(the profiler's device intervals, merged), in percent."""


def read(facts, cell):
    tr = facts.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["n_ops"] == 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
