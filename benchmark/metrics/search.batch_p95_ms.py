"""95th percentile, over the window's batches, of the milliseconds from a
batch handed to ``Scorer.score_stream`` to its FeatureTable yielded (the
benchmark's span; two batches are in flight, so it holds the wait)."""

import numpy as np


def read(facts, cell):
    s = facts.get("batch_s") or []
    if len(s) < 2:
        return None
    return float(np.percentile(np.asarray(s) * 1000.0, 95))
