"""Quantification: isobaric (TMT) reporter ions and label-free (LFQ)."""

from . import tmt  # noqa: F401
