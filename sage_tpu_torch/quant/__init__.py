"""Quantification: isobaric (TMT) reporter ions. Label-free quant
(``quant/lfq.py``) is not ported yet (ROADMAP Queue 1 item 10)."""

from . import tmt  # noqa: F401
