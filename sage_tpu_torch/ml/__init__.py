"""Rescoring / statistics stack: LDA, KDE PEP, q-values, RT/IM models.

Pure linear algebra on columnar PSM data (reference crates/sage/src/ml/).
"""

from . import gauss, kde, lda, mobility_model, qvalue, regression  # noqa: F401
from . import retention_alignment, retention_model  # noqa: F401
