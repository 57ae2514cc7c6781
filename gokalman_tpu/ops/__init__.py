"""Hot-path ops: fused ensemble pipelines and the fused GPU kernel.

This is the "native tier" replacing the reference's gonum/BLAS calls
(SURVEY.md §2 note): the per-step small-matrix algebra is restructured
so the per-run work is pure batched elementwise arithmetic over the
ensemble axis, with the run-independent covariance/gain recurrence
computed once instead of per run.
"""

from . import assoc_scan, ensemble

__all__ = ["assoc_scan", "ensemble"]
