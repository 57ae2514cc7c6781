"""Multi-device scaling (the reference has no distributed layer — see
SURVEY.md §2 'Parallelism' note; the capability-equivalent here is
ensemble data-parallelism over a device mesh)."""

from . import mesh, time_scan

__all__ = ["mesh", "time_scan"]
