"""The benchmark of kubernetes_tpu_torch's Scheduler (``run.py``)."""
