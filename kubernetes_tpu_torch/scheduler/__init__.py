"""Scheduler: the device-facing half of the wave path (wavepath.py). The
Scheduler class, its queue, cache, framework and bind are later slices."""
