from .proxy import ClusterIPAllocator, Proxier  # noqa: F401
