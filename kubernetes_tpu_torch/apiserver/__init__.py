"""REST API server façade + REST client.

Reference: the kube-apiserver HTTP layer (staging/src/k8s.io/apiserver,
composed at cmd/kube-apiserver/app/server.go:169) reduced to its
scheduling-relevant contract: CRUD + list + watch streams over the
versioned store, `/api/v1` paths, JSON wire format.
"""

from .rest import APIServerHTTP, serve  # noqa: F401
from .client import RESTClient  # noqa: F401
from .cacher import Cacher  # noqa: F401
