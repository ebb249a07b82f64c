"""CRI: the kubelet <-> runtime process boundary (protobuf over a unix
socket — reference cri-api + kubelet/remote)."""

from .wire import CRIServer, RemoteRuntime  # noqa: F401
