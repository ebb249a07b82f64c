"""CRI transport: length-prefixed protobuf frames over a unix socket.

The reference kubelet dials the runtime's socket and speaks gRPC
(pkg/kubelet/remote/remote_runtime.go:59 grpc.DialContext). This build
keeps the identical architecture — protobuf request/response messages
across a real process boundary on a local socket — with a minimal framed
RPC instead of gRPC (no grpc python in the image):

    frame := u32(len(method)) method u32(len(payload)) payload
    reply := u8(status) u32(len(payload)) payload     status 0=ok, 1=error

Server side: ``CRIServer`` exposes any PodRuntime as a RuntimeService.
Client side: ``RemoteRuntime`` is a PodRuntime backed by the socket, so
the UNCHANGED kubelet sync loop drives pods through the wire
(kubelet/kubelet.py never knows which side of the boundary it's on).
"""

from __future__ import annotations

import logging
import os
import socket
import socketserver
import struct
import threading
from typing import Dict, Optional, Tuple

from ...api import objects as v1
from ..runtime import ANN_FAIL, ANN_RUN_SECONDS, PodRuntime
from . import api_pb2 as pb

logger = logging.getLogger("kubernetes_tpu.kubelet.cri")

_U32 = struct.Struct(">I")

_STATE_TO_PHASE = {
    pb.SANDBOX_READY: v1.POD_RUNNING,
    pb.SANDBOX_NOTREADY: v1.POD_RUNNING,
    pb.SANDBOX_SUCCEEDED: v1.POD_SUCCEEDED,
    pb.SANDBOX_FAILED: v1.POD_FAILED,
}
_PHASE_TO_STATE = {
    v1.POD_RUNNING: pb.SANDBOX_READY,
    v1.POD_SUCCEEDED: pb.SANDBOX_SUCCEEDED,
    v1.POD_FAILED: pb.SANDBOX_FAILED,
}


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _send_frame(sock: socket.socket, method: bytes, payload: bytes) -> None:
    sock.sendall(_U32.pack(len(method)) + method + _U32.pack(len(payload)) + payload)


def _recv_frame(sock: socket.socket) -> Tuple[bytes, bytes]:
    (mlen,) = _U32.unpack(_read_exact(sock, 4))
    method = _read_exact(sock, mlen)
    (plen,) = _U32.unpack(_read_exact(sock, 4))
    return method, _read_exact(sock, plen)


# ---------------------------------------------------------------------------
# server: PodRuntime -> RuntimeService
# ---------------------------------------------------------------------------


class CRIServer:
    """Serve a PodRuntime over a unix socket (the containerd side)."""

    def __init__(self, runtime: PodRuntime, socket_path: str):
        self.runtime = runtime
        self.socket_path = socket_path
        self._srv: Optional[socketserver.ThreadingUnixStreamServer] = None
        # sandbox id <-> pod bookkeeping (the runtime keys by pod key)
        self._meta: Dict[str, pb.PodSandboxMetadata] = {}
        self._ips: Dict[str, str] = {}
        self._images: Dict[str, int] = {}  # ImageService store: name -> bytes
        self._lock = threading.Lock()

    def start(self) -> None:
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        method, payload = _recv_frame(self.request)
                        status, resp = outer._dispatch(method.decode(), payload)
                        self.request.sendall(
                            bytes([status]) + _U32.pack(len(resp)) + resp
                        )
                except (ConnectionError, OSError):
                    pass

        self._srv = socketserver.ThreadingUnixStreamServer(
            self.socket_path, Handler
        )
        self._srv.daemon_threads = True
        threading.Thread(
            target=self._srv.serve_forever, daemon=True, name="cri-server"
        ).start()

    def stop(self) -> None:
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)

    # -- RuntimeService ------------------------------------------------------

    def _dispatch(self, method: str, payload: bytes) -> Tuple[int, bytes]:
        try:
            handler = getattr(self, f"_h_{method}", None)
            if handler is None:
                raise ValueError(f"unimplemented CRI method {method!r}")
            return 0, handler(payload)
        except Exception as e:  # error frames carry a StatusError
            err = pb.StatusError(message=f"{type(e).__name__}: {e}")
            return 1, err.SerializeToString()

    def _h_Version(self, payload: bytes) -> bytes:
        return pb.VersionResponse(
            runtime_name="kubernetes-tpu-fake", runtime_version="v1"
        ).SerializeToString()

    def _h_RunPodSandbox(self, payload: bytes) -> bytes:
        req = pb.RunPodSandboxRequest.FromString(payload)
        md = req.config.metadata
        pod = v1.Pod(
            metadata=v1.ObjectMeta(
                name=md.name,
                namespace=md.namespace,
                uid=md.uid,
                labels=dict(req.config.labels),
                annotations=dict(req.config.annotations),
            ),
            spec=v1.PodSpec(
                containers=[
                    v1.Container(
                        name=c.name,
                        image=c.image,
                        command=list(c.command),
                        args=list(c.args),
                    )
                    for c in req.config.containers
                ]
            ),
        )
        ip = self.runtime.run_pod(pod)
        sandbox_id = pod.metadata.key
        with self._lock:
            self._meta[sandbox_id] = pb.PodSandboxMetadata(
                name=md.name, namespace=md.namespace, uid=md.uid
            )
            self._ips[sandbox_id] = ip
        return pb.RunPodSandboxResponse(
            pod_sandbox_id=sandbox_id, ip=ip
        ).SerializeToString()

    def _h_StopPodSandbox(self, payload: bytes) -> bytes:
        req = pb.StopPodSandboxRequest.FromString(payload)
        self.runtime.kill_pod(req.pod_sandbox_id)
        return pb.StopPodSandboxResponse().SerializeToString()

    def _h_RemovePodSandbox(self, payload: bytes) -> bytes:
        req = pb.RemovePodSandboxRequest.FromString(payload)
        self.runtime.kill_pod(req.pod_sandbox_id)
        with self._lock:
            self._meta.pop(req.pod_sandbox_id, None)
            self._ips.pop(req.pod_sandbox_id, None)
        return pb.RemovePodSandboxResponse().SerializeToString()

    def _h_ListPodSandbox(self, payload: bytes) -> bytes:
        phases = self.runtime.relist()
        resp = pb.ListPodSandboxResponse()
        with self._lock:
            for key, phase in phases.items():
                sb = resp.items.add()
                sb.id = key
                sb.state = _PHASE_TO_STATE.get(phase, pb.SANDBOX_NOTREADY)
                sb.ip = self._ips.get(key, "")
                if key in self._meta:
                    sb.metadata.CopyFrom(self._meta[key])
        return resp.SerializeToString()

    def _h_ExecSync(self, payload: bytes) -> bytes:
        # exceptions (no sandbox / unsupported) become error frames in
        # _dispatch; a COMPLETED-but-failed command reports its real exit
        # code (the reference's ExecSyncResponse.exit_code)
        req = pb.ExecSyncRequest.FromString(payload)
        out, code = self.runtime.exec_status(
            req.pod_sandbox_id, list(req.command)
        )
        return pb.ExecSyncResponse(
            stdout=out.encode(), exit_code=code
        ).SerializeToString()

    def _h_ContainerLogs(self, payload: bytes) -> bytes:
        req = pb.ContainerLogsRequest.FromString(payload)
        text = self.runtime.logs(
            req.pod_sandbox_id,
            tail_lines=req.tail_lines or None,
        )
        return pb.ContainerLogsResponse(data=text.encode()).SerializeToString()

    # -- ImageService (subset) -----------------------------------------------
    # the runtime side keeps the image store (real runtimes track pulled
    # layers); this server holds it since PodRuntime has no image state

    def _h_PullImage(self, payload: bytes) -> bytes:
        req = pb.PullImageRequest.FromString(payload)
        name = req.image.image
        with self._lock:
            self._images[name] = 10_000_000  # nominal layer size
        return pb.PullImageResponse(image_ref=f"sha256:{name}").SerializeToString()

    def _h_ListImages(self, payload: bytes) -> bytes:
        resp = pb.ListImagesResponse()
        with self._lock:
            for name, size in sorted(self._images.items()):
                img = resp.images.add()
                img.id = f"sha256:{name}"
                img.repo_tags.append(name)
                img.size_bytes = size
        return resp.SerializeToString()

    def _h_ImageStatus(self, payload: bytes) -> bytes:
        req = pb.ImageStatusRequest.FromString(payload)
        resp = pb.ImageStatusResponse()
        with self._lock:
            size = self._images.get(req.image.image)
        if size is not None:
            resp.image.id = f"sha256:{req.image.image}"
            resp.image.repo_tags.append(req.image.image)
            resp.image.size_bytes = size
        return resp.SerializeToString()

    def _h_RemoveImage(self, payload: bytes) -> bytes:
        req = pb.RemoveImageRequest.FromString(payload)
        with self._lock:
            self._images.pop(req.image.image, None)
        return pb.RemoveImageResponse().SerializeToString()

    def _h_ImageFsInfo(self, payload: bytes) -> bytes:
        with self._lock:
            used = sum(self._images.values())
        return pb.ImageFsInfoResponse(
            used_bytes=used, capacity_bytes=100 * 1024 * 1024 * 1024
        ).SerializeToString()


# ---------------------------------------------------------------------------
# client: RuntimeService -> PodRuntime
# ---------------------------------------------------------------------------


class RemoteRuntime(PodRuntime):
    """PodRuntime over the CRI socket (the kubelet side,
    remote_runtime.go's role). One connection, calls serialized — the
    kubelet's sync loop and PLEG take turns like the reference's
    single-client gRPC channel."""

    def __init__(self, socket_path: str, timeout: float = 30.0):
        self.socket_path = socket_path
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def _conn(self) -> socket.socket:
        if self._sock is None:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.settimeout(self.timeout)
            s.connect(self.socket_path)
            self._sock = s
        return self._sock

    def _call(self, method: str, req) -> bytes:
        with self._lock:
            try:
                sock = self._conn()
                _send_frame(sock, method.encode(), req.SerializeToString())
                status = _read_exact(sock, 1)[0]
                (plen,) = _U32.unpack(_read_exact(sock, 4))
                payload = _read_exact(sock, plen)
            except (ConnectionError, OSError):
                # crash-only runtime: drop the connection, surface the error
                if self._sock is not None:
                    self._sock.close()
                    self._sock = None
                raise
        if status != 0:
            err = pb.StatusError.FromString(payload)
            raise RuntimeError(f"CRI {method}: {err.message}")
        return payload

    def version(self) -> str:
        resp = pb.VersionResponse.FromString(
            self._call("Version", pb.VersionRequest())
        )
        return f"{resp.runtime_name}/{resp.runtime_version}"

    # -- PodRuntime ----------------------------------------------------------

    def run_pod(self, pod: v1.Pod) -> str:
        cfg = pb.PodSandboxConfig(
            metadata=pb.PodSandboxMetadata(
                name=pod.metadata.name,
                namespace=pod.metadata.namespace,
                uid=pod.metadata.uid,
            )
        )
        for k, val in pod.metadata.labels.items():
            cfg.labels[k] = val
        for k, val in pod.metadata.annotations.items():
            if k in (ANN_RUN_SECONDS, ANN_FAIL):
                cfg.annotations[k] = val
        for c in pod.spec.containers:
            cc = cfg.containers.add()
            cc.name = c.name
            cc.image = c.image
            cc.command.extend(c.command)
            cc.args.extend(c.args)
        resp = pb.RunPodSandboxResponse.FromString(
            self._call("RunPodSandbox", pb.RunPodSandboxRequest(config=cfg))
        )
        return resp.ip

    def kill_pod(self, pod_key: str) -> None:
        self._call(
            "StopPodSandbox", pb.StopPodSandboxRequest(pod_sandbox_id=pod_key)
        )
        self._call(
            "RemovePodSandbox",
            pb.RemovePodSandboxRequest(pod_sandbox_id=pod_key),
        )

    def relist(self) -> Dict[str, str]:
        resp = pb.ListPodSandboxResponse.FromString(
            self._call("ListPodSandbox", pb.ListPodSandboxRequest())
        )
        return {
            sb.id: _STATE_TO_PHASE.get(sb.state, v1.POD_RUNNING)
            for sb in resp.items
        }

    def exec(self, pod_key: str, command) -> str:
        return self.exec_status(pod_key, command)[0]

    def exec_status(self, pod_key: str, command) -> Tuple[str, int]:
        resp = pb.ExecSyncResponse.FromString(
            self._call(
                "ExecSync",
                pb.ExecSyncRequest(
                    pod_sandbox_id=pod_key, command=list(command)
                ),
            )
        )
        return resp.stdout.decode(errors="replace"), resp.exit_code

    def logs(self, pod_key: str, tail_lines: Optional[int] = None) -> str:
        resp = pb.ContainerLogsResponse.FromString(
            self._call(
                "ContainerLogs",
                pb.ContainerLogsRequest(
                    pod_sandbox_id=pod_key, tail_lines=tail_lines or 0
                ),
            )
        )
        return resp.data.decode(errors="replace")

    # -- ImageService ---------------------------------------------------------

    def pull_image(self, image: str) -> str:
        resp = pb.PullImageResponse.FromString(
            self._call(
                "PullImage",
                pb.PullImageRequest(image=pb.ImageSpec(image=image)),
            )
        )
        return resp.image_ref

    def list_images(self) -> Dict[str, int]:
        resp = pb.ListImagesResponse.FromString(
            self._call("ListImages", pb.ListImagesRequest())
        )
        return {img.repo_tags[0]: img.size_bytes for img in resp.images}

    def image_status(self, image: str) -> Optional[str]:
        resp = pb.ImageStatusResponse.FromString(
            self._call(
                "ImageStatus",
                pb.ImageStatusRequest(image=pb.ImageSpec(image=image)),
            )
        )
        return resp.image.id or None

    def remove_image(self, image: str) -> None:
        self._call(
            "RemoveImage",
            pb.RemoveImageRequest(image=pb.ImageSpec(image=image)),
        )

    def image_fs_info(self) -> Tuple[int, int]:
        resp = pb.ImageFsInfoResponse.FromString(
            self._call("ImageFsInfo", pb.ImageFsInfoRequest())
        )
        return resp.used_bytes, resp.capacity_bytes

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                self._sock.close()
                self._sock = None
