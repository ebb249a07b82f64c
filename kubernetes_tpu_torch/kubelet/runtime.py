"""Container runtime boundary: the kubelet's CRI.

Reference: the kubelet drives pods through the CRI gRPC services
(pkg/kubelet/remote/remote_runtime.go:59, cri-api api.proto). Here the
boundary is a small in-process interface; FakeRuntime is the kubemark
hollow runtime (pkg/kubemark/hollow_kubelet.go:111-118 fake runtime/mounter)
with optional scripted completion so Job/controller tests can exercise
terminal phases.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ..api import objects as v1

# annotations understood by FakeRuntime (test/kubemark scripting)
ANN_RUN_SECONDS = "kubelet.fake/run-seconds"  # complete after N seconds
ANN_FAIL = "kubelet.fake/fail"  # terminal phase Failed instead of Succeeded
ANN_READY_AFTER = "kubelet.fake/ready-after"  # readiness passes after N s
ANN_UNHEALTHY_AFTER = "kubelet.fake/unhealthy-after"  # liveness fails after N s


class PodRuntime:
    """What the kubelet needs from a runtime: start, kill, observe."""

    def run_pod(self, pod: v1.Pod) -> str:
        """Start the pod's sandbox+containers; returns the sandbox IP."""
        raise NotImplementedError

    def kill_pod(self, pod_key: str) -> None:
        raise NotImplementedError

    def relist(self) -> Dict[str, str]:
        """PLEG relist (pkg/kubelet/pleg/generic.go): pod_key -> phase for
        every pod the runtime knows; phases are POD_RUNNING / POD_SUCCEEDED
        / POD_FAILED."""
        raise NotImplementedError

    def probe(self, pod_key: str, kind: str) -> bool:
        """Health check backing the kubelet's prober (pkg/probe): kind is
        'liveness' or 'readiness'. Unknown pods fail both."""
        return pod_key in self.relist()

    def restart_pod(self, pod_key: str) -> None:
        """Liveness remediation: restart the pod's containers in place
        (kill + recreate, same sandbox — kuberuntime's container restart).
        Default: no-op."""

    def logs(self, pod_key: str, tail_lines: Optional[int] = None) -> str:
        """Container log text (the GetContainerLogs surface kubectl logs
        reaches through the kubelet). Default: empty."""
        return ""

    def exec(self, pod_key: str, command) -> str:
        """One-shot command execution in the pod's sandbox (the ExecSync
        surface kubectl exec reaches through the kubelet). Default:
        unsupported."""
        raise NotImplementedError("runtime does not support exec")

    def exec_status(self, pod_key: str, command) -> tuple:
        """(output, exit_code) — the full ExecSync contract. Runtimes
        that can observe the exit status override this; the default
        preserves exec()'s output-only behavior with code 0."""
        return self.exec(pod_key, command), 0


class _FakePod:
    __slots__ = ("ip", "started", "run_seconds", "fail", "ready_after", "unhealthy_after")

    def __init__(
        self,
        ip: str,
        run_seconds: Optional[float],
        fail: bool,
        ready_after: float = 0.0,
        unhealthy_after: Optional[float] = None,
    ):
        self.ip = ip
        self.started = time.monotonic()
        self.run_seconds = run_seconds
        self.fail = fail
        self.ready_after = ready_after
        self.unhealthy_after = unhealthy_after


class FakeRuntime(PodRuntime):
    """Instant-start fake: every pod is Running immediately; scripted pods
    complete after ANN_RUN_SECONDS."""

    def __init__(self, ip_alloc):
        self._pods: Dict[str, _FakePod] = {}
        self._lock = threading.Lock()
        self._ip_alloc = ip_alloc  # seed -> ip

    def run_pod(self, pod: v1.Pod) -> str:
        ann = pod.metadata.annotations
        run_s = ann.get(ANN_RUN_SECONDS)
        unh = ann.get(ANN_UNHEALTHY_AFTER)
        fp = _FakePod(
            ip=self._ip_alloc(pod.metadata.uid),
            run_seconds=float(run_s) if run_s is not None else None,
            fail=ann.get(ANN_FAIL, "") not in ("", "false"),
            ready_after=float(ann.get(ANN_READY_AFTER, "0")),
            unhealthy_after=float(unh) if unh is not None else None,
        )
        with self._lock:
            self._pods[pod.metadata.key] = fp
        return fp.ip

    def kill_pod(self, pod_key: str) -> None:
        with self._lock:
            self._pods.pop(pod_key, None)

    def probe(self, pod_key: str, kind: str) -> bool:
        now = time.monotonic()
        with self._lock:
            fp = self._pods.get(pod_key)
            if fp is None:
                return False
            age = now - fp.started
            if kind == "readiness":
                return age >= fp.ready_after
            return fp.unhealthy_after is None or age < fp.unhealthy_after

    def restart_pod(self, pod_key: str) -> None:
        # container restart resets the clocks: readiness warms up again and
        # an unhealthy-after script becomes unhealthy again after the delay
        with self._lock:
            fp = self._pods.get(pod_key)
            if fp is not None:
                fp.started = time.monotonic()

    def relist(self) -> Dict[str, str]:
        now = time.monotonic()
        out: Dict[str, str] = {}
        with self._lock:
            for key, fp in self._pods.items():
                if (
                    fp.run_seconds is not None
                    and now - fp.started >= fp.run_seconds
                ):
                    out[key] = v1.POD_FAILED if fp.fail else v1.POD_SUCCEEDED
                else:
                    out[key] = v1.POD_RUNNING
        return out

    def logs(self, pod_key: str, tail_lines: Optional[int] = None) -> str:
        """Synthesized container log (the hollow runtime's stand-in for
        real container output): lifecycle lines with timestamps."""
        now = time.monotonic()
        with self._lock:
            fp = self._pods.get(pod_key)
            if fp is None:
                return ""
            age = now - fp.started
            lines = [
                f"[fake-runtime] pod {pod_key} sandbox started (ip {fp.ip})",
                f"[fake-runtime] uptime {age:.1f}s",
            ]
            if fp.run_seconds is not None:
                outcome = "fail" if fp.fail else "succeed"
                lines.append(
                    f"[fake-runtime] scripted to {outcome} after "
                    f"{fp.run_seconds:.1f}s"
                )
        if tail_lines is not None:
            lines = lines[-tail_lines:] if tail_lines > 0 else []
        return "\n".join(lines) + "\n" if lines else ""

    def exec(self, pod_key: str, command) -> str:
        """ExecSync against the fake sandbox: a few built-in commands give
        tests something real to assert on; everything else echoes."""
        with self._lock:
            fp = self._pods.get(pod_key)
        if fp is None:
            raise KeyError(f"pod {pod_key} has no running sandbox")
        cmd = list(command)
        if cmd[:1] == ["hostname"]:
            return pod_key.rsplit("/", 1)[-1] + "\n"
        if cmd[:1] == ["ip"]:
            return fp.ip + "\n"
        if cmd[:1] == ["echo"]:
            return " ".join(cmd[1:]) + "\n"
        return f"[fake-runtime] exec: {' '.join(cmd)}\n"
