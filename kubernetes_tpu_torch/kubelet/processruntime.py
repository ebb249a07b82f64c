"""ProcessRuntime: real host-process supervision behind the CRI boundary.

The reference kubelet's runtime starts real containers through containerd
(pkg/kubelet/kuberuntime SyncPod -> CRI RunPodSandbox/CreateContainer/
StartContainer). This sandboxed build has no container engine, but it
does have a real OS: each container becomes a SUPERVISED HOST PROCESS in
its own process group with captured stdout/stderr, real exit codes, real
signals (SIGTERM -> grace -> SIGKILL, the reference's termination
sequence), and real per-pod CPU/RSS accounting read from /proc — the
"cgroup reads" of this environment. Everything the kubelet observes
(PLEG phase transitions, probes, logs, exec) comes from the live
processes, not bookkeeping.

A container without a command runs the pause-equivalent (a plain
``sleep``), so workloads that never specify commands behave like the
FakeRuntime's always-Running pods. Serve it across the framed CRI socket
with cri.wire.CRIServer for the full out-of-process topology.
"""

from __future__ import annotations

import os
import signal
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..api import objects as v1
from .runtime import PodRuntime

_PAUSE = ["/bin/sleep", "86400"]  # the pause container's role


class _Proc:
    __slots__ = ("name", "popen", "log_path")

    def __init__(self, name: str, popen, log_path: str):
        self.name = name
        self.popen = popen
        self.log_path = log_path


class _PodProcs:
    __slots__ = ("ip", "procs", "dir", "spec")

    def __init__(self, ip: str, procs: List[_Proc], d: str, spec: v1.Pod):
        self.ip = ip
        self.procs = procs
        self.dir = d
        self.spec = spec


class ProcessRuntime(PodRuntime):
    def __init__(self, ip_alloc, root_dir: str, grace_s: float = 2.0):
        self._pods: Dict[str, _PodProcs] = {}
        self._lock = threading.Lock()
        self._ip_alloc = ip_alloc
        self._root = root_dir
        self._grace_s = grace_s
        os.makedirs(root_dir, exist_ok=True)

    # -- lifecycle -----------------------------------------------------------

    def run_pod(self, pod: v1.Pod) -> str:
        key = pod.metadata.key
        pod_dir = os.path.join(self._root, key.replace("/", "_"))
        os.makedirs(pod_dir, exist_ok=True)
        procs: List[_Proc] = []
        try:
            for c in pod.spec.containers:
                # command overrides the (nonexistent) image entrypoint;
                # args-only becomes the argv — with no image metadata to
                # supply an entrypoint, failing loudly on a non-executable
                # args[0] beats silently running the pause sleep
                if c.command:
                    cmd = list(c.command) + list(c.args)
                elif c.args:
                    cmd = list(c.args)
                else:
                    cmd = _PAUSE
                log_path = os.path.join(pod_dir, f"{c.name or 'c'}.log")
                logf = open(log_path, "ab")
                try:
                    p = subprocess.Popen(
                        cmd,
                        stdout=logf,
                        stderr=subprocess.STDOUT,
                        cwd=pod_dir,
                        start_new_session=True,  # own pgid: kill takes the tree
                        env={**os.environ, "POD_NAME": pod.metadata.name,
                             "POD_NAMESPACE": pod.metadata.namespace},
                    )
                finally:
                    logf.close()  # child holds its own fd
                procs.append(_Proc(c.name or "c", p, log_path))
        except (OSError, FileNotFoundError):
            for pr in procs:  # partial start: kill what launched
                self._kill_proc(pr)
            raise
        ip = self._ip_alloc(pod.metadata.uid)
        with self._lock:
            self._pods[key] = _PodProcs(ip, procs, pod_dir, pod)
        return ip

    def _kill_proc(self, pr: _Proc) -> None:
        """SIGTERM the process group, grace, then SIGKILL (the kubelet's
        termination sequence)."""
        p = pr.popen
        if p.poll() is not None:
            return
        try:
            os.killpg(p.pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            return
        try:
            p.wait(timeout=self._grace_s)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
            p.wait(timeout=5)

    def kill_pod(self, pod_key: str) -> None:
        with self._lock:
            pp = self._pods.pop(pod_key, None)
        if pp is None:
            return
        for pr in pp.procs:
            self._kill_proc(pr)

    def restart_pod(self, pod_key: str) -> None:
        """Liveness remediation: kill + recreate the containers in place."""
        with self._lock:
            pp = self._pods.get(pod_key)
        if pp is None:
            return
        spec = pp.spec
        self.kill_pod(pod_key)
        self.run_pod(spec)

    # -- observation ---------------------------------------------------------

    def relist(self) -> Dict[str, str]:
        """PLEG from real process states: all containers exited 0 →
        Succeeded; any non-zero exit (with no survivor to restart) →
        Failed; otherwise Running."""
        out: Dict[str, str] = {}
        with self._lock:
            pods = dict(self._pods)
        for key, pp in pods.items():
            codes = [pr.popen.poll() for pr in pp.procs]
            if all(c is not None for c in codes):
                out[key] = (
                    v1.POD_SUCCEEDED
                    if all(c == 0 for c in codes)
                    else v1.POD_FAILED
                )
            else:
                out[key] = v1.POD_RUNNING
        return out

    def probe(self, pod_key: str, kind: str) -> bool:
        with self._lock:
            pp = self._pods.get(pod_key)
        if pp is None:
            return False
        return all(pr.popen.poll() is None for pr in pp.procs)

    def logs(self, pod_key: str, tail_lines: Optional[int] = None) -> str:
        with self._lock:
            pp = self._pods.get(pod_key)
        if pp is None:
            return ""
        chunks = []
        for pr in pp.procs:
            try:
                with open(pr.log_path, "r", errors="replace") as f:
                    chunks.append(f.read())
            except OSError:
                pass
        text = "".join(chunks)
        if tail_lines is not None:
            lines = text.splitlines()
            lines = lines[-tail_lines:] if tail_lines > 0 else []
            return "\n".join(lines) + ("\n" if lines else "")
        return text

    def exec(self, pod_key: str, command) -> str:
        return self.exec_status(pod_key, command)[0]

    def exec_status(self, pod_key: str, command) -> Tuple[str, int]:
        with self._lock:
            pp = self._pods.get(pod_key)
        if pp is None:
            raise KeyError(f"pod {pod_key} has no running sandbox")
        r = subprocess.run(
            list(command), cwd=pp.dir, capture_output=True, text=True,
            timeout=30,
        )
        return r.stdout + r.stderr, r.returncode

    # -- resource accounting (the /proc "cgroup read") -----------------------

    def pod_stats(self, pod_key: str) -> Tuple[float, int]:
        """(cpu_seconds, rss_bytes) summed over the pod's live processes,
        from /proc/<pid>/stat fields 14-15 (utime+stime) and statm RSS —
        the summary API the kubelet's eviction manager and metrics
        endpoints consume."""
        with self._lock:
            pp = self._pods.get(pod_key)
        if pp is None:
            return 0.0, 0
        hz = os.sysconf("SC_CLK_TCK")
        page = os.sysconf("SC_PAGE_SIZE")
        cpu = 0.0
        rss = 0
        for pr in pp.procs:
            pid = pr.popen.pid
            if pr.popen.poll() is not None:
                continue
            try:
                with open(f"/proc/{pid}/stat") as f:
                    parts = f.read().rsplit(") ", 1)[1].split()
                # post-comm fields: utime is index 11, stime 12 (absolute
                # fields 14-15, comm+state consumed by the rsplit)
                cpu += (int(parts[11]) + int(parts[12])) / hz
                with open(f"/proc/{pid}/statm") as f:
                    rss += int(f.read().split()[1]) * page
            except (OSError, IndexError, ValueError):
                continue
        return cpu, rss

    def running_pods(self) -> List[str]:
        with self._lock:
            return sorted(self._pods)
