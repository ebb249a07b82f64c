"""Job controller: run pods to completion with parallelism and backoff.

Reference: pkg/controller/job/job_controller.go (syncJob) — maintain up to
spec.parallelism active pods until spec.completions pods have succeeded;
past spec.backoffLimit failures the Job is marked Failed and active pods
are removed. completions=None means "any one success completes the job"
(the reference's non-indexed, nil-completions mode).
"""

from __future__ import annotations

import copy
import logging
import time
import uuid

from ..api import objects as v1
from ..client.apiserver import AlreadyExists, NotFound
from .base import WorkqueueController

logger = logging.getLogger("kubernetes_tpu.controller.job")

COND_COMPLETE = "Complete"
COND_FAILED = "Failed"


class JobController(WorkqueueController):
    name = "job"
    primary_kind = "jobs"
    secondary_kinds = ("pods",)
    owner_kind = "Job"

    def sync(self, key: str) -> None:
        ns, _, name = key.partition("/")
        try:
            job = self.server.get("jobs", ns, name)
        except NotFound:
            return
        if any(
            c.type in (COND_COMPLETE, COND_FAILED) and c.status == "True"
            for c in job.status.conditions
        ):
            return  # terminal

        pods = self.owned_pods(ns, "Job", name)
        active = [
            p
            for p in pods
            if p.status.phase not in (v1.POD_SUCCEEDED, v1.POD_FAILED)
        ]
        succeeded = sum(1 for p in pods if p.status.phase == v1.POD_SUCCEEDED)
        failed = sum(1 for p in pods if p.status.phase == v1.POD_FAILED)

        deadline_exceeded = (
            job.spec.active_deadline_seconds is not None
            and job.status.start_time is not None
            and time.time() - job.status.start_time
            > job.spec.active_deadline_seconds
        )
        if failed > job.spec.backoff_limit or deadline_exceeded:
            for p in active:
                self._delete_pod(p)
            reason = (
                "DeadlineExceeded" if deadline_exceeded else "BackoffLimitExceeded"
            )
            self._update_status(
                job, 0, succeeded, failed, condition=(COND_FAILED, reason)
            )
            return

        completions = job.spec.completions
        if completions is None:
            done = succeeded > 0
            want_active = 0 if done else job.spec.parallelism
        else:
            remaining = max(0, completions - succeeded)
            done = remaining == 0
            want_active = min(job.spec.parallelism, remaining)

        if done:
            for p in active:
                self._delete_pod(p)
            self._update_status(
                job, 0, succeeded, failed, condition=(COND_COMPLETE, "")
            )
            return

        if len(active) < want_active:
            for _ in range(want_active - len(active)):
                self._create_pod(job)
        elif len(active) > want_active:
            for p in active[: len(active) - want_active]:
                self._delete_pod(p)
        self._update_status(job, max(len(active), want_active), succeeded, failed)

    def _create_pod(self, job: v1.Job) -> None:
        tmpl = job.spec.template
        spec = copy.deepcopy(tmpl.spec)
        if spec.restart_policy == "Always":
            spec.restart_policy = "OnFailure"  # jobs must terminate
        pod = v1.Pod(
            metadata=v1.ObjectMeta(
                name=f"{job.metadata.name}-{uuid.uuid4().hex[:5]}",
                namespace=job.metadata.namespace,
                labels=dict(
                    tmpl.metadata.labels
                    or job.spec.selector
                    or {"job-name": job.metadata.name}
                ),
                owner_references=[
                    v1.OwnerReference(
                        kind="Job",
                        name=job.metadata.name,
                        uid=job.metadata.uid,
                        controller=True,
                    )
                ],
            ),
            spec=spec,
        )
        try:
            self.server.create("pods", pod)
        except AlreadyExists:
            pass

    def _delete_pod(self, pod: v1.Pod) -> None:
        try:
            self.server.delete("pods", pod.metadata.namespace, pod.metadata.name)
        except NotFound:
            pass

    def _update_status(
        self, job: v1.Job, active: int, succeeded: int, failed: int, condition=None
    ) -> None:
        def mutate(cur):
            st = cur.status
            changed = False
            if st.start_time is None:
                st.start_time = time.time()
                changed = True
            if (st.active, st.succeeded, st.failed) != (active, succeeded, failed):
                st.active, st.succeeded, st.failed = active, succeeded, failed
                changed = True
            if condition is not None and not any(
                c.type == condition[0] and c.status == "True"
                for c in st.conditions
            ):
                st.conditions.append(
                    v1.PodCondition(
                        type=condition[0], status="True", reason=condition[1]
                    )
                )
                if condition[0] == COND_COMPLETE:
                    st.completion_time = time.time()
                changed = True
            return cur if changed else None

        try:
            self.server.guaranteed_update(
                "jobs", job.metadata.namespace, job.metadata.name, mutate
            )
        except NotFound:
            pass
