"""CronJob controller: spawn Jobs on a cron schedule.

Reference: pkg/controller/cronjob/cronjob_controller.go (syncOne +
utils.go getRecentUnmetScheduleTimes) — every sync period, for each
CronJob: find the most recent unmet schedule time; if it is within
startingDeadlineSeconds, create a Job named ``<cronjob>-<scheduled unix
minute>`` (idempotent: the deterministic name makes double-creates
AlreadyExists no-ops); apply the concurrency policy (Allow | Forbid |
Replace); prune finished Jobs beyond the history limits.
"""

from __future__ import annotations

import copy
import logging
import threading
import time
from typing import List, Optional

from ..api import objects as v1
from ..client.apiserver import AlreadyExists, NotFound
from ..utils.cron import CronSchedule
from .base import WorkqueueController

logger = logging.getLogger("kubernetes_tpu.controller.cronjob")


def _job_is_finished(job: v1.Job) -> bool:
    return any(
        c.type in ("Complete", "Failed") and c.status == "True"
        for c in job.status.conditions
    )


class CronJobController(WorkqueueController):
    name = "cronjob"
    primary_kind = "cronjobs"
    secondary_kinds = ("jobs",)
    owner_kind = "CronJob"

    def __init__(self, server, workers: int = 1, sync_period: float = 2.0):
        super().__init__(server, workers=workers)
        self.sync_period = sync_period

    def start(self) -> None:
        super().start()
        # the reference controller re-lists every 10s (syncAll); schedules
        # fire from this tick, not from watch events
        self.start_ticker("cronjob-tick", self.sync_period, self._enqueue_all)

    def _enqueue_all(self) -> None:
        cjs, _ = self.server.list("cronjobs")
        for cj in cjs:
            self.queue.add(cj.metadata.key)

    def sync(self, key: str) -> None:
        ns, _, name = key.partition("/")
        try:
            cj = self.server.get("cronjobs", ns, name)
        except NotFound:
            return
        jobs, _ = self.server.list("jobs", namespace=ns)
        owned = [
            j
            for j in jobs
            if any(
                r.controller and r.kind == "CronJob" and r.name == name
                for r in j.metadata.owner_references
            )
        ]
        active = [j for j in owned if not _job_is_finished(j)]
        self._update_active_status(ns, name, [j.metadata.key for j in active])
        self._prune_history(cj, owned)
        if cj.spec.suspend:
            return

        now = time.time()
        sched = CronSchedule(cj.spec.schedule)
        # most recent unmet time after the last handled schedule; creation
        # time anchors the first window
        anchor = cj.status.last_schedule_time or cj.metadata.creation_timestamp or now
        try:
            next_t = sched.next_after(anchor)
        except ValueError:
            logger.warning("cronjob %s: unsatisfiable schedule %r", key, cj.spec.schedule)
            return
        if next_t > now:
            return  # nothing due yet
        # walk to the LAST unmet time <= now (missed runs collapse into one,
        # like the reference when too many schedules are missed)
        scheduled_t = next_t
        while True:
            nxt = sched.next_after(scheduled_t)
            if nxt > now:
                break
            scheduled_t = nxt
        if (
            cj.spec.starting_deadline_seconds is not None
            and now - scheduled_t > cj.spec.starting_deadline_seconds
        ):
            self._bump_last_schedule(ns, name, scheduled_t)
            return  # missed the starting deadline: skip this run

        if active:
            if cj.spec.concurrency_policy == v1_FORBID:
                # do NOT bump last_schedule_time: the missed run starts once
                # the active job finishes (subject to startingDeadline) —
                # bumping here would drop it permanently (syncOne semantics)
                return
            if cj.spec.concurrency_policy == v1_REPLACE:
                for j in active:
                    try:
                        self.server.delete("jobs", ns, j.metadata.name)
                    except NotFound:
                        pass

        job = self._job_for(cj, scheduled_t)
        try:
            self.server.create("jobs", job)
        except AlreadyExists:
            pass  # deterministic name: this run already fired
        self._bump_last_schedule(ns, name, scheduled_t)

    # -- helpers --------------------------------------------------------------

    def _job_for(self, cj: v1.CronJob, scheduled_t: float) -> v1.Job:
        tpl = cj.spec.job_template
        job = v1.Job(
            metadata=v1.ObjectMeta(
                name=f"{cj.metadata.name}-{int(scheduled_t // 60)}",
                namespace=cj.metadata.namespace,
                labels=dict(tpl.metadata.labels),
                annotations=dict(tpl.metadata.annotations),
                owner_references=[
                    v1.OwnerReference(
                        kind="CronJob",
                        name=cj.metadata.name,
                        uid=cj.metadata.uid,
                        controller=True,
                    )
                ],
            ),
            spec=copy.deepcopy(tpl.spec),
        )
        return job

    def _prune_history(self, cj: v1.CronJob, owned: List[v1.Job]) -> None:
        for cond, limit in (
            ("Complete", cj.spec.successful_jobs_history_limit),
            ("Failed", cj.spec.failed_jobs_history_limit),
        ):
            finished = sorted(
                (
                    j
                    for j in owned
                    if any(
                        c.type == cond and c.status == "True"
                        for c in j.status.conditions
                    )
                ),
                key=lambda j: j.metadata.creation_timestamp or 0.0,
            )
            for j in finished[: max(0, len(finished) - limit)]:
                try:
                    self.server.delete("jobs", j.metadata.namespace, j.metadata.name)
                except NotFound:
                    pass

    def _bump_last_schedule(self, ns: str, name: str, t: float) -> None:
        def mutate(cur):
            if (cur.status.last_schedule_time or 0) >= t:
                return None
            cur.status.last_schedule_time = t
            return cur

        try:
            self.server.guaranteed_update("cronjobs", ns, name, mutate)
        except NotFound:
            pass

    def _update_active_status(self, ns: str, name: str, active_keys: List[str]) -> None:
        def mutate(cur):
            if cur.status.active == active_keys:
                return None
            cur.status.active = active_keys
            return cur

        try:
            self.server.guaranteed_update("cronjobs", ns, name, mutate)
        except NotFound:
            pass


v1_FORBID = "Forbid"
v1_REPLACE = "Replace"
