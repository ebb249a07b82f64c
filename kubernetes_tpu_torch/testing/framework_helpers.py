"""Plugin-registration DSL + framework builder for tests.

Reference: pkg/scheduler/testing/framework_helpers.go:25,37 — tests declare
exactly the plugins they exercise via RegisterPluginFunc entries and get a
runnable Framework, instead of hand-assembling registry + plugin set.

    fw = new_framework(
        register_queue_sort("PrioritySort"),
        register_filter("NodeResourcesFit"),
        register_score("NodeResourcesLeastAllocated", weight=2),
        register_plugin("Custom", lambda ctx: MyPlugin(), filter=True),
        context={"snapshot_getter": lambda: snap},
    )
"""

from __future__ import annotations

from typing import Callable, Optional

from ..scheduler.framework.registry import PluginSet, Registry, default_registry
from ..scheduler.framework.runtime import Framework

RegisterFunc = Callable[[Registry, PluginSet], None]


def register_plugin(
    name: str,
    factory: Optional[Callable] = None,
    *,
    queue_sort: bool = False,
    pre_filter: bool = False,
    filter: bool = False,  # noqa: A002 — mirrors the extension point name
    pre_score: bool = False,
    score: bool = False,
    weight: float = 1.0,
    reserve: bool = False,
    permit: bool = False,
    pre_bind: bool = False,
    bind: bool = False,
    post_bind: bool = False,
    unreserve: bool = False,
) -> RegisterFunc:
    """General entry: optionally override the factory, and enable the named
    extension points for the plugin."""

    def apply(reg: Registry, ps: PluginSet) -> None:
        if factory is not None:
            reg[name] = factory
        if queue_sort:
            ps.queue_sort = [name]
        if pre_filter:
            ps.pre_filter.append(name)
        if filter:
            ps.filter.append(name)
        if pre_score:
            ps.pre_score.append(name)
        if score:
            ps.score.append((name, weight))
        if reserve:
            ps.reserve.append(name)
        if permit:
            ps.permit.append(name)
        if pre_bind:
            ps.pre_bind.append(name)
        if bind:
            ps.bind = [name]
        if post_bind:
            ps.post_bind.append(name)
        if unreserve:
            ps.unreserve.append(name)

    return apply


def register_queue_sort(name: str, factory=None) -> RegisterFunc:
    return register_plugin(name, factory, queue_sort=True)


def register_pre_filter(name: str, factory=None) -> RegisterFunc:
    return register_plugin(name, factory, pre_filter=True)


def register_filter(name: str, factory=None) -> RegisterFunc:
    return register_plugin(name, factory, filter=True)


def register_score(name: str, factory=None, weight: float = 1.0) -> RegisterFunc:
    return register_plugin(name, factory, score=True, weight=weight)


def register_bind(name: str, factory=None) -> RegisterFunc:
    return register_plugin(name, factory, bind=True)


def new_framework(*registrations: RegisterFunc, context: Optional[dict] = None) -> Framework:
    """Framework with ONLY the registered plugins enabled (st.NewFramework)."""
    reg = default_registry()
    ps = PluginSet(
        queue_sort=["PrioritySort"],
        filter=[],
        bind=["DefaultBinder"],
    )
    for r in registrations:
        r(reg, ps)
    return Framework(registry=reg, plugin_set=ps, context=context or {})
