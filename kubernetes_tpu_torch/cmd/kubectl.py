"""kubectl-equivalent CLI over the REST API.

Reference: staging/src/k8s.io/kubectl/pkg/cmd — the core verbs a scheduler
user needs: get, describe, create/apply -f, delete, bind (debug helper),
cordon/uncordon, taint. Server address via --server or KUBECTL_TPU_SERVER.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from ..api import serialization as codec
from ..apiserver.client import RESTClient
from ..client.apiserver import Conflict, NotFound


def _update_with_retry(client: RESTClient, resource: str, mutate, ns: str, name: str):
    """get → mutate → update, retrying version conflicts (the CLI's
    RetryOnConflict helper): controllers touch status concurrently."""
    for _ in range(5):
        obj = client.get(resource, ns, name)
        res = mutate(obj)
        if res is None:
            return obj
        try:
            return client.update(resource, obj)
        except Conflict:
            continue
    raise SystemExit(f"error: conflict updating {resource}/{name} persisted")

ALIASES = {
    "pod": "pods",
    "po": "pods",
    "node": "nodes",
    "no": "nodes",
    "svc": "services",
    "service": "services",
    "pv": "persistentvolumes",
    "pvc": "persistentvolumeclaims",
    "sc": "storageclasses",
    "ev": "events",
    "event": "events",
    "deployment": "deployments",
    "deploy": "deployments",
    "replicaset": "replicasets",
    "rs": "replicasets",
    "statefulset": "statefulsets",
    "sts": "statefulsets",
    "daemonset": "daemonsets",
    "ds": "daemonsets",
    "job": "jobs",
    "cronjob": "cronjobs",
    "cj": "cronjobs",
    "hpa": "horizontalpodautoscalers",
    "quota": "resourcequotas",
    "cm": "configmaps",
    "configmap": "configmaps",
    "secret": "secrets",
    "sa": "serviceaccounts",
    "crd": "customresourcedefinitions",
    "ns": "namespaces",
    "namespace": "namespaces",
}


# shared with the store's namespace normalization (one source of truth)
from ..api.serialization import CLUSTER_SCOPED  # noqa: E402


def _resource(arg: str) -> str:
    return ALIASES.get(arg, arg)


def _load_objects(path: str) -> List[tuple]:
    """File (JSON, JSON list, or YAML if available) → [(resource, obj)]."""
    if path == "-":
        text = sys.stdin.read()
    else:
        with open(path) as f:
            text = f.read()
    try:
        data = json.loads(text)
        docs = data if isinstance(data, list) else [data]
    except json.JSONDecodeError:
        try:
            import yaml  # type: ignore

            docs = [d for d in yaml.safe_load_all(text) if d]
        except ImportError:
            raise SystemExit("file is not JSON and PyYAML is unavailable")
    return [codec.decode_any(doc) for doc in docs]


def cmd_get(client: RESTClient, args) -> int:
    resource = _resource(args.resource)
    if args.name:
        try:
            obj = client.get(resource, args.namespace, args.name)
        except NotFound:
            obj = client.get(resource, "", args.name)
        if args.output == "json":
            print(json.dumps(codec.encode(obj), indent=2))
        else:
            _print_table(resource, [obj], wide=args.output == "wide")
        return 0
    objs, rv = client.list(resource)

    def _matches(o) -> bool:
        if (
            not getattr(args, "all_namespaces", False)
            and args.namespace
            and resource not in CLUSTER_SCOPED
            and o.metadata.namespace != args.namespace
        ):
            return False
        for term in (args.selector or "").split(","):
            if not term:
                continue
            if "!=" in term:
                k, _, want = term.partition("!=")
                if o.metadata.labels.get(k) == want:
                    return False
            elif "=" in term:
                k, _, want = term.partition("=")
                if o.metadata.labels.get(k.rstrip("=")) != want:
                    return False
            elif term not in o.metadata.labels:  # bare key: existence
                return False
        return True

    objs = [o for o in objs if _matches(o)]
    if args.output == "json":
        print(json.dumps([codec.encode(o) for o in objs], indent=2))
    else:
        _print_table(resource, objs, wide=args.output == "wide")
    if getattr(args, "watch", False):
        # stream subsequent changes (kubectl get -w), same filters as the
        # initial list; on 410 Gone re-list silently like the reflector
        from ..client.apiserver import Expired
        from ..runtime.watch import BOOKMARK

        try:
            w = client.watch(resource, from_version=rv)
        except Expired:
            objs, rv = client.list(resource)
            w = client.watch(resource, from_version=rv)
        try:
            while True:
                ev = w.get(timeout=1.0)
                if ev is None:
                    if w.stopped:
                        print("watch stream closed", file=sys.stderr)
                        return 1
                    continue
                if ev.type == BOOKMARK:
                    continue  # rv-only progress notify, nothing to print
                if _matches(ev.object):
                    print(f"{ev.type:<9} {ev.object.metadata.key}")
        except KeyboardInterrupt:
            pass
        finally:
            w.stop()
    return 0


def _print_table(resource: str, objs, wide: bool = False) -> None:
    if resource == "pods":
        if wide:
            print(
                f"{'NAMESPACE':<12} {'NAME':<40} {'NODE':<24} {'PHASE':<10} "
                f"{'READY':<6} {'IP':<16} {'RESTARTS'}"
            )
        else:
            print(f"{'NAMESPACE':<12} {'NAME':<40} {'NODE':<24} {'PHASE':<10}")
        for p in objs:
            line = (
                f"{p.metadata.namespace:<12} {p.metadata.name:<40} "
                f"{p.spec.node_name or '<none>':<24} {p.status.phase:<10}"
            )
            if wide:
                from ..api.objects import COND_POD_READY

                ready = next(
                    (
                        c.status
                        for c in p.status.conditions
                        if c.type == COND_POD_READY
                    ),
                    "-",
                )
                restarts = sum(
                    cs.restart_count for cs in p.status.container_statuses
                )
                line += (
                    f" {ready:<6} {p.status.pod_ip or '<none>':<16} {restarts}"
                )
            print(line)
    elif resource == "nodes":
        print(f"{'NAME':<28} {'UNSCHEDULABLE':<14} {'TAINTS':<5} {'CPU':<8}")
        for n in objs:
            print(
                f"{n.metadata.name:<28} {str(n.spec.unschedulable):<14} "
                f"{len(n.spec.taints):<5} "
                f"{n.status.allocatable.get('cpu', '?'):<8}"
            )
    elif resource == "events":
        print(f"{'TYPE':<8} {'REASON':<20} {'OBJECT':<40} {'NOTE'}")
        for e in objs:
            print(f"{e.type:<8} {e.reason:<20} {e.involved_key:<40} {e.note[:60]}")
    elif resource in ("deployments", "replicasets", "statefulsets"):
        print(f"{'NAMESPACE':<12} {'NAME':<32} {'DESIRED':<8} {'READY':<6} {'UPDATED'}")
        for o in objs:
            st = o.status
            print(
                f"{o.metadata.namespace:<12} {o.metadata.name:<32} "
                f"{o.spec.replicas:<8} {getattr(st, 'ready_replicas', 0):<6} "
                f"{getattr(st, 'updated_replicas', '-')}"
            )
    elif resource == "jobs":
        print(f"{'NAMESPACE':<12} {'NAME':<32} {'COMPLETIONS':<12} {'ACTIVE':<7} {'FAILED'}")
        for o in objs:
            want = o.spec.completions if o.spec.completions is not None else 1
            print(
                f"{o.metadata.namespace:<12} {o.metadata.name:<32} "
                f"{o.status.succeeded}/{want:<10} {o.status.active:<7} "
                f"{o.status.failed}"
            )
    elif resource == "services":
        print(f"{'NAMESPACE':<12} {'NAME':<32} {'TYPE':<12} {'CLUSTER-IP':<16} {'PORTS'}")
        for o in objs:
            ports = ",".join(f"{p[1]}/{p[0]}" for p in o.spec.ports) or "<none>"
            print(
                f"{o.metadata.namespace:<12} {o.metadata.name:<32} "
                f"{o.spec.type:<12} {o.spec.cluster_ip or '<none>':<16} {ports}"
            )
    else:
        print("NAME")
        for o in objs:
            print(o.metadata.name)


def cmd_describe(client: RESTClient, args) -> int:
    resource = _resource(args.resource)
    try:
        obj = client.get(resource, args.namespace, args.name)
    except NotFound:
        obj = client.get(resource, "", args.name)
    print(json.dumps(codec.encode(obj), indent=2))
    if resource == "pods":
        events, _ = client.list("events")
        key = obj.metadata.key
        related = [e for e in events if e.involved_key == key]
        if related:
            print("\nEvents:")
            for e in related:
                print(f"  {e.type} {e.reason}: {e.note} (x{e.count})")
    elif resource == "nodes":
        # describe node: allocated-resources summary (kubectl's
        # "Allocated resources" section)
        from ..api.objects import compute_pod_resource_request
        from ..api.resources import cpu_to_millis, parse_quantity

        pods, _ = client.list("pods")
        # terminal pods keep spec.nodeName until GC but hold no resources
        # (kubectl filters them from Allocated resources the same way)
        mine = [
            p
            for p in pods
            if p.spec.node_name == obj.metadata.name
            and p.status.phase not in ("Succeeded", "Failed")
        ]
        reqs = [compute_pod_resource_request(p) for p in mine]
        cpu_m = sum(r.get("cpu", 0) for r in reqs)  # already millicores
        mem_b = sum(r.get("memory", 0) for r in reqs)  # already bytes
        cpu_alloc = cpu_to_millis(obj.status.allocatable.get("cpu", 0)) or 1
        mem_alloc = parse_quantity(obj.status.allocatable.get("memory", 0)) or 1
        print("\nAllocated resources:")
        print(f"  pods:   {len(mine)}")
        print(f"  cpu:    {cpu_m}m ({100 * cpu_m / cpu_alloc:.0f}%)")
        print(f"  memory: {mem_b} ({100 * mem_b / mem_alloc:.0f}%)")
    return 0


def _normalized(resource: str, obj) -> dict:
    """Server-populated fields stripped so a diff shows only user intent
    (kubectl diff's dry-run comparison ignores the same machinery fields)."""
    doc = codec.encode(obj)
    meta = doc.get("metadata", {})
    for f in (
        "resource_version",
        "resourceVersion",
        "uid",
        "generation",
        "creation_timestamp",
        "creationTimestamp",
    ):
        meta.pop(f, None)
    doc.pop("status", None)
    return doc


def _file_or_kustomize_objects(args) -> List[tuple]:
    if getattr(args, "kustomize", None):
        return _kustomize_build(args.kustomize)
    if getattr(args, "filename", None):
        return _load_objects(args.filename)
    raise SystemExit("error: must specify -f FILE or -k DIRECTORY")


def cmd_diff(client: RESTClient, args) -> int:
    """kubectl diff (staging/src/k8s.io/kubectl/pkg/cmd/diff/diff.go):
    unified diff of each file object against its live counterpart; exit 1
    when any object differs (the reference's exit-code contract)."""
    import difflib

    objs = _file_or_kustomize_objects(args)
    changed = 0
    for resource, obj in objs:
        try:
            live = client.get(resource, obj.metadata.namespace, obj.metadata.name)
            live_doc = _normalized(resource, live)
        except NotFound:
            live_doc = None
        want_doc = _normalized(resource, obj)
        if live_doc == want_doc:
            continue
        changed += 1
        a = (
            json.dumps(live_doc, indent=2, sort_keys=True, default=str).splitlines()
            if live_doc is not None
            else []
        )
        b = json.dumps(want_doc, indent=2, sort_keys=True, default=str).splitlines()
        name = f"{resource}/{obj.metadata.namespace}/{obj.metadata.name}"
        for line in difflib.unified_diff(
            a, b, fromfile=f"LIVE {name}", tofile=f"MERGED {name}", lineterm=""
        ):
            print(line)
    return 1 if changed else 0


def _deep_merge(base: dict, patch: dict) -> dict:
    """Strategic-merge-lite: dicts merge recursively, everything else
    (lists included) replaces — the subset kustomize patchesStrategicMerge
    users rely on for spec tweaks."""
    out = dict(base)
    for k, v in patch.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _kustomize_build(directory: str) -> List[tuple]:
    """kustomize-lite (…/cmd/kustomize; sigs.k8s.io/kustomize subset):
    kustomization.{json,yaml} with resources, namePrefix/nameSuffix,
    namespace, commonLabels, patchesStrategicMerge, and images overrides.
    `resources` entries may be files or nested kustomization dirs (bases).
    """
    for fname in ("kustomization.json", "kustomization.yaml", "kustomization.yml"):
        path = os.path.join(directory, fname)
        if os.path.exists(path):
            break
    else:
        raise SystemExit(f"no kustomization file in {directory}")
    with open(path) as f:
        text = f.read()
    try:
        kz = json.loads(text)
    except json.JSONDecodeError:
        try:
            import yaml  # type: ignore

            kz = yaml.safe_load(text)
        except ImportError:
            raise SystemExit("kustomization is not JSON and PyYAML is unavailable")

    docs: List[tuple] = []
    for res in kz.get("resources", []):
        rpath = os.path.join(directory, res)
        if os.path.isdir(rpath):
            docs.extend(_kustomize_build(rpath))  # base overlay
        else:
            docs.extend(_load_objects(rpath))

    patches = []
    for p in kz.get("patchesStrategicMerge", []):
        with open(os.path.join(directory, p)) as f:
            ptext = f.read()
        try:
            patches.append(json.loads(ptext))
        except json.JSONDecodeError:
            import yaml  # type: ignore

            patches.extend(d for d in yaml.safe_load_all(ptext) if d)

    images = {im["name"]: im for im in kz.get("images", [])}
    out: List[tuple] = []
    for resource, obj in docs:
        doc = codec.encode(obj)
        for patch in patches:
            pm = patch.get("metadata", {})
            if pm.get("name") == doc.get("metadata", {}).get("name") and patch.get(
                "kind", doc.get("kind")
            ) == doc.get("kind"):
                doc = _deep_merge(doc, patch)
        meta = doc.setdefault("metadata", {})
        if kz.get("namePrefix") or kz.get("nameSuffix"):
            meta["name"] = (
                kz.get("namePrefix", "") + meta.get("name", "") + kz.get("nameSuffix", "")
            )
        if kz.get("namespace"):
            meta["namespace"] = kz["namespace"]
        for k, v in kz.get("commonLabels", {}).items():
            meta.setdefault("labels", {})[k] = v
            # commonLabels also propagate to selectors + pod templates the
            # way kustomize wires them through workload kinds
            spec = doc.get("spec", {})
            if isinstance(spec.get("selector"), dict):
                sel = spec["selector"]
                tgt = sel.setdefault("match_labels", sel) if "match_labels" in sel else sel
                if isinstance(tgt, dict):
                    tgt[k] = v
            tpl = spec.get("template") if isinstance(spec, dict) else None
            if isinstance(tpl, dict):
                tpl.setdefault("metadata", {}).setdefault("labels", {})[k] = v
        for c in doc.get("spec", {}).get("containers", []) or []:
            base, sep, suffix = _split_image_ref(c.get("image", ""))
            im = images.get(base)
            if im:
                new_base = im.get("newName", base)
                if im.get("newTag"):
                    c["image"] = f"{new_base}:{im['newTag']}"
                elif im.get("digest"):
                    c["image"] = f"{new_base}@{im['digest']}"
                else:
                    c["image"] = new_base + sep + suffix
        out.append(codec.decode_any(doc))
    return out


def _split_image_ref(ref: str):
    """(name, sep, tag_or_digest) for an image reference — the tag ':' is
    only a separator AFTER the last '/', so registry ports
    (localhost:5000/app) survive, and '@sha256:…' digests split on '@'
    (kustomize image transformer semantics)."""
    if "@" in ref:
        name, _, digest = ref.partition("@")
        return name, "@", digest
    slash = ref.rfind("/")
    colon = ref.rfind(":")
    if colon > slash:
        return ref[:colon], ":", ref[colon + 1:]
    return ref, "", ""


def cmd_kustomize(client: RESTClient, args) -> int:
    rendered = [codec.encode(obj) for _res, obj in _kustomize_build(args.directory)]
    print(json.dumps(rendered, indent=2, default=str))
    return 0


def cmd_apply(client: RESTClient, args) -> int:
    for resource, obj in _file_or_kustomize_objects(args):
        try:
            client.create(resource, obj)
            print(f"{resource}/{obj.metadata.name} created")
        except Exception:
            cur = client.get(
                resource, obj.metadata.namespace, obj.metadata.name
            )
            obj.metadata.resource_version = cur.metadata.resource_version
            obj.metadata.uid = cur.metadata.uid
            client.update(resource, obj)
            print(f"{resource}/{obj.metadata.name} configured")
    return 0


def cmd_create(client: RESTClient, args) -> int:
    for resource, obj in _load_objects(args.filename):
        client.create(resource, obj)
        print(f"{resource}/{obj.metadata.name} created")
    return 0


def cmd_delete(client: RESTClient, args) -> int:
    resource = _resource(args.resource)
    try:
        client.delete(resource, args.namespace, args.name)
    except NotFound:
        client.delete(resource, "", args.name)
    print(f"{resource}/{args.name} deleted")
    return 0


def _update_node(client: RESTClient, name: str, mutate) -> None:
    """Nodes are cluster-scoped, but ObjectMeta defaults their store key
    under "default" — try both (shared by cordon/uncordon/taint/drain)."""
    try:
        client.guaranteed_update("nodes", "", name, mutate)
    except NotFound:
        client.guaranteed_update("nodes", "default", name, mutate)


def cmd_logs(client: RESTClient, args) -> int:
    """kubectl logs: GET pods/{name}/log (kubectl/pkg/cmd/logs; served by
    the apiserver's log subresource routing to the pod's kubelet)."""
    sub = f"{args.name}/log"
    if args.tail is not None:
        sub += f"?tailLines={args.tail}"
    try:
        sys.stdout.write(client.get_text("pods", args.namespace, sub))
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


def cmd_exec(client: RESTClient, args) -> int:
    """kubectl exec: POST pods/{name}/exec (ExecSync through the pod's
    kubelet; kubectl/pkg/cmd/exec)."""
    try:
        sys.stdout.write(
            client.post_text(
                "pods",
                args.namespace,
                f"{args.name}/exec",
                {"command": args.command},
            )
        )
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


def cmd_cordon(client: RESTClient, args, unschedulable=True) -> int:
    def mutate(n):
        n.spec.unschedulable = unschedulable
        return n

    _update_node(client, args.name, mutate)
    print(f"node/{args.name} {'cordoned' if unschedulable else 'uncordoned'}")
    return 0


def cmd_taint(client: RESTClient, args) -> int:
    # kubectl taint nodes NAME key=value:Effect (suffix '-' removes)
    from ..api.objects import Taint

    spec = args.taint
    remove = spec.endswith("-")
    spec = spec.rstrip("-")
    kv, _, effect = spec.partition(":")
    key, _, value = kv.partition("=")

    def mutate(n):
        n.spec.taints = [t for t in n.spec.taints if t.key != key]
        if not remove:
            n.spec.taints.append(Taint(key, value, effect))
        return n

    _update_node(client, args.name, mutate)
    print(f"node/{args.name} {'untainted' if remove else 'tainted'}")
    return 0


def cmd_top(client: RESTClient, args) -> int:
    """kubectl top nodes|pods (metrics.k8s.io, kubectl/pkg/cmd/top)."""
    what = _resource(args.resource)
    if what == "nodes":
        data = client.get_raw("/apis/metrics.k8s.io/v1beta1/nodes")
        print(f"{'NAME':32} {'CPU(cores)':>12} {'MEMORY(bytes)':>16}")
        for it in data.get("items", []):
            print(
                f"{it['metadata']['name']:32} {it['usage']['cpu']:>12} "
                f"{it['usage']['memory']:>16}"
            )
        return 0
    data = client.get_raw(
        f"/apis/metrics.k8s.io/v1beta1/namespaces/{args.namespace}/pods"
    )
    print(f"{'NAME':40} {'CPU(cores)':>12} {'MEMORY(bytes)':>16}")
    for it in data.get("items", []):
        print(
            f"{it['metadata']['name']:40} {it['usage']['cpu']:>12} "
            f"{it['usage']['memory']:>16}"
        )
    return 0


SCALABLE = {"deployments", "replicasets", "statefulsets", "jobs"}


def cmd_scale(client: RESTClient, args) -> int:
    """kubectl scale <resource> <name> --replicas=N (cmd/scale)."""
    resource = _resource(args.resource)
    if resource not in SCALABLE:
        print(f"error: {resource} is not scalable", file=sys.stderr)
        return 1
    obj = client.get(resource, args.namespace, args.name)
    if resource == "jobs":
        obj.spec.parallelism = args.replicas
    else:
        obj.spec.replicas = args.replicas
    client.update(resource, obj)
    print(f"{resource}/{args.name} scaled")
    return 0


def cmd_rollout_status(client: RESTClient, args) -> int:
    """kubectl rollout status deployment/<name> (cmd/rollout): poll until
    updated == desired and available == desired."""
    import time as _time

    kind, _, name = args.target.partition("/")
    resource = _resource(kind)
    if resource != "deployments":
        print("error: rollout status supports deployments", file=sys.stderr)
        return 1
    deadline = _time.time() + args.timeout
    while _time.time() < deadline:
        d = client.get(resource, args.namespace, name)
        want = d.spec.replicas
        if (
            d.status.updated_replicas >= want
            and d.status.available_replicas >= want
            and d.status.replicas == want
        ):
            print(f'deployment "{name}" successfully rolled out')
            return 0
        _time.sleep(0.2)
    print(f'error: deployment "{name}" rollout timed out', file=sys.stderr)
    return 1


def _kv_edits(pairs: List[str]) -> tuple:
    """kubectl's key=val / key- syntax → (sets dict, removes list)."""
    sets, removes = {}, []
    for p in pairs:
        if p.endswith("-") and "=" not in p:
            removes.append(p[:-1])
        elif "=" in p:
            k, _, val = p.partition("=")
            sets[k] = val
        else:
            raise SystemExit(f"invalid key=value pair: {p!r}")
    return sets, removes


def cmd_label(client: RESTClient, args, field: str = "labels") -> int:
    """kubectl label/annotate <resource> <name> k=v ... k- (cmd/label,
    cmd/annotate)."""
    resource = _resource(args.resource)
    sets, removes = _kv_edits(args.pairs)
    clobbered: List[str] = []

    def mutate(obj):
        target = getattr(obj.metadata, field)
        if not args.overwrite:
            clobbered[:] = [
                k for k in sets if k in target and target[k] != sets[k]
            ]
            if clobbered:
                return None
        for k in removes:
            target.pop(k, None)
        target.update(sets)
        return obj

    _update_with_retry(client, resource, mutate, args.namespace, args.name)
    if clobbered:
        print(
            f"error: {clobbered[0]} already has a value; --overwrite to replace",
            file=sys.stderr,
        )
        return 1
    print(f"{resource}/{args.name} {'labeled' if field == 'labels' else 'annotated'}")
    return 0


def _merge_patch(obj, patch: dict) -> None:
    """RFC 7386 merge-patch onto a decoded object (strategic-merge-lite:
    dicts merge recursively, null deletes, everything else replaces).
    Unknown fields are an error, as for a strategic merge on typed
    objects — silently dropping them would report success for a typo."""
    for key, val in patch.items():
        snake = codec._snake(key)
        if not hasattr(obj, snake):
            raise SystemExit(
                f"error: unknown field {key!r} in patch for {type(obj).__name__}"
            )
        cur = getattr(obj, snake)
        if isinstance(val, dict) and hasattr(cur, "__dataclass_fields__"):
            _merge_patch(cur, val)
        elif isinstance(val, dict) and isinstance(cur, dict):
            for k, v in val.items():
                if v is None:
                    cur.pop(k, None)
                else:
                    cur[k] = v
        else:
            import typing as _t

            hints = _t.get_type_hints(type(obj))
            setattr(obj, snake, codec.from_dict(hints[snake], val))


def cmd_patch(client: RESTClient, args) -> int:
    """kubectl patch <resource> <name> -p '<json>' (cmd/patch)."""
    resource = _resource(args.resource)
    try:
        patch = json.loads(args.patch)
    except json.JSONDecodeError as e:
        print(f"error: invalid patch JSON: {e}", file=sys.stderr)
        return 1
    def mutate(obj):
        _merge_patch(obj, patch)
        return obj

    _update_with_retry(client, resource, mutate, args.namespace, args.name)
    print(f"{resource}/{args.name} patched")
    return 0


def _deployment_rses(client: RESTClient, ns: str, name: str):
    """The deployment's owned ReplicaSets, oldest first."""
    rses, _ = client.list("replicasets", namespace=ns)
    owned = [
        rs
        for rs in rses
        if any(
            r.kind == "Deployment" and r.name == name and r.controller
            for r in rs.metadata.owner_references
        )
    ]
    owned.sort(key=lambda rs: rs.metadata.creation_timestamp)
    return owned


def cmd_rollout_history(client: RESTClient, args) -> int:
    kind, _, name = args.target.partition("/")
    if _resource(kind) != "deployments":
        print("error: rollout supports deployments", file=sys.stderr)
        return 1
    print("REVISION  REPLICASET  TEMPLATE-HASH  REPLICAS")
    for i, rs in enumerate(_deployment_rses(client, args.namespace, name), 1):
        h = rs.metadata.labels.get("pod-template-hash", "")
        print(f"{i:<9} {rs.metadata.name:<11} {h:<14} {rs.spec.replicas}")
    return 0


def cmd_rollout_restart(client: RESTClient, args) -> int:
    """Bump the restartedAt template annotation: a new template hash rolls
    every pod through the ordinary rolling-update machinery."""
    import time as _time

    kind, _, name = args.target.partition("/")
    if _resource(kind) != "deployments":
        print("error: rollout supports deployments", file=sys.stderr)
        return 1
    def mutate(d):
        d.spec.template.metadata.annotations[
            "kubectl.kubernetes.io/restartedAt"
        ] = str(_time.time())
        return d

    _update_with_retry(client, "deployments", mutate, args.namespace, name)
    print(f'deployment.apps/{name} restarted')
    return 0


def cmd_rollout_undo(client: RESTClient, args) -> int:
    """Roll the deployment template back to the previous ReplicaSet's
    (cmd/rollout undo)."""
    import copy as _copy

    kind, _, name = args.target.partition("/")
    if _resource(kind) != "deployments":
        print("error: rollout supports deployments", file=sys.stderr)
        return 1
    d = client.get("deployments", args.namespace, name)
    from ..controller.deployment import template_hash

    cur_hash = template_hash(d.spec.template)
    history = [
        rs
        for rs in _deployment_rses(client, args.namespace, name)
        if rs.metadata.labels.get("pod-template-hash") != cur_hash
    ]
    if not history:
        print("error: no rollout history found", file=sys.stderr)
        return 1
    prev = history[-1]  # newest non-current revision

    def mutate(dep):
        tmpl = _copy.deepcopy(prev.spec.template)
        tmpl.metadata.labels.pop("pod-template-hash", None)
        dep.spec.template = tmpl
        return dep

    _update_with_retry(client, "deployments", mutate, args.namespace, name)
    print(f"deployment.apps/{name} rolled back")
    return 0


def cmd_expose(client: RESTClient, args) -> int:
    """kubectl expose deployment/<name> --port N (cmd/expose): create a
    Service selecting the workload's pods."""
    from ..api import objects as v1

    kind, _, name = args.target.partition("/")
    resource = _resource(kind)
    if resource not in ("deployments", "replicasets", "replicationcontrollers"):
        print(f"error: cannot expose {resource}", file=sys.stderr)
        return 1
    obj = client.get(resource, args.namespace, name)
    selector = dict(obj.spec.selector)
    selector.pop("pod-template-hash", None)
    svc = v1.Service(
        metadata=v1.ObjectMeta(name=args.name or name, namespace=args.namespace),
        spec=v1.ServiceSpec(
            selector=selector, ports=[(args.protocol, args.port)]
        ),
    )
    client.create("services", svc)
    print(f"service/{svc.metadata.name} exposed")
    return 0


def cmd_wait(client: RESTClient, args) -> int:
    """kubectl wait <resource> <name> --for=delete|condition=X[=V]
    (cmd/wait)."""
    import time as _time

    resource = _resource(args.resource)
    spec = args.wait_for
    if spec != "delete" and not spec.startswith("condition="):
        print(
            f"error: unsupported --for {spec!r} (use delete or "
            "condition=<Type>[=<Value>])",
            file=sys.stderr,
        )
        return 1
    deadline = _time.time() + args.timeout
    while _time.time() < deadline:
        try:
            obj = client.get(resource, args.namespace, args.name)
        except NotFound:
            if spec == "delete":
                print(f"{resource}/{args.name} condition met")
                return 0
            _time.sleep(0.2)
            continue
        if spec != "delete" and spec.startswith("condition="):
            _, _, cond = spec.partition("=")
            cond, _, want = cond.partition("=")
            want = want or "True"
            conds = getattr(obj.status, "conditions", [])
            if any(c.type == cond and c.status == want for c in conds):
                print(f"{resource}/{args.name} condition met")
                return 0
        _time.sleep(0.2)
    print(f"error: timed out waiting for {spec}", file=sys.stderr)
    return 1


def cmd_explain(client: RESTClient, args) -> int:
    """kubectl explain <resource>[.field...]: field names + types from the
    dataclass model (the build's OpenAPI stand-in)."""
    import dataclasses as _dc
    import typing as _t

    path = args.resource.split(".")
    resource = _resource(path[0])
    cls = codec.RESOURCE_KINDS.get(resource)
    if cls is None:
        print(f"error: unknown resource {path[0]}", file=sys.stderr)
        return 1
    for seg in path[1:]:
        hints = _t.get_type_hints(cls)
        if seg not in hints:
            print(f"error: field {seg!r} not found in {cls.__name__}", file=sys.stderr)
            return 1
        nxt = hints[seg]
        origin = _t.get_origin(nxt)
        if origin in (list, tuple, dict):
            nxt = (_t.get_args(nxt) or (object,))[-1]
        if _t.get_origin(nxt) is _t.Union:
            nxt = next(a for a in _t.get_args(nxt) if a is not type(None))
        cls = nxt
    print(f"KIND: {cls.__name__ if hasattr(cls, '__name__') else cls}")
    if _dc.is_dataclass(cls):
        print("FIELDS:")
        hints = _t.get_type_hints(cls)
        for f in _dc.fields(cls):
            tp = hints[f.name]
            tname = getattr(tp, "__name__", None) or str(tp).replace("typing.", "")
            print(f"  {f.name:<28} <{tname}>")
    return 0


def cmd_certificate(client: RESTClient, args) -> int:
    """kubectl certificate approve|deny <name> (cmd/certificates): sets the
    condition the signer/cleaner controllers act on."""
    from ..api import objects as v1

    cond = "Approved" if args.subverb == "approve" else "Denied"

    def mutate(csr):
        if any(c.type == cond and c.status == "True" for c in csr.status.conditions):
            return None
        csr.status.conditions.append(
            v1.PodCondition(type=cond, status="True", reason="KubectlCertificate")
        )
        return csr

    _update_with_retry(
        client, "certificatesigningrequests", mutate, "", args.name
    )
    past = {"approve": "approved", "deny": "denied"}[args.subverb]
    print(f"certificatesigningrequest.certificates.k8s.io/{args.name} {past}")
    return 0


def cmd_api_resources(client: RESTClient, args) -> int:
    """kubectl api-resources: the served resource catalogue."""
    print(f"{'NAME':<36} {'KIND'}")
    for res, cls in sorted(codec.RESOURCE_KINDS.items()):
        print(f"{res:<36} {cls.__name__}")
    return 0


def cmd_drain(client: RESTClient, args) -> int:
    """kubectl drain: cordon, then EVICT every non-daemon pod off the node
    through the PDB-respecting eviction subresource, retrying 429s until
    --timeout (kubectl/pkg/drain)."""
    import time as _time
    import urllib.error

    def mutate(n):
        n.spec.unschedulable = True
        return n

    _update_node(client, args.name, mutate)
    print(f"node/{args.name} cordoned")
    deadline = _time.time() + args.timeout
    while True:
        pods, _ = client.list("pods")
        victims = [
            p
            for p in pods
            if p.spec.node_name == args.name
            and p.metadata.deletion_timestamp is None
            and not any(
                r.controller and r.kind == "DaemonSet"
                for r in p.metadata.owner_references
            )
        ]
        if not victims:
            print(f"node/{args.name} drained")
            return 0
        blocked = 0
        for p in victims:
            try:
                client._request(
                    "POST",
                    client.base
                    + f"/api/v1/namespaces/{p.metadata.namespace}/pods/"
                    + f"{p.metadata.name}/eviction",
                    {"kind": "Eviction"},
                )
                print(f"pod/{p.metadata.name} evicted")
            except NotFound:
                continue  # vanished between list and eviction: already gone
            except urllib.error.HTTPError as e:
                if e.code == 429:
                    blocked += 1  # PDB: retry after the controller catches up
                else:
                    raise
        # deadline + pacing apply to EVERY round — a workload recreating
        # pods as fast as they evict must hit the timeout, not spin forever
        if _time.time() > deadline:
            remaining = blocked or len(victims)
            print(
                f"error: {remaining} pods still on the node "
                f"({blocked} blocked by disruption budgets)",
                file=sys.stderr,
            )
            return 1
        _time.sleep(0.5 if blocked else 0.05)


def cmd_auth_can_i(client: RESTClient, args) -> int:
    """kubectl auth can-i VERB RESOURCE (SelfSubjectAccessReview)."""
    out = client._request(
        "POST",
        client.base + "/api/v1/selfsubjectaccessreviews",
        {
            "kind": "SelfSubjectAccessReview",
            "spec": {
                "resourceAttributes": {
                    "verb": args.can_verb,
                    "resource": _resource(args.can_resource),
                    "namespace": args.namespace,
                }
            },
        },
    )
    allowed = bool(out.get("status", {}).get("allowed"))
    print("yes" if allowed else "no")
    return 0 if allowed else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="kubectl-tpu")
    parser.add_argument(
        "--server",
        default=os.environ.get("KUBECTL_TPU_SERVER", "http://127.0.0.1:18080"),
    )
    parser.add_argument(
        "--token",
        default=os.environ.get("KUBECTL_TPU_TOKEN", ""),
        help="bearer token for secured clusters",
    )
    parser.add_argument("-n", "--namespace", default="default")
    parser.add_argument("-o", "--output", default="table", choices=["table", "json", "wide"])
    sub = parser.add_subparsers(dest="verb", required=True)

    p_get = sub.add_parser("get")
    p_get.add_argument("resource")
    p_get.add_argument("name", nargs="?")
    p_get.add_argument("-l", "--selector", default="")
    p_get.add_argument("-A", "--all-namespaces", action="store_true")
    p_get.add_argument("-w", "--watch", action="store_true")
    p_desc = sub.add_parser("describe")
    p_desc.add_argument("resource")
    p_desc.add_argument("name")
    p_apply = sub.add_parser("apply")
    p_apply.add_argument("-f", "--filename")
    p_apply.add_argument("-k", "--kustomize")
    p_diff = sub.add_parser("diff")
    p_diff.add_argument("-f", "--filename")
    p_diff.add_argument("-k", "--kustomize")
    p_kust = sub.add_parser("kustomize")
    p_kust.add_argument("directory")
    p_logs = sub.add_parser("logs")
    p_logs.add_argument("name")
    p_logs.add_argument("--tail", type=int, default=None)
    p_exec = sub.add_parser("exec")
    p_exec.add_argument("name")
    p_exec.add_argument("command", nargs="+")
    p_create = sub.add_parser("create")
    p_create.add_argument("-f", "--filename", required=True)
    p_del = sub.add_parser("delete")
    p_del.add_argument("resource")
    p_del.add_argument("name")
    p_cord = sub.add_parser("cordon")
    p_cord.add_argument("name")
    p_uncord = sub.add_parser("uncordon")
    p_uncord.add_argument("name")
    p_taint = sub.add_parser("taint")
    p_taint.add_argument("nodes")  # literal "nodes"
    p_taint.add_argument("name")
    p_taint.add_argument("taint")
    p_top = sub.add_parser("top")
    p_top.add_argument("resource")  # nodes | pods
    p_scale = sub.add_parser("scale")
    p_scale.add_argument("resource")
    p_scale.add_argument("name")
    p_scale.add_argument("--replicas", type=int, required=True)
    p_roll = sub.add_parser("rollout")
    p_roll.add_argument("action")  # status | history | restart | undo
    p_roll.add_argument("target")  # deployment/<name>
    p_roll.add_argument("--timeout", type=float, default=60.0)
    p_label = sub.add_parser("label")
    p_label.add_argument("resource")
    p_label.add_argument("name")
    p_label.add_argument("pairs", nargs="+")  # k=v or k-
    p_label.add_argument("--overwrite", action="store_true")
    p_ann = sub.add_parser("annotate")
    p_ann.add_argument("resource")
    p_ann.add_argument("name")
    p_ann.add_argument("pairs", nargs="+")
    p_ann.add_argument("--overwrite", action="store_true")
    p_patch = sub.add_parser("patch")
    p_patch.add_argument("resource")
    p_patch.add_argument("name")
    p_patch.add_argument("-p", "--patch", required=True)
    p_expose = sub.add_parser("expose")
    p_expose.add_argument("target")  # deployment/<name>
    p_expose.add_argument("--port", type=int, required=True)
    p_expose.add_argument("--protocol", default="TCP")
    p_expose.add_argument("--name", default="")
    p_wait = sub.add_parser("wait")
    p_wait.add_argument("resource")
    p_wait.add_argument("name")
    p_wait.add_argument("--for", dest="wait_for", required=True)
    p_wait.add_argument("--timeout", type=float, default=30.0)
    p_explain = sub.add_parser("explain")
    p_explain.add_argument("resource")  # resource[.field.path]
    p_cert = sub.add_parser("certificate")
    p_cert.add_argument("subverb", choices=["approve", "deny"])
    p_cert.add_argument("name")
    sub.add_parser("api-resources")
    p_drain = sub.add_parser("drain")
    p_drain.add_argument("name")
    p_drain.add_argument("--timeout", type=float, default=60.0)
    p_can = sub.add_parser("auth")
    p_can.add_argument("subverb")  # can-i
    p_can.add_argument("can_verb")
    p_can.add_argument("can_resource")

    args = parser.parse_args(argv)
    if args.token:
        from ..apiserver.client import AuthRESTClient

        client = AuthRESTClient(args.server, token=args.token)
    else:
        client = RESTClient(args.server)
    try:
        if args.verb == "get":
            return cmd_get(client, args)
        if args.verb == "describe":
            return cmd_describe(client, args)
        if args.verb == "diff":
            return cmd_diff(client, args)
        if args.verb == "kustomize":
            return cmd_kustomize(client, args)
        if args.verb == "logs":
            return cmd_logs(client, args)
        if args.verb == "exec":
            return cmd_exec(client, args)
        if args.verb == "apply":
            return cmd_apply(client, args)
        if args.verb == "create":
            return cmd_create(client, args)
        if args.verb == "delete":
            return cmd_delete(client, args)
        if args.verb == "cordon":
            return cmd_cordon(client, args, True)
        if args.verb == "uncordon":
            return cmd_cordon(client, args, False)
        if args.verb == "taint":
            return cmd_taint(client, args)
        if args.verb == "top":
            return cmd_top(client, args)
        if args.verb == "scale":
            return cmd_scale(client, args)
        if args.verb == "rollout":
            if args.action == "status":
                return cmd_rollout_status(client, args)
            if args.action == "history":
                return cmd_rollout_history(client, args)
            if args.action == "restart":
                return cmd_rollout_restart(client, args)
            if args.action == "undo":
                return cmd_rollout_undo(client, args)
            print(
                "error: rollout supports status|history|restart|undo",
                file=sys.stderr,
            )
            return 1
        if args.verb == "label":
            return cmd_label(client, args, "labels")
        if args.verb == "annotate":
            return cmd_label(client, args, "annotations")
        if args.verb == "patch":
            return cmd_patch(client, args)
        if args.verb == "expose":
            return cmd_expose(client, args)
        if args.verb == "wait":
            return cmd_wait(client, args)
        if args.verb == "explain":
            return cmd_explain(client, args)
        if args.verb == "certificate":
            return cmd_certificate(client, args)
        if args.verb == "api-resources":
            return cmd_api_resources(client, args)
        if args.verb == "drain":
            return cmd_drain(client, args)
        if args.verb == "auth":
            if args.subverb != "can-i":
                print("error: only 'auth can-i' is supported", file=sys.stderr)
                return 1
            return cmd_auth_can_i(client, args)
    except NotFound as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
