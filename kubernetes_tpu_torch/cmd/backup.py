"""ktpu-backup: fenced backup / disaster-restore operator tool.

Reference shape: `etcdctl snapshot save` / `etcdutl snapshot restore` —
backup is online and consistent, restore mints a NEW cluster epoch (our
analogue of etcd's new-cluster-id + member bump is the lease-transition
bump plus the replication term bump, see runtime/backup.py).

    ktpu-backup save    --wal /var/lib/ktpu/store --out backup.json
    ktpu-backup save    --url http://primary:18080 --out backup.json
    ktpu-backup restore --backup backup.json --wal /var/lib/ktpu/restored
    ktpu-backup inspect --backup backup.json
"""

from __future__ import annotations

import argparse
import json
import logging
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ktpu-backup")
    parser.add_argument("-v", "--verbosity", type=int, default=1)
    sub = parser.add_subparsers(dest="cmd", required=True)

    save = sub.add_parser("save", help="write a consistent backup image")
    save.add_argument("--out", required=True, help="backup file to write")
    src = save.add_mutually_exclusive_group(required=True)
    src.add_argument("--wal", default="", help="WAL base path (offline)")
    src.add_argument("--url", default="", help="live apiserver URL (online)")

    restore = sub.add_parser(
        "restore", help="materialize a backup as a fresh fenced WAL"
    )
    restore.add_argument("--backup", required=True)
    restore.add_argument("--wal", required=True, help="WAL base path to create")
    restore.add_argument(
        "--force", action="store_true",
        help="overwrite an existing non-empty WAL at the target",
    )

    inspect = sub.add_parser("inspect", help="print a backup image summary")
    inspect.add_argument("--backup", required=True)

    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbosity >= 4 else logging.INFO
    )
    from ..runtime import backup as bk

    if args.cmd == "save":
        if args.wal:
            image = bk.backup_from_wal(args.wal, args.out)
        else:
            # online: snapshot a LIVE server through its REST surface
            from ..apiserver.client import RESTClient

            image = RESTClient(args.url).backup_state()
            bk.write_backup(image, args.out)
        print(
            f"saved {args.out}: rv={image['rv']} commit={image['commit']} "
            f"term={image['term']} kinds={len(image['objects'])}"
        )
        if image.get("source_corrupt"):
            print(
                "WARNING: source WAL was mid-log corrupt; image holds the "
                "longest valid prefix and may be missing acked writes",
                file=sys.stderr,
            )
            return 3
        return 0

    if args.cmd == "restore":
        image = bk.load_backup(args.backup)
        summary = bk.restore_into(image, args.wal, force=args.force)
        print(
            f"restored {args.wal}: rv={summary['rv']} "
            f"term={summary['term']} objects={summary['objects']} "
            f"fenced_leases={summary['fenced_leases']}"
        )
        return 0

    image = bk.load_backup(args.backup)
    out = {k: v for k, v in image.items() if k != "objects"}
    out["kinds"] = {k: len(v) for k, v in image["objects"].items()}
    print(json.dumps(out, indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
