"""Manifest management CLI: create / add / list / summary / pending.

The JAX package's ``apps/manifest_cli.py`` on the port's registry: the same
arguments, subcommands, output lines and exit codes.

Capability parity with the reference's ingestion manager subcommands
(reference ``tools/postgres_data_create.py:843-953``), against the sqlite
manifest by default or Postgres with ``--postgres`` (requires psycopg2).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def _manifest(args):
    if args.postgres:
        from ..registry.postgres import PostgresManifest

        return PostgresManifest(table=args.table, template=args.template)
    from ..registry.manifest import WorkManifest

    return WorkManifest(args.db, table=args.table, template=args.template)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Work manifest management")
    p.add_argument("--db", type=Path, default=Path("manifest.db"),
                   help="sqlite manifest path (ignored with --postgres)")
    p.add_argument("--table", type=str, default="images")
    p.add_argument("--template", type=str, default="standard",
                   choices=("standard", "experiment", "time_series"))
    p.add_argument("--postgres", action="store_true",
                   help="use the Postgres backend (env POSTGRES_*)")
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("create", help="create the table")
    p_add = sub.add_parser("add", help="ingest image paths")
    p_add.add_argument("--source-dir", type=Path, default=None,
                       help="ingest all images under this directory")
    p_add.add_argument("--paths-file", type=Path, default=None,
                       help="file with one path per line")
    p_list = sub.add_parser("list", help="list rows")
    p_list.add_argument("--limit", type=int, default=20)
    sub.add_parser("summary", help="completion statistics")
    sub.add_parser("pending", help="list unprocessed paths")

    args = p.parse_args(argv)
    m = _manifest(args)

    if args.cmd == "create":
        print(f"table {args.table!r} ready ({args.template})")
    elif args.cmd == "add":
        paths = []
        if args.source_dir:
            from ..io.images import list_image_files

            paths += [str(x) for x in list_image_files(args.source_dir, recursive=True)]
        if args.paths_file:
            paths += [l.strip() for l in args.paths_file.read_text().splitlines() if l.strip()]
        if not paths:
            print("error: nothing to add (use --source-dir or --paths-file)")
            return 2
        n = m.ingest(paths)
        print(f"ingested {n} paths")
    elif args.cmd == "list":
        for row in m.list_rows(limit=args.limit):
            print(json.dumps(row))
    elif args.cmd == "summary":
        print(json.dumps(m.summary(), indent=2))
    elif args.cmd == "pending":
        for path in m.pending():
            print(path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
