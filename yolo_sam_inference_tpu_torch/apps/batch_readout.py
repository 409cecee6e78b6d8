"""Batch CSV readout CLI (reference ``tools/{local_,}mib_batch_readout.py``).

The JAX package's ``apps/batch_readout.py`` on the port's readout (no
pandas): the same arguments, output line and exit codes.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Concatenate per-batch CSVs into combined_output.csv"
    )
    p.add_argument("--root", type=Path, default=None,
                   help="local directory containing batch_*/batch_data.csv")
    p.add_argument("--pattern", type=str, default="batch_*/batch_data.csv")
    p.add_argument("--output", type=Path, default=None)
    p.add_argument("--minio-bucket", type=str, default=None,
                   help="read from a MinIO bucket instead (requires minio)")
    p.add_argument("--minio-prefix", type=str, default="")
    p.add_argument("--workers", type=int, default=10)
    args = p.parse_args(argv)

    from ..registry.readout import combine_local_batches, combine_minio_batches

    if args.minio_bucket:
        rows = combine_minio_batches(
            bucket=args.minio_bucket, prefix=args.minio_prefix, num_workers=args.workers
        )
    else:
        if args.root is None or not args.root.is_dir():
            print("error: --root directory required (or use --minio-bucket)")
            return 2
        rows = combine_local_batches(
            args.root, pattern=args.pattern, output=args.output, num_workers=args.workers
        )
    print(f"combined {len(rows)} rows")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
