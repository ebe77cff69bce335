"""MODIS granule download CLI (reference download_modis_images.py rebuilt).

    python -m sifsr_tpu_torch.cli.download --username U --password P \
        --start_date 2017-01-01 --stop_date 2020-01-01 --n_threads 6

Downloads MOD11A1/MOD21A1D (LST), MOD09GQ (NIR/Red), MOD09GA (RGB) and
MOD44W (water) granules for one tile over a date range, chunking the range
across a thread pool (the reference uses pymp fork-parallelism with per-day
partitioning, download_modis_images.py:90-99; a ThreadPoolExecutor gives the
same partitioning without fork semantics). Per-chunk failures are logged and
skipped like the reference's try/except-continue (:95-102).

Requires the ``pymodis`` package and NASA Earthdata credentials; both are
unavailable in offline CI, so the dependency is imported lazily and the CLI
exits with a clear message when missing.

Port of ``sifsr_tpu/cli/download.py``, whole: ``date_chunks``, ``fetch_plan``
and ``--dry-run`` need neither pymodis nor a network.
"""

from __future__ import annotations

import datetime as dt
from argparse import ArgumentParser
from concurrent.futures import ThreadPoolExecutor

# reference short_names list (download_modis_images.py:125-133); MOD11A1 and
# MOD21A1D are both LST products — the processing pipeline consumes MOD21A1D
# by default, MOD11A1 via cli.process_modis --product MOD11A1
PRODUCTS = (
    "MOD11A1.061",
    "MOD09GQ.061",
    "MOD21A1D.061",
    "MOD09GA.061",
    "MOD44W.061",
)


def date_chunks(start: str, stop: str, n: int) -> list[tuple[str, str]]:
    """Split [start, stop] into at most n contiguous date chunks (reference
    utils.date_into_n_chunk, utils.py:38-49, including the n_threads >= n_days
    clamp of download_modis_images.py:84-85)."""
    d0 = dt.date.fromisoformat(start)
    d1 = dt.date.fromisoformat(stop)
    if d1 < d0:
        raise ValueError(f"stop date {stop} is before start date {start}")
    days = [(d0 + dt.timedelta(days=i)).isoformat() for i in range((d1 - d0).days + 1)]
    n = min(n, len(days))
    size = -(-len(days) // n)
    return [(days[i * size], days[min((i + 1) * size, len(days)) - 1])
            for i in range(n) if i * size < len(days)]


def fetch_plan(products, start: str, stop: str, n_threads: int, dest: str,
               tile: str) -> list[dict]:
    """The would-be download jobs: one entry per (product, date-chunk).

    Matches the reference's nesting (product outer loop
    download_modis_images.py:136-139, chunk parallel loop :90-99). ``today``
    is the chunk's later date and ``enddate`` the earlier one — pymodis
    walks backwards in time (the reference passes them reversed and relies
    on pymodis tolerating it; we pass them in pymodis's documented order)."""
    import os

    return [
        {
            "product": product,
            "tile": tile,
            "today": chunk[1],
            "enddate": chunk[0],
            "dest": os.path.join(dest, product),
        }
        for product in products
        for chunk in date_chunks(start, stop, n_threads)
    ]


def main(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--username", default=None)
    parser.add_argument("--password", default=None)
    parser.add_argument("--start_date", required=True)
    parser.add_argument("--stop_date", required=True)
    parser.add_argument("--tile", default="h18v04")
    parser.add_argument("--n_threads", type=int, default=4)
    parser.add_argument("--dest", default="./data/hdf_files")
    parser.add_argument("--products", nargs="*", default=list(PRODUCTS))
    parser.add_argument("--dry-run", action="store_true",
                        help="print the would-be fetch plan and exit (no "
                             "network, no pymodis needed)")
    args = parser.parse_args(argv)

    try:
        plan = fetch_plan(args.products, args.start_date, args.stop_date,
                          args.n_threads, args.dest, args.tile)
    except ValueError as exc:
        parser.error(str(exc))
    if args.dry_run:
        for job in plan:
            print(f"{job['product']}  tile={job['tile']}  "
                  f"{job['enddate']} -> {job['today']}  dest={job['dest']}")
        print(f"dry-run: {len(plan)} download jobs "
              f"({len(args.products)} products x "
              f"{len(plan) // max(1, len(args.products))} date chunks)")
        return

    if not args.username or not args.password:
        parser.error("--username and --password are required to download "
                     "(use --dry-run to preview the fetch plan without them)")
    try:
        from pymodis import downmodis
    except ImportError:
        parser.error(
            "pymodis is not installed in this environment; install it (and have "
            "network access + Earthdata credentials) to download MODIS granules"
        )

    import os

    def fetch(job: dict) -> None:
        os.makedirs(job["dest"], exist_ok=True)
        try:
            dm = downmodis.downModis(
                destinationFolder=job["dest"],
                user=args.username,
                password=args.password,
                product=job["product"],
                tiles=job["tile"],
                today=job["today"],
                enddate=job["enddate"],
            )
            dm.connect()
            dm.downloadsAllDay()
        except Exception as exc:  # mirror the reference's log-and-continue
            print(f"{job['product']} {job['enddate']}->{job['today']}: "
                  f"download failed: {exc}")

    with ThreadPoolExecutor(max_workers=args.n_threads) as pool:
        for job in plan:
            pool.submit(fetch, job)
    print("done")


if __name__ == "__main__":
    main()
