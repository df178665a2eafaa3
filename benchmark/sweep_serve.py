#!/usr/bin/env python3
"""Find the serving cell's knee once, on the card: one server set up as the
cell sets it up, then the cell's open loop at each rate of `--rates` for
`--seconds` seconds, printing one JSON line per rate (p50, p95, failed,
the generator's lateness, and whether the backlog grew) and the knee: the
highest rate whose p95 meets the cell's SLO with no growing backlog.

    python3 benchmark/sweep_serve.py --workload v2_r50_serve --rates 10,20,40,60 --seconds 12

The cell's `rate_rps` is then set by hand to 0.8 of the knee.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def grew(rec: list, lat: list) -> bool:
    """The last third of the window's requests waited more than twice as
    long as the first third, by their medians, and 20 ms or more."""
    n = len(lat)
    if n < 9 or any(math.isinf(x) for x in lat):
        return n >= 9
    first, last = statistics.median(lat[: n // 3]), statistics.median(lat[-(n // 3):])
    return last > 2.0 * first and last - first >= 20.0


def main(argv=None) -> int:
    import torch

    from benchmark import harness
    from benchmark.drivers import serve as drv

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="v2_r50_serve")
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--seed", type=int, default=5_000_000_001)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the sweep needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    tr = {**cell.traffic, "max_seconds": args.seconds}
    device = torch.device("cuda")
    server, _, _ = drv.serve_setup(cell, args.seed, device)
    knee = None
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            out = drv.window(server, args.seed, tr, rate, args.seconds, device)
            rec, lat = drv.latencies(out, tr, args.seconds)
            late = sorted(r["late"] for r in rec)
            row = {"rate_rps": rate, "requests": len(rec),
                   "images_per_s": sum(out["requests"][r["i"]][3] for r in rec) / args.seconds,
                   "p50_ms": drv.percentile(lat, 50), "p95_ms": drv.percentile(lat, 95),
                   "failed": sum(r["status"] != 200 for r in rec),
                   "late_p95_s": drv.percentile(late, 95), "backlog_grew": grew(rec, lat)}
            ok = row["p95_ms"] <= tr["slo_ms"] and not row["backlog_grew"] and not row["failed"]
            row["meets_slo"] = ok
            print(json.dumps(row), flush=True)
            if ok:
                knee = rate
    finally:
        server.close()
    print(json.dumps({"knee_rps": knee, "cell_rate_rps": None if knee is None else 0.8 * knee}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
