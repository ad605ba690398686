"""Quickstart on the PyTorch port: build a PairwiseHist synopsis and run
approximate SQL.

    PYTHONPATH=src python examples/torch_quickstart.py               # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The port's counterpart of ``examples/quickstart.py``. The synopsis is
built on the CUDA device (its pair rounds launch the 2-D and sub-bin
histogram kernels) unless ``--device cpu`` builds it on the host through
the kernels' plain versions.
"""
import argparse

from repro_torch.aqp import AQPFramework, ExactEngine
from repro_torch.aqp.datasets import load
from repro_torch.core.types import BuildParams


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host (default: the CUDA "
                         "device)")
    args = ap.parse_args(argv)

    # 1. A flights-like table (mixed numeric/categorical, missing values).
    table = load("flights", n=200_000)
    print(f"table: {len(table)} columns x {len(table['distance'])} rows")

    # 2. Ingest: GD pre-processing -> GreedyGD compression -> PairwiseHist.
    fw = AQPFramework(BuildParams(n_samples=100_000),
                      device=args.device).ingest(table)
    rep = fw.storage_report()
    print(f"synopsis: {rep['synopsis']['total']/1e3:.1f} kB | "
          f"compressed data: {rep['compressed_data_bytes']/1e6:.1f} MB "
          f"(raw {rep['raw_data_bytes']/1e6:.1f} MB, "
          f"{rep['compression_ratio']:.2f}x)")
    print(f"build: {fw.timings['build_synopsis_s']:.1f}s\n")

    # 3. Approximate SQL with bounds — vs exact ground truth.
    exact = ExactEngine(table)
    queries = [
        "SELECT COUNT(*) FROM flights WHERE dep_delay > 30",
        "SELECT AVG(arr_delay) FROM flights WHERE distance > 1000 "
        "AND airline = 'AA'",
        "SELECT SUM(air_time) FROM flights WHERE origin = 'A001' "
        "OR dest = 'A001'",
        "SELECT MEDIAN(distance) FROM flights WHERE air_time > 120",
        "SELECT MAX(dep_delay) FROM flights WHERE month = 7",
        "SELECT AVG(dep_delay) FROM flights WHERE cancelled = 0 "
        "GROUP BY airline",
    ]
    for sql in queries:
        res = fw.query(sql)
        if res.groups is not None:
            print(f"{sql}")
            truth = exact.query(sql)
            for key in list(res.groups)[:4]:
                est, lo, hi = res.groups[key]
                print(f"   {key:4s}: {est:10.2f}  in [{lo:.2f}, {hi:.2f}] "
                      f"(exact {truth.get(key, float('nan')):.2f})")
            continue
        truth = exact.query(sql)
        err = abs(res.estimate - truth) / max(abs(truth), 1e-9) * 100
        print(f"{sql}\n   ~ {res.estimate:12.2f} in [{res.lower:.2f}, "
              f"{res.upper:.2f}]  exact {truth:12.2f}  err {err:5.2f}%  "
              f"[{res.latency_s*1e3:.2f} ms]")


if __name__ == "__main__":
    main()
