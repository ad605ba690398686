"""Edge-analytics demo on the PyTorch port (the paper's deployment story,
§1):

an IoT gateway keeps only the GreedyGD-compressed stream + a PairwiseHist
synopsis; dashboards query the synopsis at sub-ms latency; new sensor
batches append incrementally; the synopsis serializes to a few kB for
shipping to other edge nodes (storage codec round-trip).

    PYTHONPATH=src python examples/torch_aqp_edge_demo.py            # card
    PYTHONPATH=src python examples/torch_aqp_edge_demo.py --device cpu

The port's counterpart of ``examples/aqp_edge_demo.py``; synopses are
built on the CUDA device unless ``--device cpu``.
"""
import argparse

from repro_torch.aqp import AQPFramework, ExactEngine
from repro_torch.aqp.datasets import load
from repro_torch.core import storage
from repro_torch.core.query import QueryEngine
from repro_torch.core.types import BuildParams


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host (default: the CUDA "
                         "device)")
    args = ap.parse_args(argv)

    table = load("iot_temp", n=300_000)
    fw = AQPFramework(BuildParams(n_samples=60_000),
                      device=args.device).ingest(table)
    rep = fw.storage_report()
    print(f"edge node storage: raw {rep['raw_data_bytes']/1e6:.1f} MB -> "
          f"compressed {rep['compressed_data_bytes']/1e6:.1f} MB + "
          f"synopsis {rep['synopsis']['total']/1e3:.1f} kB "
          f"(total {rep['total_storage_reduction']:.2f}x smaller)")

    exact = ExactEngine(table)
    for sql in ("SELECT AVG(temp) FROM t WHERE device = 'dev3'",
                "SELECT MAX(humidity) FROM t WHERE temp > 24",
                "SELECT COUNT(*) FROM t WHERE battery < 50 AND temp > 22"):
        res = fw.query(sql)
        truth = exact.query(sql)
        print(f"{sql}\n  ~ {res.estimate:.2f} [{res.lower:.2f},"
              f" {res.upper:.2f}] exact {truth:.2f} "
              f"[{res.latency_s*1e3:.2f} ms]")

    # Ship the synopsis to another node: serialize -> deserialize -> query.
    blob = storage.encode(fw.synopsis)
    print(f"\nserialized synopsis: {len(blob)/1e3:.1f} kB")
    remote = QueryEngine(storage.decode(blob))
    res = remote.query("SELECT AVG(temp) FROM t WHERE device = 'dev3'")
    print(f"remote node answers: {res.estimate:.2f}")

    # Incremental ingestion: a new sensor batch arrives.
    batch = load("iot_temp", n=50_000, seed=99)
    fw.append_rows(batch)
    try:
        fw.query("SELECT AVG(temp) FROM t")
    except RuntimeError as exc:
        print(f"\nafter append: {exc}")
    fw.rebuild(table)
    res = fw.query("SELECT AVG(temp) FROM t")
    print(f"rebuilt synopsis answers: {res.estimate:.2f}")


if __name__ == "__main__":
    main()
