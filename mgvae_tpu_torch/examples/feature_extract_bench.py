"""Embedding extraction from a .bench netlist, timed.

Counterpart of ``examples/feature_extract_bench.py``: ``BenchParser``, then
one encode of the circuit by ``Model()`` (XAG, the reference package's
default modality), its wall time from the parsed graph to hs and hf on the
host. ``--pretrained PATH`` loads ``Model.load_pretrained(PATH)`` first
(any of the port's checkpoint formats); the repository ships no weights.

    python -m mgvae_tpu_torch.examples.feature_extract_bench [path.bench]
           [--device cpu] [--pretrained PATH]
"""
from __future__ import annotations

import argparse
import time

from ..api import Model
from ..data.bench import BenchParser


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", default="./tmp/test.bench")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pretrained", default="")
    args = ap.parse_args(argv)
    print("[INFO] Create DeepGate model (xag default)")
    model = Model(device=args.device)
    if args.pretrained:
        model.load_pretrained(args.pretrained)

    print("[INFO] Parse Bench:", args.path)
    graph = BenchParser().read_bench(args.path)

    print("[INFO] Get embeddings ...")
    start = time.perf_counter()
    hs, hf = model(graph)
    hs, hf = hs.cpu(), hf.cpu()     # on the host: the encode has ended
    elapsed = time.perf_counter() - start
    # hs: structural embeddings, hf: functional embeddings, [N, D]
    print(hs.shape, hf.shape)
    print("Time: ", elapsed)
    return hs, hf, elapsed


if __name__ == "__main__":
    main()
