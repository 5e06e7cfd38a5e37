"""Embedding extraction from an AIGER file.

Counterpart of ``examples/feature_extract.py``: the circuit through
``AigParser`` (binary or ASCII AIGER, decoded in Python) into
``Model(modality="aig")``; prints the shapes of hs and hf.

    python -m mgvae_tpu_torch.examples.feature_extract [path.aig] [--device cpu]

Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

from ..api import Model
from ..data.aiger import AigParser


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", default="./tmp/test.aig")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    model = Model(modality="aig", device=args.device)
    graph = AigParser().read_aiger(args.path)
    hs, hf = model(graph)
    print(hs.shape, hf.shape)
    return hs, hf


if __name__ == "__main__":
    main()
