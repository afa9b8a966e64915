"""CLI for the offline graph compiler (reorder + recompress).

    PYTHONPATH=src python -m repro_torch.launch.compile_graph \
        --in graph.cbin --out graph_bfs.lgsr --codec logcsr

Reads any registered codec, applies the locality permutation
:func:`repro_torch.core.policy.choose_reorder` selects (``--strategy``
overrides), re-encodes through the chosen codec and writes the inverse
permutation sidecar next to the output (``--sidecar`` overrides).  The
compile self-verifies before returning: sampled vertices must answer
byte-identically through the inverse permutation, or the output files
are removed and the run fails.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core.codec import registered_codecs
from repro_torch.core.policy import REORDER_STRATEGIES
from repro_torch.graph.reorder import compile_graph


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Reorder + re-encode an on-disk graph")
    ap.add_argument("--in", dest="in_path", required=True,
                    help="input graph (any registered codec)")
    ap.add_argument("--out", dest="out_path", required=True,
                    help="compiled graph output path")
    ap.add_argument("--codec", default="compbin",
                    choices=sorted(registered_codecs()),
                    help="output codec (default: compbin)")
    ap.add_argument("--strategy", default=None,
                    choices=list(REORDER_STRATEGIES),
                    help="vertex ordering (default: policy.choose_reorder)")
    ap.add_argument("--sidecar", default=None,
                    help="inverse-permutation sidecar path "
                         "(default: <out>.perm)")
    ap.add_argument("--verify-samples", type=int, default=64,
                    help="vertices sampled for the byte-identity check")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    report = compile_graph(
        args.in_path, args.out_path, codec=args.codec,
        strategy=args.strategy, sidecar=args.sidecar,
        verify_samples=args.verify_samples, seed=args.seed)
    print(json.dumps(report.as_dict(), indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
