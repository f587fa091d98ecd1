"""Command-line interface of the port (``tpufcn/cli.py``), so far its
``gates`` and ``pretrain`` subcommands, with the JAX package's flags.
Each prints one JSON line; progress goes to stderr.

    python -m torchfcn.cli gates --family fcn32s
    python -m torchfcn.cli pretrain --out vgg16.caffemodel --steps 1500

Both run on the card (``--device cuda``, the default) or, slowly, on the
CPU (``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import sys


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _cmd_gates(args):
    from torchfcn.train.gates import (
        bench_gate_configs, run_bench_gates, warm_gate_caches)

    known = sorted(bench_gate_configs(args.tier))
    fams = args.family or known
    unknown = sorted(set(fams) - set(known))
    if unknown:
        raise SystemExit(f"unknown families {unknown}; have {known}")
    if args.warm_caches:
        out = warm_gate_caches(root=args.root, only=fams, log=_log,
                               tier=args.tier, device=args.device)
    else:
        out = run_bench_gates(root=args.root, only=fams, log=_log,
                              tier=args.tier, device=args.device)
    print(json.dumps(out))


def _cmd_pretrain(args):
    """The backbone pretrain (the reference's fine-tune seed, reproduced
    without a download): a ``.caffemodel`` that the gates load by name."""
    from torchfcn.train.pretrain import pretrain_vgg16
    res = pretrain_vgg16(args.out, classes=args.classes, steps=args.steps,
                         lr=args.lr, seed=args.seed, log=_log,
                         device=args.device)
    print(json.dumps(res))


def main(argv=None):
    from torchfcn.train.gates import DEFAULT_ROOT

    p = argparse.ArgumentParser(prog="torchfcn")
    sub = p.add_subparsers(dest="cmd", required=True)

    ga = sub.add_parser(
        "gates",
        help="run the tracked accuracy gates: per-family trained mAP/mIoU "
             "on the hard synthetic benchmark, exact and e5m2 serving; "
             "trains each family")
    ga.add_argument("--family", nargs="*", default=None,
                    help="subset: googlenet googlenet_3cls vgg_pyramid "
                         "vgg16_pretrain fcn8s fcn32s (default: all)")
    ga.add_argument("--root", default=DEFAULT_ROOT,
                    help="work and cache directory of the hard benchmark")
    ga.add_argument("--warm-caches", action="store_true",
                    help="render the sources, compose the held-out sets "
                         "and run the pretrain, without the gates")
    ga.add_argument("--tier", choices=("bench", "full"), default="bench",
                    help="'bench': the capture tier; 'full': the batch-16, "
                         "6k-step calibration tier")
    ga.add_argument("--device", default="cuda")
    ga.set_defaults(fn=_cmd_gates)

    pt = sub.add_parser(
        "pretrain",
        help="pretrain the VGG16 backbone as a classifier of hard-benchmark "
             "crops and export a .caffemodel fine-tune seed")
    pt.add_argument("--out", default="vgg16.caffemodel")
    pt.add_argument("--classes", type=int, default=4)
    pt.add_argument("--steps", type=int, default=1500)
    pt.add_argument("--lr", type=float, default=3e-4)
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--device", default="cuda")
    pt.set_defaults(fn=_cmd_pretrain)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
