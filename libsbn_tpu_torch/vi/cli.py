"""The ``vip-torch`` command line interface (reference: vip/cli.py; the
counterpart of libsbn_tpu.vi.cli, whose command is ``vip``), argparse-based.
The Burrito computes on the card; ``--device cpu`` names the CPU."""

from __future__ import annotations

import argparse
import pprint


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="vip-torch",
                                     description="libsbn_tpu_torch VBPI CLI")
    sub = parser.add_subparsers(dest="command", required=True)
    bench = sub.add_parser("benchmark", help="Fit to a fixed-topology MCMC run.")
    bench.add_argument(
        "--branch-model", choices=["split", "psp"], default="split"
    )
    bench.add_argument(
        "--scalar-model",
        choices=["lognormal", "tf_lognormal", "tf_gamma",
                 "tf_truncated_lognormal"],
        default="lognormal"
    )
    bench.add_argument("--optimizer", choices=["simple", "bump"], default="simple")
    bench.add_argument("--step-count", type=int, default=5)
    bench.add_argument("--particle-count", type=int, default=10)
    bench.add_argument("--thread-count", type=int, default=1)
    bench.add_argument("--device", default="cuda")
    bench.add_argument("data_path")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.command == "benchmark":
        from . import benchmark

        run_details, opt_trace, _ = benchmark.fixed(
            args.data_path,
            branch_model_name=args.branch_model,
            scalar_model_name=args.scalar_model,
            optimizer_name=args.optimizer,
            step_count=args.step_count,
            particle_count=args.particle_count,
            thread_count=args.thread_count,
            device=args.device,
        )
        pprint.pprint(run_details)
        return 0
    return 1


# Reference-exact entry-point name (vip/cli.py registers `vip = vip.cli:cli`;
# this package registers `vip-torch`).
cli = main


def benchmark(data_path, **kwargs):
    """Programmatic form of the `vip benchmark` command (vip/cli.py:53-94
    exposes one as a click command); forwards to vi.benchmark.fixed with
    the reference command's option defaults."""
    from . import benchmark as _benchmark

    kwargs.setdefault("branch_model_name", "split")
    kwargs.setdefault("scalar_model_name", "lognormal")
    kwargs.setdefault("optimizer_name", "simple")
    kwargs.setdefault("step_count", 5)
    kwargs.setdefault("particle_count", 10)
    return _benchmark.fixed(data_path, **kwargs)


if __name__ == "__main__":
    raise SystemExit(main())
