"""Command-line driver of the port: the `hecate-opt` / `hc-trace` / `hc-test`
equivalents, plus keygen and the op profiler (port of dacapo_tpu/cli.py).

    python -m dacapo_tpu_torch.cli trace <Bench> [--nt 16384] [--dir traced]
    python -m dacapo_tpu_torch.cli opt --pipeline dacapo --waterline 40 \\
        traced/<Bench>.eir.json -o optimized/dacapo/<Bench>.40
    python -m dacapo_tpu_torch.cli test <Bench> <pipeline> <waterline> [profile] \
        [--nt 16384] [--device cpu] [--keys-in-memory]
    python -m dacapo_tpu_torch.cli keygen [profile] [--dir DIR]
    python -m dacapo_tpu_torch.cli profile [profile] [-o PATH] [--iters 10]

<Bench> names a module of dacapo_tpu_torch/examples/{benchmarks,tests}.
`test`, `keygen` and `profile` run on the card unless given --device cpu.
`test --nt` packs the benchmark's input into that many slots (the trace's
`--nt`; the example's own default when absent): a profile with 2^14 slots,
tpu_n15b, needs `--nt 16384`. `test --keys-in-memory` keeps the keys the
full VM makes in memory and writes none (SqueezeNet on tpu_n15b makes
57.7 GB of them).
`keygen` writes the runner's keyset fingerprint into params.json, so a full
HEVM reuses the keyset and a server HEVM accepts it; its default directory
is the runner's, ~/.hevm/torch/<profile>. `opt` hands the ELASM options to
the planner (the JAX package's CLI parses them and drops them).
"""

import argparse
import importlib
import json
import os
import shutil
import sys
import time


def _cmd_trace(args):
    """Trace a benchmark to <dir>/<Bench>.eir.json + .cst (hc-trace)."""
    mod = importlib.import_module(f"dacapo_tpu_torch.examples.benchmarks.{args.bench}")
    print(mod.trace(dirs=args.dir, cst_dirs=args.dir, nt=args.nt))


def _cmd_opt(args):
    """Compile Earth IR -> scale-managed IR + .hevm bytecode (hecate-opt)."""
    from .ir.config import load_profile
    from .ir.serialize import load_function, save_function
    from .passes.pipeline import compile_function

    cfg = load_profile(args.ckks_config)
    fn = load_function(args.input)
    t0 = time.time()
    opts = {}
    if args.pipeline == "elasm":
        opts = dict(parallel=args.parallel_elasm, num_iter=args.num_iter_elasm,
                    beta=args.beta_elasm, gamma=args.gamma_elasm)
    if args.enable_check_smu:
        opts["check_smu"] = True
    prog = compile_function(fn, args.pipeline, args.waterline, args.output_val,
                            config=cfg, out_prefix=args.output, **opts)
    if args.output:
        save_function(fn, f"{args.output}.eir.json")
        if args.enable_debug_printer:
            with open(f"{args.output}.earth.mlir", "w") as f:
                f.write(fn.dump())
    print(f"compiled {fn.name}: {len(prog.ops)} ops, "
          f"init_level={prog.init_level}, {time.time() - t0:.2f}s")


def _cmd_test(args):
    """Run an optimized benchmark under the HE VM against its golden (hc-test)."""
    mod = importlib.import_module(f"dacapo_tpu_torch.examples.tests.{args.bench}")
    kw = {} if args.nt is None else dict(nt=args.nt)
    mod.run(args.pipeline, args.waterline, profile=args.profile, device=args.device,
            save_keys=not args.keys_in_memory, **kw)


def _cmd_profile(args):
    """Measure per-op latency tables on the device and write a
    profiled_<card>_<profile>.json that load_profile reads."""
    from .runtime.profiler import profile_backend
    print(profile_backend(args.profile, out_path=args.output, iters=args.iters,
                          bootstrap=args.bootstrap, device=args.device))


def _cmd_keygen(args):
    """Generate a full keyset (no rotation keys: a full HEVM's load adds the
    program's) and persist it with the runner's fingerprint."""
    from .crypto import keys as keymod
    from .crypto.scheme import Scheme
    from .runtime.runner import keyset_fingerprint
    s = Scheme(args.profile, device=args.device)
    s.generate_keys()
    d = args.dir or os.path.expanduser(f"~/.hevm/torch/{args.profile}")
    if os.path.isdir(d):
        shutil.rmtree(d)   # a regenerated keyset must not mix with the old one
    keymod.save_keyset(s.keys, d)
    with open(os.path.join(d, "params.json"), "w") as f:
        json.dump({"primes": keyset_fingerprint(s)}, f)
    print(d)


def main(argv=None):
    p = argparse.ArgumentParser(prog="dacapo-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("trace", help="trace a benchmark (hc-trace)")
    t.add_argument("bench")
    t.add_argument("--nt", type=int, default=2 ** 14)
    t.add_argument("--dir", default="traced")
    t.set_defaults(fn=_cmd_trace)

    o = sub.add_parser("opt", help="compile Earth IR (hecate-opt)")
    o.add_argument("input")
    o.add_argument("-o", "--output")
    o.add_argument("--pipeline", default="dacapo",
                   choices=["eva", "pars", "snr", "elasm", "dacapo"])
    o.add_argument("--waterline", type=int, default=40)
    o.add_argument("--output-val", type=int, default=0)
    o.add_argument("--ckks-config", default="profiled_TPU_n14")
    o.add_argument("--enable-debug-printer", action="store_true")
    o.add_argument("--enable-check-smu", action="store_true")
    o.add_argument("--parallel-elasm", type=int, default=20)
    o.add_argument("--num-iter-elasm", type=int, default=1000)
    o.add_argument("--beta-elasm", type=float, default=40.0)
    o.add_argument("--gamma-elasm", type=float, default=10.0)
    o.set_defaults(fn=_cmd_opt)

    s = sub.add_parser("test", help="run an optimized benchmark (hc-test)")
    s.add_argument("bench")
    s.add_argument("pipeline")
    s.add_argument("waterline", type=int)
    s.add_argument("profile", nargs="?", default=None)
    s.add_argument("--nt", type=int, default=None,
                   help="slots the input is packed into (default: the example's)")
    s.add_argument("--device", default=None, help="cuda (the default) or cpu")
    s.add_argument("--keys-in-memory", action="store_true",
                   help="write none of the keys the full VM makes")
    s.set_defaults(fn=_cmd_test)

    pr = sub.add_parser("profile", help="measure per-op latency tables")
    pr.add_argument("profile", nargs="?", default="tpu_n15")
    pr.add_argument("-o", "--output")
    pr.add_argument("--iters", type=int, default=10)
    pr.add_argument("--bootstrap", action="store_true",
                    help="time the native bootstrap (native-bootstrap profiles)")
    pr.add_argument("--device", default=None, help="cuda (the default) or cpu")
    pr.set_defaults(fn=_cmd_profile)

    k = sub.add_parser("keygen", help="generate and persist a keyset")
    k.add_argument("profile", nargs="?", default="tpu_n15")
    k.add_argument("--dir")
    k.add_argument("--device", default=None, help="cuda (the default) or cpu")
    k.set_defaults(fn=_cmd_keygen)

    args = p.parse_args(argv)
    args.fn(args)


# console-script entry points matching the reference's config.sh aliases
def main_trace(argv=None):
    main(["trace"] + (argv if argv is not None else sys.argv[1:]))


def main_opt(argv=None):
    main(["opt"] + (argv if argv is not None else sys.argv[1:]))


def main_test(argv=None):
    main(["test"] + (argv if argv is not None else sys.argv[1:]))


if __name__ == "__main__":
    main()
