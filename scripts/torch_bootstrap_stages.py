#!/usr/bin/env python3
"""The native bootstrap's stages, decrypted and held against a float model,
at tpu_n16's chain (42 + 14 primes, h = 192, radix 8, K 25, degree 40) and a
ring degree of choice:

    python3 scripts/torch_bootstrap_stages.py [logn] [input_bits ...] [--device cpu]

(defaults: logn 16, inputs 2^40 and 2^28 at nl = 2; on the card unless
--device cpu; logn 16 needs the card: its ~400 keys take 35 GB). For each
input: ModRaise's overflow I (from the raised ciphertext's exact plaintext,
three primes CRT-lifted), the EvalMod inputs t1 against (I + m/q0') / K in
bit-reversed order, EvalMod's output against m/q0', then SlotToCoeff level
by level against the float product of the dft_factor levels with m/q0'
(relative RMS), and the output against the input values and the decrypted
input; each with the reference's arithmetic (the nominal working scale 2^60,
every StC level landing on the output's scale) and with the port's from
bootstrap_native.WIDE_SLOTS slots (the working scale EvalMod returns
to, the StC levels before the last on it, the input raised to q0' *
2^-WIDE_GAP_BITS). One JSON line each; then
the card's name and power limit.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from dacapo_tpu_torch.crypto.bootstrap_native import (  # noqa: E402
    WIDE_GAP_BITS, CtVal, NativeBootstrapper, native_config)
from dacapo_tpu_torch.crypto.dft_factor import _brv_perm, build_levels  # noqa: E402
from dacapo_tpu_torch.crypto.params import PROFILES  # noqa: E402
from dacapo_tpu_torch.crypto.scheme import Ciphertext, Scheme  # noqa: E402

SEED = 5
INPUT_SEED = 3


def exact_plain(s, data, nrows=3):
    """c0 + c1 * s of `data` over its first nrows primes, CRT-lifted to
    centered Python integers (object array [N])."""
    planes = s.decrypt_planes(Ciphertext(data[:, :nrows, :], 1.0)).astype(object)
    qs = [int(q) for q in s.ctx.q_primes[:nrows]]
    big = 1
    for q in qs:
        big *= q
    x = np.zeros(planes.shape[1], dtype=object)
    for i, q in enumerate(qs):
        rest = big // q
        x = (x + planes[i] * rest * pow(rest, -1, q)) % big
    return np.where(x > big // 2, x - big, x)


def levels_apply(diags, z):
    """A dft_factor level in float: (M z)_j = sum_d diags[d][j] z[j + d]."""
    out = np.zeros(len(z), complex)
    for d, v in diags.items():
        out += np.asarray(v) * np.roll(z, -d)
    return out


def rel(got, want):
    return float(np.sqrt(np.mean(np.abs(got - want) ** 2)) / np.sqrt(np.mean(np.abs(want) ** 2)))


def stages(s, bs, input_bits, port, port_scale):
    """One bootstrap of uniform(-1, 1) at scale 2^input_bits, nl = 2, to the
    highest level, stage by stage as NativeBootstrapper._bootstrap runs it,
    each stage decrypted; `port`: the port's arithmetic from
    WIDE_SLOTS slots (the working scale EvalMod returns to, the StC levels
    before the last on it, GAP WIDE_GAP_BITS), else the reference's (the nominal 2^60,
    every StC level on the output's scale).
    EvalMod's outputs are held to m/q0' by their real parts; their
    imaginary parts, which StC's first level mixes in (StC(v_re + i v_im)),
    are reported apart."""
    ctx, ev = s.ctx, s.ev
    half = ctx.n // 2
    bs.delta_bs = port_scale if port else float(2.0 ** (bs.rs * ctx.config.prime_bits))
    bs.GAP_BITS = WIDE_GAP_BITS if port else NativeBootstrapper.GAP_BITS
    for t in bs._levels():          # the planes of the other arithmetic
        t._pt_cache.clear()
    bs._cts_last_cache.clear()
    bs._enc_cache.clear()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    vals = np.random.default_rng(INPUT_SEED).uniform(-1, 1, half)
    ct = s.encrypt(vals, scale=2.0 ** input_bits, nl=2)
    q0p = int(ctx.q_primes[0]) * int(ctx.q_primes[1])
    up = max(0, int(round(np.log2(q0p) - bs.GAP_BITS - input_bits)))
    delta = ct.scale * 2.0 ** up
    raised = bs.mod_raise_pair(ev.upscale(ct.data[:, :2, :], 2, up), 2)
    plain = exact_plain(s, raised)
    overflow = np.array([int(round(float(x) / q0p)) for x in plain])
    mu = np.array([float(int(x) - int(i) * q0p) for x, i in zip(plain, overflow)]) / q0p
    brv = _brv_perm(half.bit_length() - 1)

    def dec(v):
        return s.encoder.decode(s.decrypt_planes(Ciphertext(v.data, v.scale)), v.scale,
                                complex_out=True)

    cts, stc_first, stc_rest = bs._transforms()
    u = CtVal(bs, raised, delta)
    for t in cts:
        u = t.apply(u, bs.delta_bs)
    last = bs._cts_last(delta / (float(q0p) * bs.cfg.K))
    u1, u2 = last[0].apply(u, bs.delta_bs), last[1].apply(u, bs.delta_bs)
    t_re, t_im = u1.add(u1.conj()), u2.add(u2.conj())
    t_model = (overflow + mu) / bs.cfg.K
    t_err = max(float(np.abs(dec(t_re).real - t_model[:half][brv]).max()),
                float(np.abs(dec(t_im).real - t_model[half:][brv]).max()))
    v_re, v_im = bs._evalmod(t_re), bs._evalmod(t_im)
    vr, vi = dec(v_re), dec(v_im)
    v_dec = vr + 1j * vi                    # what StC's first level computes on
    v_model = (mu[:half] + 1j * mu[half:])[brv]
    out = dict(logn=ctx.n.bit_length() - 1, input_bits=input_bits,
               arithmetic="port" if port else "reference",
               working_scale_bits=float(np.log2(bs.delta_bs)),
               evalmod_out_scale_bits=float(np.log2(v_re.scale)),
               overflow_max=int(np.abs(overflow).max()),
               message_rms=float(np.sqrt(np.mean(mu ** 2))),
               t1_max_err=t_err, t1_imag_max=max(float(np.abs(dec(t_re).imag).max()),
                                                 float(np.abs(dec(t_im).imag).max())),
               evalmod_rel_err=rel(vr.real + 1j * vi.real, v_model),
               evalmod_imag_rel=float(np.sqrt(np.mean(vr.imag ** 2 + vi.imag ** 2))
                                      / np.sqrt(np.mean(np.abs(v_model) ** 2))), stc=[])
    target0 = ct.scale * float(q0p) / delta
    targets = [target0] * (1 + len(stc_rest))
    if port:
        targets[:-1] = [bs.delta_bs] * (len(targets) - 1)
    model_levels = build_levels(ctx.n, bs.cfg.radix, inverse=False)
    o = stc_first[0].apply(v_re, targets[0]).add(stc_first[1].apply(v_im, targets[0]))
    model, alone = levels_apply(model_levels[0], v_model), levels_apply(model_levels[0], v_dec)
    out["stc"].append(dict(scale_bits=float(np.log2(o.scale)), rel_err=rel(dec(o), model),
                           rel_err_alone=rel(dec(o), alone)))
    for t, target, diags in zip(stc_rest, targets[1:], model_levels[1:]):
        prev = dec(o)
        o = t.apply(o, target)
        model = levels_apply(diags, model)
        out["stc"].append(dict(scale_bits=float(np.log2(o.scale)), rel_err=rel(dec(o), model),
                               rel_err_alone=rel(dec(o), levels_apply(diags, prev))))
    got = s.decrypt(Ciphertext(o.data, ct.scale))
    din = s.decrypt(ct)
    out.update(rms=float(np.sqrt(np.mean((got - vals) ** 2))),
               rms_against_decrypted_input=float(np.sqrt(np.mean((got - din) ** 2))),
               input_rms=float(np.sqrt(np.mean((din - vals) ** 2))))
    return out


def main(argv):
    device = "cpu" if "--device" in argv and argv[argv.index("--device") + 1] == "cpu" \
        else "cuda"
    args = [a for a in argv[1:] if a not in ("--device", "cpu", "cuda")]
    if device == "cuda" and not torch.cuda.is_available():
        print("torch_bootstrap_stages: no CUDA device", file=sys.stderr)
        return 2
    logn = int(args[0]) if args else 16
    inputs = [int(a) for a in args[1:]] or [40, 28]
    cfg = dataclasses.replace(PROFILES["tpu_n16"], n=1 << logn)
    t0 = time.perf_counter()
    s = Scheme("tpu_n16", config=cfg, seed=SEED, device=device)
    s.generate_keys()
    bs = s.enable_native_bootstrap(native_config(PROFILES["tpu_n16"]))
    s.ensure_galois(bs.rotation_steps())
    q = [float(x) for x in s.ctx.q_primes]
    spans = [np.log2(q[i] * q[i + 1]) for i in range(0, len(q) - 1, 2)]
    print(json.dumps(dict(part="setup", logn=logn, device=device, config=bs.cfg.__dict__,
                          pair_span_bits=[float(min(spans)), float(max(spans))],
                          working_scale_bits=float(np.log2(bs.delta_bs)),
                          port_arithmetic=bs.wide,
                          seconds=time.perf_counter() - t0)), flush=True)
    port_scale = bs.delta_bs
    for bits in inputs:
        for port in (False, True):
            print(json.dumps(dict(part="stages", **stages(s, bs, bits, port, port_scale))),
                  flush=True)
    if device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
