"""The port's device oracle (crypto/bootstrap.py, the counterpart of the JAX
package's `_oracle_fn`) on the CPU at test_n11c, held against the JAX
package on keys made from the same seed: the host path's cooling plan and
lifted plaintext m2 bit for bit (the JAX side computes m2 as its host-RNG
path does); the device path's m2 against the exact lift of the decrypted
message (Python integers), which is the JAX package's m2 wherever the JAX
oracle does not cool, and which loses none of the bits the cooling loses;
the refreshed ciphertext on decrypted values (its randomness comes from a
torch.Generator, the JAX package's from jax.random); the noise draws by
their distribution; and the general CRT lift against Python integers. The
CUDA graph of each cache key is held on the card
(tests/test_torch_oracle_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dacapo_tpu.crypto import bootstrap as ref_bs
from dacapo_tpu.crypto import crt_lift as ref_crt
from dacapo_tpu.crypto.modmath import add_mod as ref_add_mod, mul_mod as ref_mul_mod
from dacapo_tpu.crypto.scheme import Scheme as RefScheme
from dacapo_tpu_torch.crypto import bootstrap as bs
from dacapo_tpu_torch.crypto import crt_lift as crt
from dacapo_tpu_torch.crypto.modmath import add_mod, mul_mod
from dacapo_tpu_torch.crypto.scheme import Scheme, Ciphertext

PROFILE = "test_n11c"
HOT = 2.0 ** 60            # the planner's bootstrap input scale (2^rf)
# (input rows, scale, target level): hot (the reference cools one row; the
# device path lifts from 3), cool (both lift from the pair), and hotter (the
# reference cools two rows, K above 2^31; the device path lifts from 4)
CASES = [(6, HOT, 5), (4, 2.0 ** 40, 3), (16, 2.0 ** 80, 3)]
BASE_ROWS = {6: 3, 4: 2, 16: 4}


def U(t):
    return t.numpy().view(np.uint32)


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


@pytest.fixture(scope="module")
def pair():
    ref = RefScheme(PROFILE)
    ref.generate_keys()
    port = Scheme(PROFILE, device="cpu")
    port.generate_keys()
    np.testing.assert_array_equal(U(port.keys.s_ntt), np.asarray(ref.keys.s_ntt))
    np.testing.assert_array_equal(U(port.keys.pk), np.asarray(ref.keys.pk))
    return ref, port


def _input(ref, nl, scale, seed=11):
    """A JAX-encrypted ciphertext of uniform(-1, 1) slots at (nl, scale):
    (values, JAX data, the same bits as a port tensor)."""
    vals = np.random.default_rng(seed).uniform(-1, 1, ref.ctx.config.n_slots)
    data = np.asarray(ref.encrypt(vals, scale=scale, nl=nl).data)
    return vals, data, T(data)


def _ref_m2(ref, data, nl, scale, target):
    """m2 as the JAX package's host-RNG path computes it
    (dacapo_tpu/crypto/bootstrap.py:173-194)."""
    ctx = ref.ctx
    nl2 = (target + 1) * ctx.config.rescale_rows
    limit = np.log2(float(ctx.q_primes[0]) * float(ctx.q_primes[1])) - 1
    data, nl, _, K = ref_bs._cool_input(ref, data, nl, scale, limit)
    nb = 2 if nl >= 2 else 1
    rows = list(range(nb))
    qq = ref.ev._mm_consts(rows)
    m_ntt = ref_add_mod(data[0, :nb], ref_mul_mod(data[1, :nb], ref.keys.s_ntt[:nb], *qq),
                        qq[0])
    c = ref.ev.intt(m_ntt, rows)
    if nb == 2:
        lifted = ref_crt.pair_crt_expand(ctx, c[0], c[1], nl2)
    else:
        lifted = ref_crt.single_crt_expand(ctx, c[0], nl2)
    if K != 1:
        lifted = ref_bs._reheat(ctx, lifted, nl2, K)
    return np.asarray(ref.ev.ntt(lifted, list(range(nl2))))


@pytest.mark.parametrize("scale_bits", [25, 40, 60, 70])
def test_plan_equals_jax(pair, scale_bits):
    """The cooling plan of the host path (the reference's)."""
    ref, port = pair
    want, got = ref_bs.EmulatedBootstrapper(ref), bs.EmulatedBootstrapper(port)
    for nl in range(2, port.ctx.config.num_q + 1):
        for target in (0, 3, 7):
            assert got._plan(nl, 2.0 ** scale_bits, target) == \
                want._plan(nl, 2.0 ** scale_bits, target), (nl, target)
    assert got._plan(6, HOT, 5)[0] == 1 and got._plan(16, 2.0 ** 80, 3)[0] == 2


def _exact_m2(port, data_t, nl, target):
    """m2 by Python integers: the message decrypted at all nl rows, its
    centered CRT value mod Q_nl, taken mod each target row, NTT."""
    ctx, ev = port.ctx, port.ev
    rows = list(range(nl))
    q = ev._q(rows)
    m = U(ev.intt(add_mod(data_t[0, :nl], mul_mod(data_t[1, :nl], port.keys.s_ntt[:nl],
                                                  q), q), rows)).astype(object)
    qs = [int(p) for p in ctx.q_primes[:nl]]
    Q = int(np.prod(qs, dtype=object))
    v = sum(m[i] * (Q // qs[i]) * pow(Q // qs[i], -1, qs[i]) for i in range(nl)) % Q
    v = np.where(v > (Q - 1) // 2, v - Q, v)
    nl2 = (target + 1) * ctx.config.rescale_rows
    lifted = np.stack([(v % int(p)).astype(np.int64) for p in ctx.q_primes[:nl2]])
    return U(ev.ntt(torch.from_numpy(lifted.astype(np.int32)), list(range(nl2))))


def _m2_of(ob, monkeypatch, data_t, nl, scale, target):
    """The m2 one bootstrap of `ob` encrypts."""
    seen = []
    encrypt = ob._encrypt
    monkeypatch.setattr(ob, "_encrypt", lambda m2, *a: seen.append(m2) or encrypt(m2, *a))
    ob.bootstrap(data_t, nl, scale, target)
    assert len(seen) == 1
    return U(seen[0])


@pytest.mark.parametrize("nl, scale, target", CASES)
def test_host_path_m2_bit_equal_to_jax(pair, monkeypatch, nl, scale, target):
    """The host path's m2 equals the JAX host path's, cooling and reheat
    included."""
    ref, port = pair
    _, data, data_t = _input(ref, nl, scale)
    got = _m2_of(bs.EmulatedBootstrapper(port, host_rng=True), monkeypatch, data_t, nl,
                 scale, target)
    np.testing.assert_array_equal(got, _ref_m2(ref, jnp.asarray(data), nl, scale, target))


@pytest.mark.parametrize("nl, scale, target", CASES)
def test_device_path_m2_is_the_exact_lift(pair, monkeypatch, nl, scale, target):
    """The device path's m2 is the exact lift of the decrypted message; where
    the JAX oracle lifts from the pair without cooling, that is its m2 bit
    for bit, and where it cools, its m2 differs by the cooling's loss."""
    ref, port = pair
    _, data, data_t = _input(ref, nl, scale)
    ob = bs.EmulatedBootstrapper(port)
    assert ob._base_rows(nl, scale) == BASE_ROWS[nl]
    got = _m2_of(ob, monkeypatch, data_t, nl, scale, target)
    np.testing.assert_array_equal(got, _exact_m2(port, data_t, nl, target))
    cooled = _ref_m2(ref, jnp.asarray(data), nl, scale, target)
    if ob._plan(nl, scale, target)[0] == 0:
        np.testing.assert_array_equal(got, cooled)
    else:
        assert not np.array_equal(got, cooled)


def test_device_path_loses_no_bits_to_cooling(pair):
    """On a hot input the host path's (the reference's) cooling rounds the
    message at 2^30; the device path's decrypted output is exact up to the
    fresh encryption's noise."""
    ref, port = pair
    vals, _, data_t = _input(ref, 6, HOT)
    err = {}
    for host_rng in (False, True):
        out, (_, sc) = bs.EmulatedBootstrapper(port, host_rng=host_rng).bootstrap(
            data_t, 6, HOT, 5)
        err[host_rng] = float(np.sqrt(np.mean((port.decrypt(Ciphertext(out, sc)) - vals) ** 2)))
    want = float(np.sqrt(np.mean((port.decrypt(Ciphertext(data_t, HOT)) - vals) ** 2)))
    assert abs(err[False] - want) < 1e-12 and err[True] > 1e3 * err[False]


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_crt_expand_is_the_centered_lift(pair, k):
    """crt_expand of the bottom k primes against Python integers, at values
    around 0 and +-Q/2, where the centering decides."""
    _, port = pair
    ctx = port.ctx
    qs = [int(q) for q in ctx.q_primes]
    Q = int(np.prod(qs[:k], dtype=object))
    rng = np.random.default_rng(k)
    v = [int(x) for x in rng.integers(-(1 << 62), 1 << 62, 200)] + [
        (Q - 1) // 2 - 2 + i for i in range(5)] + [-(Q - 1) // 2 - 2 + i for i in range(5)]
    v = [x % Q - Q if x % Q > (Q - 1) // 2 else x % Q for x in v]
    res = [torch.tensor([x % qs[i] for x in v], dtype=torch.int32) for i in range(k)]
    got = (crt.crt_expand(ctx, res, 10) if k > 1
           else crt.single_crt_expand(ctx, res[0], 10)).numpy()
    want = np.array([[x % qs[j] for x in v] for j in range(10)], dtype=np.int64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nl, scale, target", CASES)
def test_device_path_decrypts_and_keeps_the_scale(pair, nl, scale, target):
    ref, port = pair
    vals, _, data_t = _input(ref, nl, scale)
    ob = bs.Bootstrapper(port)
    assert isinstance(ob, bs.EmulatedBootstrapper) and not ob.host_rng
    out, (nl2, sc2) = ob.bootstrap(data_t, nl, scale, target)
    assert sc2 == scale
    assert nl2 == (target + 1) * port.ctx.config.rescale_rows
    assert out.shape == (2, nl2, port.ctx.n) and out.dtype == torch.int32
    got = port.decrypt(Ciphertext(out, sc2))
    assert float(np.sqrt(np.mean((got - vals) ** 2))) < 5e-4


def test_noise_draws(pair):
    """v in {-1, 0, 1}; e0, e1 integers whose sample standard deviation is
    within 10 % of 3.2, over N = 2^11."""
    _, port = pair
    ob = bs.EmulatedBootstrapper(port)
    d = ob.draw()
    assert d.shape == (3, port.ctx.n) and d.dtype == torch.int64
    assert set(d[0].tolist()) == {-1, 0, 1}
    for e in d[1:].double():
        assert abs(float(e.std()) - 3.2) < 0.32
        assert float(e.abs().max()) < 3.2 * 8


def test_generator_seeded_as_the_reference(pair):
    ref, port = pair
    ob = bs.EmulatedBootstrapper(port)
    assert ob.gen.initial_seed() == int(ref_bs.EmulatedBootstrapper(ref)._seed)
    assert ob.gen.device == port.device


def test_randomness_fresh_and_reproducible(pair):
    """Two calls draw different randomness; a restored generator state
    reproduces a call bit for bit."""
    ref, port = pair
    _, _, data_t = _input(ref, 6, HOT)
    ob = bs.EmulatedBootstrapper(port)
    state = ob.gen.get_state()
    a, _ = ob.bootstrap(data_t, 6, HOT, 5)
    b, _ = ob.bootstrap(data_t, 6, HOT, 5)
    assert not torch.equal(a[1], b[1])
    ob.gen.set_state(state)
    again, _ = ob.bootstrap(data_t, 6, HOT, 5)
    assert torch.equal(again, a)
    assert ob.calls == 3 and ob.replays == 0 and not ob._graphs


def test_one_row_takes_the_host_path():
    """nl < 2 keeps the host-RNG path, as in the reference, whose default
    (device) setting takes it there too: bit-equal on keys and RNG in step."""
    ref, port = RefScheme(PROFILE), Scheme(PROFILE, device="cpu")
    ref.generate_keys()
    port.generate_keys()
    vals = np.random.default_rng(3).uniform(-0.5, 0.5, port.ctx.config.n_slots)
    cr, cp = ref.encrypt(vals, nl=1), port.encrypt(vals, nl=1)
    np.testing.assert_array_equal(U(cp.data), np.asarray(cr.data))
    got, meta = bs.Bootstrapper(port).bootstrap(cp.data, 1, cp.scale, 3)
    want, want_meta = ref_bs.Bootstrapper(ref).bootstrap(cr.data, 1, cr.scale, 3)
    assert meta == tuple(want_meta)
    np.testing.assert_array_equal(U(got), np.asarray(want))


def test_capture_oracle_is_card_only(pair):
    """No graphs exist on the CPU: capture_oracle captures nothing there and
    the device path runs eagerly."""
    from dacapo_tpu_torch.vm.executor import HEVMExecutor
    from dacapo_tpu_torch.vm.hevm import HEVMProgram, HEVMOp, OP_BOOTSTRAP
    _, port = pair
    prog = HEVMProgram(init_level=2)
    prog.arg_scale, prog.arg_level = [60], [2]
    prog.res_scale, prog.res_level, prog.res_dst = [60], [3], [1]
    prog.num_ctxt, prog.num_ptxt = 2, 0
    prog.ops = [HEVMOp(OP_BOOTSTRAP, 1, 0, 3)]
    ex = HEVMExecutor(port, prog, [])
    assert isinstance(ex.bootstrapper, bs.EmulatedBootstrapper)
    assert ex._boot_signatures() == [(6, HOT, 3)]
    assert ex.capture_oracle() == 0 and not ex.bootstrapper._graphs
    assert HEVMExecutor(port, prog, [], host_rng=True).bootstrapper.host_rng
