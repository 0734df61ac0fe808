"""The port's planner passes (passes/{smu,scale,hoist,estimator,elasm}.py,
copies of the JAX package's) against the JAX package's, on the programs of
tests/test_passes.py: each case traces the same function with both tracers,
runs the same pass on both sides and compares the results: the managed IR
(Function.dump, which carries types and attributes but no source
locations), the SMU partitions, the estimates and the checks' verdicts."""

import pytest

from dacapo_tpu.ir import trace as ref_trace, earth as ref_earth
from dacapo_tpu.ir.config import load_profile as ref_load_profile
from dacapo_tpu.passes import (rewrite as ref_rewrite, smu as ref_smu, scale as ref_scale,
                               hoist as ref_hoist, estimator as ref_est, elasm as ref_elasm,
                               pipeline as ref_pipeline)
from dacapo_tpu_torch.ir import trace as port_trace, earth as port_earth
from dacapo_tpu_torch.ir.config import load_profile
from dacapo_tpu_torch.passes import (rewrite, smu, scale, hoist, estimator, elasm,
                                     pipeline)

REF = dict(hc=ref_trace, earth=ref_earth, rewrite=ref_rewrite, smu=ref_smu,
           scale=ref_scale, hoist=ref_hoist, est=ref_est, elasm=ref_elasm,
           pipeline=ref_pipeline)
PORT = dict(hc=port_trace, earth=port_earth, rewrite=rewrite, smu=smu, scale=scale,
            hoist=hoist, est=estimator, elasm=elasm, pipeline=pipeline)
SIDES = (REF, PORT)


@pytest.fixture(autouse=True)
def _cfg():
    ref_load_profile("profiled_TPU_test_n10")
    load_profile("profiled_TPU_test_n10")


def _trace(m, body, clean=True):
    """body(x) traced by one side's tracer (m: REF or PORT), with the
    cleanup of tests/test_passes.py:_trace."""
    m["hc"]._module.reset()
    fn = m["hc"].func("c")(body).eval()
    if clean:
        rw = m["rewrite"]
        rw.cse(fn)
        rw.canonicalize(fn)
        rw.elide_constants(fn)
        rw.privatize_constants(fn)
        rw.canonicalize(fn)
    return fn


def _both(body, clean=True):
    return [_trace(m, body, clean) for m in SIDES]


def _smu_ids(m, fn):
    unit = m["smu"].ScaleManagementUnit(fn)
    values = list(fn.args) + [op.result for op in fn.ops]
    return unit, [unit.get_id(v) for v in values]


def test_smu_groups_and_noisy():
    def body(x):
        a = x * x
        b = a.rotate(3)
        return b + a

    got = []
    for m, fn in zip(SIDES, _both(body)):
        unit, ids = _smu_ids(m, fn)
        rot = [op.result for op in fn.ops if op.opcode == "rotate"][0]
        got.append((unit.id_num, ids, unit.in_noisy_group(rot), unit.verify()))
    assert got[0] == got[1] and got[1][2] and got[1][3] and got[1][0] >= 2


def test_smu_add_chain_merges():
    def body(x):
        return x.rotate(1) + x.rotate(2) + x.rotate(3)

    got = [_smu_ids(m, fn)[1] for m, fn in zip(SIDES, _both(body))]
    assert got[0] == got[1]
    port_fn = _trace(PORT, body)
    unit, _ = _smu_ids(PORT, port_fn)
    assert len({unit.get_id(op.result) for op in port_fn.ops if op.opcode == "add"}) == 1


def test_pars_then_smu_checker():
    def body(x):
        a = x * x
        return a.rotate(1) * a

    got = []
    for m, fn in zip(SIDES, _both(body)):
        unit = m["smu"].ScaleManagementUnit(fn)
        unit.attach()
        m["scale"].proactive_rescaling(fn, 25)
        fn.verify()
        got.append((fn.dump(), unit.verify()))
    assert got[0] == got[1] and got[1][1]


def test_early_modswitch_hoists():
    def body(x):
        return (x * x) * x

    got = []
    for m, fn in zip(SIDES, _both(body)):
        m["scale"].proactive_rescaling(fn, 25)
        m["hoist"].early_modswitch(fn)
        m["rewrite"].canonicalize(fn)
        fn.verify()
        got.append(fn.dump())
    assert got[0] == got[1] and "'init_level': 7" in got[1]


def test_upscale_bubbling_types_stay_valid():
    def body(x):
        a = x * x
        return a + a.rotate(1)

    got = []
    for m, fn in zip(SIDES, _both(body)):
        m["scale"].snr_rescaling(fn, 20)
        m["hoist"].upscale_bubbling(fn)
        m["rewrite"].canonicalize(fn)
        fn.verify()
        got.append(fn.dump())
    assert got[0] == got[1]


def test_estimators():
    def body(x):
        y = x * x
        return y.rotate(5) + y

    got = []
    for m, fn in zip(SIDES, _both(body)):
        m["scale"].proactive_rescaling(fn, 25)
        got.append((m["est"].latency_estimator(fn), m["est"].error_estimator(fn),
                    [m["est"].naf_count(k, 512) for k in range(1, 40)]))
    assert got[0] == got[1]
    assert got[1][0] > 0 and got[1][1] > 0 and got[1][2][4] == got[1][2][6] == 2


def test_elasm_small():
    def body(x):
        y = x * x
        z = y.rotate(1) + y
        return z * x

    got = []
    for m, fn in zip(SIDES, _both(body)):
        m["elasm"].elasm_explorer(fn, 20, parallel=2, num_iter=3, seed=0)
        m["hoist"].early_modswitch(fn)
        m["rewrite"].cse(fn)
        m["rewrite"].canonicalize(fn)
        fn.verify()
        got.append(fn.dump())
    assert got[0] == got[1]


def _bootstrap_fn(m, users):
    """arg -> bootstrap(target 1) -> users (modswitch by the given down
    factors, or "negate"), as in tests/test_passes.py."""
    E = m["earth"]
    arg = E.Value(E.ScaleType(True, 25, 6), arg_index=0)
    bs = E.Op("bootstrap", [arg], {"targetLevel": 1}, E.ScaleType(True, 25, 1))
    ops, rets = [bs], []
    for u in users:
        if u == "negate":
            op = E.Op("negate", [bs.result], {}, E.ScaleType(True, 25, 1))
        else:
            op = E.Op("modswitch", [bs.result], {"downFactor": u},
                      E.ScaleType(True, 25, 1 + u))
        ops.append(op)
        rets.append(op.result)
    if len(rets) == 2 and "negate" not in users:
        add = E.Op("add", rets, {}, None)
        ops.append(add)
        rets = [add.result]
    return E.Function("f", [arg], ops, rets)


@pytest.mark.parametrize("users, target", [((3, 2), 3), ((3, "negate"), 1)])
def test_flexible_bootstrap(users, target):
    """FlexibleBootstrap absorbs modswitch users into the bootstrap target,
    and leaves a bootstrap with a non-modswitch user alone."""
    got = []
    for m in SIDES:
        fn = _bootstrap_fn(m, users)
        m["hoist"].flexible_bootstrap(fn)
        got.append((fn.ops[0].attrs["targetLevel"], fn.ops[0].ty.level,
                    [op.attrs.get("downFactor") for op in fn.ops[1:]]))
    assert got[0] == got[1] and got[1][0] == target


def test_check_smu_pipeline_flag():
    def body(x):
        y = x * x
        return y.rotate(2) + y

    got = []
    for m, fn in zip(SIDES, _both(body)):
        m["pipeline"].run_scale_pipeline(fn, "pars", 25, check_smu=True)
        fn.verify()
        got.append(fn.dump())
    assert got[0] == got[1]


def test_smu_strict_verify_rejects_forged_partition():
    def body(x):
        return (x + x) * (x + x)

    got = []
    for m, fn in zip(SIDES, _both(body, clean=False)):
        unit = m["smu"].ScaleManagementUnit(fn)
        ok = (unit.verify(), unit.verify_definitions())
        values = list(fn.args) + [op.result for op in fn.ops]
        adds = [op.result for op in fn.ops if op.opcode == "add"]
        same = unit.get_id(adds[0]) == unit.get_id(adds[1])
        forged = {v: unit.get_id(v) for v in values}
        forged[adds[1]] = unit.id_num
        for v, i in forged.items():
            m["scale"].set_value_attr(fn, v, "smu", i)
        fn.attrs["smu_attached"] = True
        forged_unit = m["smu"].ScaleManagementUnit(fn)
        got.append((ok, same, forged_unit.verify(), forged_unit.verify_definitions()))
    assert got[0] == got[1] == ((True, True), True, True, False)

