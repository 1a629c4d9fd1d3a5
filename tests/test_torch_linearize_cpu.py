"""The linearization (K1, ``csrc/linearize.cu``) run on the CPU.

The CUDA source compiles with g++ against the stand-ins of
``tests/cuda_on_cpu``: one thread per CUDA thread, and the warp's votes and
shuffles at a barrier over the warp (a shuffle whose mask leaves out its
own or its source lane reads NaN). The wrapper, pointed at that library,
is held against its plain version on the VSA and SEA arms at B=1, 15 and
33 (each launch ends in a partial block; T=6, so a block holds the
terminal knot of some scenarios beside the running knots of others), the
terminal knot included. Scenario 7 sits at a goal rotation of pi at
every knot, where ``log3`` takes its branch near pi and its sanitized
tangents. The 3-DoF SEA arm's instance runs the same cases (T=6; B=1, 15
and 33, a NaN scenario) and the 7-DoF arm's one (its wide layout) at T=4,
B=1, 9 and 33 and with a NaN scenario, with scenario 7 at one posture and
the goal target turned so that its residual is a rotation by pi. A target a knot, every row different, goes through the
[T, 12] table on both arms at B=1, 15 and 200.

The kernel performs its plain version's operations in the same order, so
the two agree to the bit, NaNs included, in f64 and f32: the kernel builds
with -ffp-contract=off (and -fno-builtin: sin and cos of one angle stay
two calls), and the plain version runs here with the C library's sin, cos
and atan2 and a correctly rounded square root in place of PyTorch's CPU
kernels, whose vectorized loops round some results differently in the last
bit.
"""
import torch_cpu  # noqa: F401  (one torch thread a test process)
import math

import numpy as np
import pytest
import torch

from aslr_to_tpu_torch import seven_dof_sea, three_dof_sea, two_dof_sea, two_dof_vsa_boxddp
from aslr_to_tpu_torch.ops.rigid_body import frame_placement
from aslr_to_tpu_torch.kernels import build, vsa_kernels
from cuda_on_cpu.gxx import gxx_library, ieee_sqrt, libm
from cuda_on_cpu.tables import per_knot_target

T = 6
PI_SCENARIO = 7


@pytest.fixture(scope="module")
def lin_lib(tmp_path_factory):
    """linearize.cu built for the CPU; the wrapper launches it on CPU
    tensors, and the plain version takes the C library's transcendentals,
    while the fixture lasts."""
    handle = gxx_library(tmp_path_factory.mktemp("linearize_kernel"),
                         ["linearize.cu", "linearize_n3.cu", "linearize_n7.cu"], "lin_smem",
                         ["aslr_linearize"])
    mp = pytest.MonkeyPatch()
    mp.setattr(build, "_lib", handle)
    mp.setattr(vsa_kernels, "_route", lambda t: "kernel")
    mp.setattr(build, "stream_of", lambda t: None)
    mp.setattr(torch, "sqrt", ieee_sqrt)
    mp.setattr(torch, "sin", libm("sin", 1))
    mp.setattr(torch, "cos", libm("cos", 1))
    mp.setattr(torch, "atan2", libm("atan2", 2))
    yield handle
    mp.undo()


def _args(arm, B, dtype, seed=0):
    """(spec, xs, us, wterm): random states and controls (the VSA's
    stiffnesses positive), a terminal weight that differs by lane, and
    scenario 7 (where B allows) at q_l = (pi, 0) at every knot."""
    rng = np.random.default_rng(seed)
    if arm == "sea":
        spec = vsa_kernels.extract_vsa_spec(two_dof_sea(T=T, dtype=dtype, device="cpu").problem,
                                            None)
        us = 3.0 * rng.standard_normal((T, 2, B))
    else:
        w = two_dof_vsa_boxddp(T=T, dtype=dtype, device="cpu")
        spec = vsa_kernels.extract_vsa_spec(w.problem, w.bounds)
        us = np.concatenate([3.0 * rng.standard_normal((T, 2, B)),
                             2.0 * np.abs(rng.standard_normal((T, 2, B)))], axis=1)
    xs = 0.3 * rng.standard_normal((T + 1, 8, B))
    if B > PI_SCENARIO:
        xs[:, 0, PI_SCENARIO], xs[:, 1, PI_SCENARIO] = math.pi, 0.0
    wterm = spec.w_goal_term * (1.0 + np.arange(B) % 3)

    def t(a):
        return torch.tensor(a, dtype=dtype)

    return spec, t(xs), t(us), t(wterm)


def _flat(lin):
    return ([lin.cost, lin.xnext, lin.ok] + [lin.run[k] for k in sorted(lin.run)]
            + [lin.term[k] for k in sorted(lin.term)])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("batch", [1, 15, 33])
@pytest.mark.parametrize("arm", ["vsa", "sea"])
def test_linearize_on_cpu_matches_plain_version(lin_lib, arm, batch, dtype):
    args = _args(arm, batch, dtype)
    before = build.LAUNCHES["linearize"]
    got = vsa_kernels.linearize(*args)
    assert build.LAUNCHES["linearize"] == before + 1
    want = vsa_kernels.linearize_plain(*args)
    names = ["cost", "xnext", "ok"] + [f"run.{k}" for k in sorted(want.run)] + \
        [f"term.{k}" for k in sorted(want.term)]
    for name, g, w in zip(names, _flat(got), _flat(want)):
        assert torch.equal(g.isnan(), w.isnan()), name
        assert torch.equal(g.nan_to_num(0.0), w.nan_to_num(0.0)), name
    assert bool(got.ok.all())
    if batch > PI_SCENARIO:     # the goal Jacobian at pi is finite and not zero
        J = got.term["Lxx"][:2, :2, PI_SCENARIO]
        assert bool(torch.isfinite(J).all()) and bool((J != 0).any())


def test_linearize_on_cpu_keeps_a_scenario_in_its_group(lin_lib):
    """Scenario 9's states at knot 0 NaN: its flag falls alone; the
    scenarios beside it in its warp (knot 0 of scenarios 8 and 10-15) keep
    theirs and equal the plain version."""
    spec, xs, us, wterm = _args("vsa", 33, torch.float64)
    xs = xs.clone()
    xs[0, :, 9] = float("nan")
    got = vsa_kernels.linearize(spec, xs, us, wterm)
    want = vsa_kernels.linearize_plain(spec, xs, us, wterm)
    for g, w in zip(_flat(got), _flat(want)):
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(g.nan_to_num(0.0), w.nan_to_num(0.0))
    assert not bool(got.ok[9]) and bool(got.ok[[8, 10, 11, 12, 13, 14, 15]].all())


def _ndof_args(nl, B, dtype, T_=T, seed=0):
    """(spec, xs, us, wterm) on the 3- or 7-DoF SEA arm: random states and
    motor torques, a terminal weight that differs by lane, and scenario 7
    (where B allows) at one posture at every knot, with the goal target
    turned so that its residual rotation there is pi."""
    rng = np.random.default_rng(seed)
    w = (three_dof_sea if nl == 3 else seven_dof_sea)(T=T_, dtype=dtype, device="cpu")
    spec = vsa_kernels.extract_vsa_spec(w.problem, None)
    xs = 0.3 * rng.standard_normal((T_ + 1, 4 * nl, B))
    us = 3.0 * rng.standard_normal((T_, nl, B))
    if B > PI_SCENARIO:
        q = xs[0, :nl, PI_SCENARIO]
        xs[:, :nl, PI_SCENARIO] = q
        model = w.problem.state.robot
        R = frame_placement(model, torch.tensor(q, dtype=dtype), spec.frame_id).rot.double().numpy()
        a = np.array([0.3, -0.2, 1.0]) / np.linalg.norm([0.3, -0.2, 1.0])
        spec = spec._replace(target_rot_inv=(2.0 * np.outer(a, a) - np.eye(3)) @ R.T)
    wterm = spec.w_goal_term * (1.0 + np.arange(B) % 3)

    def t(v):
        return torch.tensor(v, dtype=dtype)

    return spec, t(xs), t(us), t(wterm)


def _assert_equal_to_plain(got, want):
    for g, w in zip(_flat(got), _flat(want)):
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(g.nan_to_num(0.0), w.nan_to_num(0.0))


@pytest.mark.parametrize("nl,batch,dtype", [
    (3, 1, torch.float64), (3, 15, torch.float64), (3, 33, torch.float64),
    (3, 33, torch.float32), (7, 1, torch.float32), (7, 9, torch.float64),
    (7, 33, torch.float32), (7, 33, torch.float64)], ids=lambda v: str(v).replace("torch.", ""))
def test_ndof_linearize_on_cpu_matches_plain_version(lin_lib, nl, batch, dtype):
    """K1's 3- and 7-DoF SEA instances (T=6 at nl 3, T=4 at nl 7: the wide
    layout, whose groups solve each column of the acceleration Jacobian
    once and read the joints' rotations from their tile), the terminal knot
    and the goal's pi branch included; B=1, 9 and 33 end in partial blocks."""
    args = _ndof_args(nl, batch, dtype, T_=6 if nl == 3 else 4)
    before = build.LAUNCHES["linearize"]
    got = vsa_kernels.linearize(*args)
    assert build.LAUNCHES["linearize"] == before + 1
    _assert_equal_to_plain(got, vsa_kernels.linearize_plain(*args))
    assert bool(got.ok.all())
    if batch > PI_SCENARIO:     # the goal Jacobian at pi is finite and not zero
        J = got.term["Lxx"][:nl, :nl, PI_SCENARIO]
        assert bool(torch.isfinite(J).all()) and bool((J != 0).any())


@pytest.mark.parametrize("nl", [3, 7])
def test_ndof_linearize_on_cpu_keeps_a_scenario_in_its_group(lin_lib, nl):
    """The 3- and 7-DoF arms with scenario 9's states at knot 0 NaN (at nl 7
    its rotations, its tile's columns and the 0 * NaN of its seeds' zero
    tangents): its flag falls alone, and every output equals the plain
    version's."""
    spec, xs, us, wterm = _ndof_args(nl, 33, torch.float64, T_=6 if nl == 3 else 4)
    xs = xs.clone()
    xs[0, :, 9] = float("nan")
    got = vsa_kernels.linearize(spec, xs, us, wterm)
    _assert_equal_to_plain(got, vsa_kernels.linearize_plain(spec, xs, us, wterm))
    assert not bool(got.ok[9]) and bool(got.ok[[8, 10, 11, 12, 13, 14, 15]].all())


def test_linearize_refuses_an_arm_it_has_no_instance_for(lin_lib):
    """The VSA arm at nl = 3 has no instance: the wrapper raises before any
    launch and names the instances there are."""
    spec, xs, us, wterm = _ndof_args(3, 4, torch.float64)
    spec = spec._replace(variant="vsa", nu=6)
    us = torch.zeros((T, 6, 4), dtype=torch.float64)
    before = build.LAUNCHES["linearize"]
    with pytest.raises(NotImplementedError, match="nl=3 vsa; its instances: nl=2 vsa, nl=2 sea"):
        vsa_kernels.linearize(spec, xs, us, wterm)
    assert build.LAUNCHES["linearize"] == before


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("batch", [1, 15, 200])
@pytest.mark.parametrize("arm", ["vsa", "sea"])
def test_linearize_on_cpu_reads_the_target_table(lin_lib, arm, batch, dtype):
    """A target a knot (the rows all differ): each running knot reads its
    own row of the [T, 12] table, the terminal knot the parameter block's
    target; equal to the plain version to the bit. A shared target sent
    through the table's branch gives the shared route's bits."""
    spec, xs, us, wterm = _args(arm, batch, dtype)
    pk, tgt = per_knot_target(spec, T, dtype)
    got = vsa_kernels.linearize(pk, xs, us, wterm, tgt)
    _assert_equal_to_plain(got, vsa_kernels.linearize_plain(pk, xs, us, wterm, tgt))
    assert bool(got.ok.all())
    shared = vsa_kernels.linearize(spec, xs, us, wterm)
    _assert_equal_to_plain(vsa_kernels.linearize(spec, xs, us, wterm,
                                                 torch.tensor(spec.target_table(T, dtype))),
                           shared)
    assert not torch.equal(got.run["Lx"], shared.run["Lx"])
    assert torch.equal(got.term["Lx"], shared.term["Lx"])


@pytest.mark.parametrize("nl,batch,dtype", [
    (3, 15, torch.float64), (3, 33, torch.float32), (7, 9, torch.float64),
    (7, 15, torch.float32)], ids=lambda v: str(v).replace("torch.", ""))
def test_ndof_linearize_on_cpu_reads_the_target_table(lin_lib, nl, batch, dtype):
    """K1's 3- and 7-DoF instances with a target a knot (T=6 at nl 3, T=4 at
    nl 7): equal to the plain version to the bit."""
    T_ = 6 if nl == 3 else 4
    spec, xs, us, wterm = _ndof_args(nl, batch, dtype, T_=T_)
    pk, tgt = per_knot_target(spec, T_, dtype)
    _assert_equal_to_plain(vsa_kernels.linearize(pk, xs, us, wterm, tgt),
                           vsa_kernels.linearize_plain(pk, xs, us, wterm, tgt))
